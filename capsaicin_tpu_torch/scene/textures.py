"""Textures: PNG loading for the OBJ ingest (the reference's TextureSystem,
texture_system.cpp: an image decode, and a 1x1 fallback for a missing
file) and the 256x256x2 blue-noise table of the GI sampler
(sampling.h:14-24), read from the table the repository ships
(assets/textures/bluenoise256.npy, generated by
capsaicin_tpu/scene/textures.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")


def asset_dir() -> str:
    return ASSET_DIR


def load_texture(name: str, texture_dir: Optional[str] = None) -> Optional[np.ndarray]:
    """An image as float32 RGBA [H,W,4] in [0,1], found in `texture_dir`,
    then assets/textures, assets and the working directory; None if it is
    missing or cannot be read, for which Scene building substitutes the
    1x1 zero texture (texture_system.cpp:47-56)."""
    search = [texture_dir] if texture_dir else []
    search += [os.path.join(ASSET_DIR, "textures"), ASSET_DIR, "."]
    for d in search:
        path = os.path.join(d, name)
        if os.path.exists(path):
            try:
                from PIL import Image

                with Image.open(path) as img:
                    return np.asarray(img.convert("RGBA"), np.float32) / 255.0
            except Exception:
                return None
    return None


def blue_noise_256() -> np.ndarray:
    """[256,256,2] float32 blue-noise values in [0,1)."""
    return np.load(os.path.join(ASSET_DIR, "textures", "bluenoise256.npy")).astype(np.float32)
