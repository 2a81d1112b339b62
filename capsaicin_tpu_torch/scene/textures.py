"""The 256x256x2 blue-noise table of the GI sampler (sampling.h:14-24),
read from the table the repository ships (assets/textures/bluenoise256.npy,
generated by capsaicin_tpu/scene/textures.py)."""

from __future__ import annotations

import os

import numpy as np

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")


def blue_noise_256() -> np.ndarray:
    """[256,256,2] float32 blue-noise values in [0,1)."""
    return np.load(os.path.join(ASSET_DIR, "textures", "bluenoise256.npy")).astype(np.float32)
