"""Mesh and material records: the parts of capsaicin_tpu/scene/obj_loader.py
that the procedural scenes use (asset_load_system.cpp of the reference).
OBJ/MTL file ingest is not ported yet (ROADMAP A8)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Material:
    name: str
    kd: Tuple[float, float, float] = (0.75, 0.75, 0.75)
    ke: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffuse_texname: str = ""


@dataclass
class MeshData:
    """Per-mesh compacted geometry; mirrors MeshData/MeshComponent
    (asset_load_system.cpp:24-39, asset_load_system.h:29-39)."""

    name: str = ""
    positions: List[float] = field(default_factory=list)  # flat xyz
    normals: List[float] = field(default_factory=list)  # flat xyz
    texcoords: List[float] = field(default_factory=list)  # flat uv
    indices: List[int] = field(default_factory=list)
    texture_name: str = ""
    material: Optional[Material] = None


def mesh_arrays(mesh: MeshData):
    """MeshData -> numpy arrays (positions [V,3], normals [V,3], uvs [V,2], indices [I])."""
    pos = np.asarray(mesh.positions, np.float32).reshape(-1, 3)
    nrm = np.asarray(mesh.normals, np.float32).reshape(-1, 3)
    uv = np.asarray(mesh.texcoords, np.float32).reshape(-1, 2)
    idx = np.asarray(mesh.indices, np.int32)
    return pos, nrm, uv, idx
