"""The procedural Cornell box and its camera: the parts of
capsaicin_tpu/scene/procedural.py that the renderer's main path uses,
built with numpy and torch only."""

from __future__ import annotations

import math
from typing import List

import numpy as np

from .obj_loader import Material, MeshData


def _quad(mesh: MeshData, v0, v1, v2, v3, normal, uvs=None):
    """Append a quad (two fan triangles, tinyobjloader order) with a shared normal."""
    base = len(mesh.positions) // 3
    uvs = uvs or [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    for v, uv in zip((v0, v1, v2, v3), uvs):
        mesh.positions.extend(v)
        mesh.normals.extend(normal)
        mesh.texcoords.extend(uv)
    mesh.indices.extend([base, base + 1, base + 2, base, base + 2, base + 3])


def _rot_y(p, deg, cx=0.0, cz=0.0):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    x, y, z = p
    x -= cx
    z -= cz
    return (c * x + s * z + cx, y, -s * x + c * z + cz)


def _box(name: str, mat: Material, center, size, rot_deg=0.0) -> MeshData:
    """Axis-aligned box rotated about Y; 12 triangles, outward normals."""
    mesh = MeshData(name=name)
    mesh.material = mat
    mesh.texture_name = mat.diffuse_texname
    cx, cy, cz = center
    hx, hy, hz = size[0] / 2, size[1] / 2, size[2] / 2
    faces = [
        ([(-hx, -hy, -hz), (-hx, hy, -hz), (hx, hy, -hz), (hx, -hy, -hz)], (0, 0, -1)),
        ([(hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz), (-hx, -hy, hz)], (0, 0, 1)),
        ([(-hx, -hy, hz), (-hx, hy, hz), (-hx, hy, -hz), (-hx, -hy, -hz)], (-1, 0, 0)),
        ([(hx, -hy, -hz), (hx, hy, -hz), (hx, hy, hz), (hx, -hy, hz)], (1, 0, 0)),
        ([(-hx, hy, -hz), (-hx, hy, hz), (hx, hy, hz), (hx, hy, -hz)], (0, 1, 0)),
        ([(-hx, -hy, hz), (-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz)], (0, -1, 0)),
    ]
    for corners, n in faces:
        pts = [_rot_y((cx + dx, cy + dy, cz + dz), rot_deg, cx, cz) for (dx, dy, dz) in corners]
        _quad(mesh, *pts, normal=_rot_y(n, rot_deg))
    return mesh


WHITE = (0.58, 0.568, 0.544)
RED = (0.504, 0.052, 0.04)
GREEN = (0.156, 0.426, 0.107)


def cornell_box() -> List[MeshData]:
    """The 2-unit Cornell box with a skylight opening in the ceiling (the
    renderer's only light is a directional one): 40 triangles."""
    m_white = Material("white", kd=WHITE)
    m_red = Material("leftWall", kd=RED)
    m_green = Material("rightWall", kd=GREEN)
    m_floor = Material("floor", kd=WHITE)
    m_back = Material("backWall", kd=WHITE)

    def wall(name, mat, v0, v1, v2, v3, n):
        mesh = MeshData(name=name)
        mesh.material = mat
        mesh.texture_name = mat.diffuse_texname
        _quad(mesh, v0, v1, v2, v3, normal=n)
        return mesh

    hx0, hx1 = -0.24, 0.23
    hz0, hz1 = -0.22, 0.16
    y = 2.0
    ceiling = MeshData(name="ceiling")
    ceiling.material = m_white
    n_dn = (0, -1, 0)
    _quad(ceiling, (-1, y, -1), (-1, y, hz0), (1, y, hz0), (1, y, -1), n_dn)
    _quad(ceiling, (-1, y, hz1), (-1, y, 1), (1, y, 1), (1, y, hz1), n_dn)
    _quad(ceiling, (-1, y, hz0), (-1, y, hz1), (hx0, y, hz1), (hx0, y, hz0), n_dn)
    _quad(ceiling, (hx1, y, hz0), (hx1, y, hz1), (1, y, hz1), (1, y, hz0), n_dn)

    return [
        _box("shortBox", m_white, (0.33, 0.3, 0.37), (0.6, 0.6, 0.6), rot_deg=-17.0),
        _box("tallBox", m_white, (-0.34, 0.6, -0.29), (0.6, 1.2, 0.6), rot_deg=17.0),
        wall("leftWall", m_red, (-1, 0, 1), (-1, 2, 1), (-1, 2, -1), (-1, 0, -1), (1, 0, 0)),
        wall("backWall", m_back, (-1, 0, 1), (1, 0, 1), (1, 2, 1), (-1, 2, 1), (0, 0, -1)),
        wall("rightWall", m_green, (1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1), (-1, 0, 0)),
        ceiling,
        wall("floor", m_floor, (-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), (0, 1, 0)),
    ]


def camera_preset(name: str = "cornell"):
    """Camera pose for a procedural scene, as float32 numpy arrays."""
    if name == "cornell":
        return dict(
            position=np.array([0.0, 1.0, -3.6], np.float32),
            right=np.array([1.0, 0.0, 0.0], np.float32),
            forward=np.array([0.0, 0.0, 1.0], np.float32),
            up=np.array([0.0, 1.0, 0.0], np.float32),
            focal_length=0.040,
        )
    raise NotImplementedError(f"camera preset {name!r} is not ported yet (ROADMAP A9)")


def make_camera(name: str, width: int, height: int, device="cpu"):
    """The preset camera with its sensor fitted to the aspect ratio."""
    import torch

    from ..ops.camera import Camera

    pose = camera_preset(name)
    focal = pose.pop("focal_length", 0.016)
    sensor = np.array([0.036, 0.036 * (height / width)], np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        focal_length=t(focal), sensor_size=t(sensor),
        **{k: t(v) for k, v in pose.items()},
        znear=t(0.0), focus_distance=t(0.0), aperture=t(0.0),
    )
