"""The procedural scenes of capsaicin_tpu/scene/procedural.py, built with
numpy and torch only: the Cornell boxes (plain and textured) and their
textures, the colonnade and its textured form, the camera presets, and
`write_obj`, which writes any mesh list as OBJ + MTL for the ingest path
(the same bytes as the JAX package's)."""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

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


def cornell_box(floor_texture: str = "", back_texture: str = "") -> List[MeshData]:
    """The 2-unit Cornell box with a skylight opening in the ceiling (the
    renderer's only light is a directional one): 40 triangles. The floor
    and back wall may name a diffuse texture."""
    m_white = Material("white", kd=WHITE)
    m_red = Material("leftWall", kd=RED)
    m_green = Material("rightWall", kd=GREEN)
    m_floor = Material("floor", kd=WHITE, diffuse_texname=floor_texture)
    m_back = Material("backWall", kd=WHITE, diffuse_texname=back_texture)

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


def _q8(img: np.ndarray) -> np.ndarray:
    """Snap to the 8-bit grid, as a PNG's pixels are (which makes
    scene.quantize_atlas lossless)."""
    return (np.round(img * 255.0) / np.float32(255.0)).astype(np.float32)


def checker_texture(size: int = 128, tiles: int = 8) -> np.ndarray:
    """[size,size,4] checkerboard in [0,1] (display-referred, like a PNG)."""
    ax = np.arange(size)
    cell = (ax[:, None] * tiles // size + ax[None, :] * tiles // size) % 2
    img = np.repeat(np.where(cell[..., None] == 0, 0.9, 0.25).astype(np.float32), 3, axis=-1)
    return _q8(np.concatenate([img, np.ones((size, size, 1), np.float32)], axis=-1))


def stripe_texture(h: int = 48, w: int = 96, stripes: int = 12) -> np.ndarray:
    """[h,w,4] vertical stripes, non-square and of another size than the
    checker, so a two-texture atlas is padded and wraps per texture."""
    band = (np.arange(w) * stripes // w) % 2
    img = np.repeat(np.where(band[None, :, None] == 0, 0.85, 0.35).astype(np.float32), 3, axis=-1)
    img = np.broadcast_to(img, (h, w, 3)).copy()
    return _q8(np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=-1))


def cornell_box_textured() -> Tuple[List[MeshData], dict]:
    """The Cornell box with a checkerboard floor: (meshes, textures)."""
    return cornell_box(floor_texture="checker.png"), {"checker.png": checker_texture()}


def cornell_box_multitextured() -> Tuple[List[MeshData], dict]:
    """Two textures of different sizes: a 128x128 checker floor and a 48x96
    striped back wall."""
    meshes = cornell_box(floor_texture="checker.png", back_texture="stripes.png")
    return meshes, {"checker.png": checker_texture(), "stripes.png": stripe_texture()}


def _uv_sphere(name: str, mat: Material, center, radius, nu: int, nv: int) -> MeshData:
    """A latitude-longitude sphere of nu x nv quads (4 own vertices each)."""
    mesh = MeshData(name=name)
    mesh.material = mat
    cx, cy, cz = center
    base = 0
    for i in range(nv):
        for j in range(nu):
            for (di, dj) in ((0, 0), (0, 1), (1, 1), (1, 0)):
                theta = math.pi * (i + di) / nv
                phi = 2 * math.pi * (j + dj) / nu
                nx = math.sin(theta) * math.cos(phi)
                ny = math.cos(theta)
                nz = math.sin(theta) * math.sin(phi)
                mesh.positions.extend((cx + radius * nx, cy + radius * ny, cz + radius * nz))
                mesh.normals.extend((nx, ny, nz))
                mesh.texcoords.extend(((j + dj) / nu, (i + di) / nv))
            mesh.indices.extend([base, base + 1, base + 2, base, base + 2, base + 3])
            base += 4
    return mesh


def colonnade(target_tris: int = 250_000, seed: int = 42) -> List[MeshData]:
    """An open-air hall of columns, roof beams and spheres on a floor,
    about `target_tris` triangles (249,190 at the default): the large-scene
    stress case of BVH traversal. The sphere placement draws from
    numpy's default_rng(seed) in a fixed order, so a seed gives the same
    triangles wherever it runs."""
    rng = np.random.default_rng(seed)
    m_stone = Material("stone", kd=(0.6, 0.58, 0.55))
    meshes: List[MeshData] = []

    # floor and walls, 40 x 8 x 20, no roof: the only light is the sun
    room = MeshData(name="room")
    room.material = m_stone
    _quad(room, (-20, 0, -10), (20, 0, -10), (20, 0, 10), (-20, 0, 10), (0, 1, 0))
    _quad(room, (-20, 0, 10), (20, 0, 10), (20, 8, 10), (-20, 8, 10), (0, 0, -1))
    _quad(room, (-20, 0, -10), (-20, 8, -10), (20, 8, -10), (20, 0, -10), (0, 0, 1))
    _quad(room, (-20, 0, -10), (-20, 0, 10), (-20, 8, 10), (-20, 8, -10), (1, 0, 0))
    _quad(room, (20, 0, -10), (20, 8, -10), (20, 8, 10), (20, 0, 10), (-1, 0, 0))
    meshes.append(room)

    budget = target_tris - 10
    for k in range(13):  # roof beams: shadow stripes across the hall
        meshes.append(_box(f"beam{k}", m_stone, (-18 + k * 3.0, 7.8, 0), (1.6, 0.4, 20.0)))
        budget -= 12
    for k in range(16):  # columns
        x = -18 + (k % 8) * 5.0
        z = -6 if k < 8 else 6
        meshes.append(_box(f"column{k}", m_stone, (x, 2.5, z), (0.8, 5.0, 0.8)))
        budget -= 12

    # the spheres carry the triangle count
    n_spheres = max(1, budget // (2 * 48 * 48))
    placed = 0
    while placed < n_spheres:
        x = float(rng.uniform(-18, 18))
        z = float(rng.uniform(-8, 8))
        if x < -12 and z < -4:  # keep the "colonnade" camera's corner clear
            continue
        r = float(rng.uniform(0.4, 1.1))
        y = float(rng.uniform(r, 6.0))
        meshes.append(_uv_sphere(f"sphere{placed}", m_stone, (x, y, z), r, 48, 48))
        placed += 1
    return meshes


def colonnade_textured(target_tris: int = 250_000, seed: int = 42
                       ) -> Tuple[List[MeshData], dict]:
    """The colonnade with three materials, two of them textured: a checker
    on the floor and walls, stripes on the spheres, plain stone on the
    beams and columns. The stress case of the OBJ/MTL/PNG ingest
    (asset_load_system.cpp:40-160), as the reference viewer's sponza.obj
    (src/viewer/main.cpp:88) is. Returns (meshes, textures)."""
    meshes = colonnade(target_tris, seed)
    m_floor = Material("stone_floor", kd=(0.6, 0.58, 0.55), diffuse_texname="checker.png")
    m_marble = Material("marble", kd=(0.62, 0.6, 0.58), diffuse_texname="stripes.png")
    for mesh in meshes:
        if mesh.name == "room":
            mesh.material = m_floor
            mesh.texture_name = m_floor.diffuse_texname
        elif mesh.name.startswith("sphere"):
            mesh.material = m_marble
            mesh.texture_name = m_marble.diffuse_texname
    return meshes, {"checker.png": checker_texture(), "stripes.png": stripe_texture()}


def write_obj(path: str, meshes: List[MeshData], mtl_name: Optional[str] = None):
    """Write meshes as an OBJ and its MTL (beside it, named after it
    unless `mtl_name` is given): one `o` shape a mesh, positions, normals
    and texcoords at 6 decimals, each triangle as v/t/n indices."""
    mtl_name = mtl_name or os.path.splitext(os.path.basename(path))[0] + ".mtl"
    mats = {}
    for mesh in meshes:
        if mesh.material and mesh.material.name not in mats:
            mats[mesh.material.name] = mesh.material
    with open(os.path.join(os.path.dirname(path), mtl_name), "w") as f:
        for mat in mats.values():
            f.write(f"newmtl {mat.name}\n")
            f.write(f"Kd {mat.kd[0]:.6f} {mat.kd[1]:.6f} {mat.kd[2]:.6f}\n")
            if any(mat.ke):
                f.write(f"Ke {mat.ke[0]} {mat.ke[1]} {mat.ke[2]}\n")
            if mat.diffuse_texname:
                f.write(f"map_Kd {mat.diffuse_texname}\n")
            f.write("\n")
    with open(path, "w") as f:
        f.write(f"mtllib {mtl_name}\n")
        v_off = n_off = t_off = 1
        for mesh in meshes:
            f.write(f"o {mesh.name}\n")
            pos = np.asarray(mesh.positions).reshape(-1, 3)
            nrm = np.asarray(mesh.normals).reshape(-1, 3)
            uv = np.asarray(mesh.texcoords).reshape(-1, 2)
            for p in pos:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for n in nrm:
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
            for t in uv:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
            if mesh.material:
                f.write(f"usemtl {mesh.material.name}\n")
            for tri in np.asarray(mesh.indices).reshape(-1, 3):
                f.write("f " + " ".join(f"{v_off + i}/{t_off + i}/{n_off + i}" for i in tri) + "\n")
            v_off += pos.shape[0]
            n_off += nrm.shape[0]
            t_off += uv.shape[0]


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
    if name == "colonnade":
        # from the hall's corner, looking down its length
        f = np.array([0.85, -0.22, 0.48])
        f = f / np.linalg.norm(f)
        r = np.cross(np.array([0.0, 1.0, 0.0]), f)
        r /= np.linalg.norm(r)
        return dict(
            position=np.array([-17.5, 6.0, -7.5], np.float32),
            right=r.astype(np.float32),
            forward=f.astype(np.float32),
            up=np.cross(f, r).astype(np.float32),
        )
    raise ValueError(f"unknown camera preset {name!r}")


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
