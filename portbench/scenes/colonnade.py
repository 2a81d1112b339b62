"""An open-air hall of columns, roof beams and spheres on a floor, about
`target_tris` triangles (249,190 at 250,000): a frozen copy of
capsaicin_tpu_torch/scene/procedural.py's colonnade(), its spheres built
with numpy in the same vertex order. The sphere placement draws from
numpy's default_rng(seed) in a fixed order, so a seed gives the same
triangles wherever it runs."""

import numpy as np

from portbench.lib.scene import Material, MeshData, box, quad


def uv_sphere(name, mat, center, radius, nu: int, nv: int) -> MeshData:
    """A latitude-longitude sphere of nu x nv quads (4 own vertices each)."""
    i, j = np.meshgrid(np.arange(nv), np.arange(nu), indexing="ij")
    corner = np.array([(0, 0), (0, 1), (1, 1), (1, 0)])
    ii = i[..., None] + corner[:, 0]  # [nv, nu, 4]
    jj = j[..., None] + corner[:, 1]
    theta = np.pi * ii / nv
    phi = 2 * np.pi * jj / nu
    n = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)], -1)
    pos = np.asarray(center) + radius * n
    uv = np.stack([jj / nu, ii / nv], -1)
    base = 4 * np.arange(nu * nv)[:, None]
    idx = (base + np.array([0, 1, 2, 0, 2, 3])).ravel()
    return MeshData(name=name, positions=pos.ravel().tolist(), normals=n.ravel().tolist(),
                    texcoords=uv.ravel().tolist(), indices=idx.tolist(), material=mat)


def meshes(target_tris: int = 250_000, seed: int = 42):
    rng = np.random.default_rng(seed)
    m_stone = Material("stone", kd=(0.6, 0.58, 0.55))
    out = []
    room = MeshData(name="room", material=m_stone)
    quad(room, (-20, 0, -10), (20, 0, -10), (20, 0, 10), (-20, 0, 10), (0, 1, 0))
    quad(room, (-20, 0, 10), (20, 0, 10), (20, 8, 10), (-20, 8, 10), (0, 0, -1))
    quad(room, (-20, 0, -10), (-20, 8, -10), (20, 8, -10), (20, 0, -10), (0, 0, 1))
    quad(room, (-20, 0, -10), (-20, 0, 10), (-20, 8, 10), (-20, 8, -10), (1, 0, 0))
    quad(room, (20, 0, -10), (20, 8, -10), (20, 8, 10), (20, 0, 10), (-1, 0, 0))
    out.append(room)

    budget = target_tris - 10
    for k in range(13):  # roof beams: shadow stripes across the hall
        out.append(box(f"beam{k}", m_stone, (-18 + k * 3.0, 7.8, 0), (1.6, 0.4, 20.0)))
        budget -= 12
    for k in range(16):  # columns
        x = -18 + (k % 8) * 5.0
        z = -6 if k < 8 else 6
        out.append(box(f"column{k}", m_stone, (x, 2.5, z), (0.8, 5.0, 0.8)))
        budget -= 12

    n_spheres = max(1, budget // (2 * 48 * 48))
    placed = 0
    while placed < n_spheres:
        x = float(rng.uniform(-18, 18))
        z = float(rng.uniform(-8, 8))
        if x < -12 and z < -4:  # keep the "colonnade" camera's corner clear
            continue
        r = float(rng.uniform(0.4, 1.1))
        y = float(rng.uniform(r, 6.0))
        out.append(uv_sphere(f"sphere{placed}", m_stone, (x, y, z), r, 48, 48))
        placed += 1
    return out
