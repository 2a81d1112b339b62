"""The 2-unit Cornell box with a skylight opening in the ceiling (the
renderer's only light is a directional one): 40 triangles. A frozen copy
of capsaicin_tpu_torch/scene/procedural.py's cornell_box(), untextured."""

from portbench.lib.scene import Material, MeshData, box, quad

WHITE = (0.58, 0.568, 0.544)
RED = (0.504, 0.052, 0.04)
GREEN = (0.156, 0.426, 0.107)


def meshes():
    m_white = Material("white", kd=WHITE)
    m_red = Material("leftWall", kd=RED)
    m_green = Material("rightWall", kd=GREEN)
    m_floor = Material("floor", kd=WHITE)
    m_back = Material("backWall", kd=WHITE)

    def wall(name, mat, v0, v1, v2, v3, n):
        mesh = MeshData(name=name, material=mat)
        quad(mesh, v0, v1, v2, v3, normal=n)
        return mesh

    hx0, hx1 = -0.24, 0.23
    hz0, hz1 = -0.22, 0.16
    y = 2.0
    ceiling = MeshData(name="ceiling", material=m_white)
    n_dn = (0, -1, 0)
    quad(ceiling, (-1, y, -1), (-1, y, hz0), (1, y, hz0), (1, y, -1), n_dn)
    quad(ceiling, (-1, y, hz1), (-1, y, 1), (1, y, 1), (1, y, hz1), n_dn)
    quad(ceiling, (-1, y, hz0), (-1, y, hz1), (hx0, y, hz1), (hx0, y, hz0), n_dn)
    quad(ceiling, (hx1, y, hz0), (hx1, y, hz1), (1, y, hz1), (1, y, hz0), n_dn)

    return [
        box("shortBox", m_white, (0.33, 0.3, 0.37), (0.6, 0.6, 0.6), rot_deg=-17.0),
        box("tallBox", m_white, (-0.34, 0.6, -0.29), (0.6, 1.2, 0.6), rot_deg=17.0),
        wall("leftWall", m_red, (-1, 0, 1), (-1, 2, 1), (-1, 2, -1), (-1, 0, -1), (1, 0, 0)),
        wall("backWall", m_back, (-1, 0, 1), (1, 0, 1), (1, 2, 1), (-1, 2, 1), (0, 0, -1)),
        wall("rightWall", m_green, (1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1), (-1, 0, 0)),
        ceiling,
        wall("floor", m_floor, (-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), (0, 1, 0)),
    ]
