"""What the CPU tests of the port's wavefront and cull traversals share:
seeded rays, the bars of tests/test_cull.py:27-47, the port's
brute-force oracle and the reference frames the two modes' frames are held
to (the port's "bvh" frames on the reduced colonnade, which
tests/test_torch_bvh_frame.py holds to the JAX package's)."""

import functools

import numpy as np
import torch

from capsaicin_tpu_torch.ops import brute, static
from capsaicin_tpu_torch.render import pipeline
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, make_camera

N_RAYS = 513  # four packets of 128 (sixteen of 32) and a partial one
W = H = 32
FRAMES = 3
SMALL = 2000  # colonnade(target_tris=2000): 4,966 triangles
TOL = dict(rtol=1e-3, atol=1e-4)
RMSE_BAR = 1e-3
FLIP_SHARE, FLIP_MAX = 0.05, 0.02  # tests/test_torch_bvh_frame.py:46-51


def triangles(scene) -> np.ndarray:
    return np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1).astype(np.float32)


def rays(seed: int, n: int = N_RAYS, spread: float = 1.5, dead_every: int = 7):
    """(origins, dirs, tmax) numpy: origins uniform in the cube of
    half-side `spread`, unit directions, tmax per ray in [0.5, 4 spread]
    with every `dead_every`-th ray dead (tmax -1 < tmin)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(0.5, 4.0 * spread, size=n).astype(np.float32)
    if dead_every:
        tmax[::dead_every] = -1.0
    return o, d, tmax


def random_triangles(seed: int, n: int = 300) -> np.ndarray:
    """Triangles scattered over [-3, 3]^3 in every orientation."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-3, 3, size=(n, 1, 3))
    return (base + rng.normal(scale=0.4, size=(n, 3, 3))).astype(np.float32)


def hold_closest(got, want):
    """tests/test_cull.py's bars: prim equal except on equal-t rays (t within
    rtol 1e-4), t within rtol 1e-5 and u, v within 1e-5 where prim matches
    on a hit, t >= 1e29 on an agreed miss. got/want: dicts of numpy arrays."""
    gp, wp = got["prim"], want["prim"]
    same = gp == wp
    np.testing.assert_allclose(got["t"][~same], want["t"][~same], rtol=1e-4)
    hit = (wp >= 0) & same
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][hit], want[k][hit], atol=1e-5)
    assert np.all(got["t"][(wp < 0) & same] >= 1e29)
    return same


def numpy_hits(out) -> dict:
    return {k: np.asarray(out[k]) for k in ("t", "u", "v", "prim")}


def brute_closest(tris, o, d, tmin, tmax):
    """The port's brute-force oracle (ops.brute's plain version on the CPU)."""
    scene = static.pack_triangles(torch.from_numpy(tris))
    return numpy_hits(brute.brute_force_closest(scene, torch.from_numpy(o), torch.from_numpy(d),
                                                tmin, torch.from_numpy(tmax)))


def brute_any(tris, o, d, tmin, tmax):
    scene = static.pack_triangles(torch.from_numpy(tris))
    return brute.brute_force_any(scene, torch.from_numpy(o), torch.from_numpy(d), tmin,
                                 torch.from_numpy(tmax)).numpy()


def session(traversal: str, mesh=None, **options) -> RenderSession:
    """A CPU session on the reduced colonnade with its camera, W x H."""
    s = RenderSession(W, H, options=RenderOptions(eaw_fused="0", eaw_bf16=False, **options),
                      device="cpu", traversal=traversal, mesh=mesh)
    s.set_camera(make_camera("colonnade", W, H))
    s.set_scene(build_scene(colonnade(target_tris=SMALL)))
    return s


def frames(s: RenderSession, n: int = FRAMES):
    """[(display, PassOutputs)] of n frames from a reset, numpy."""
    out, state = [], s.state
    for _ in range(n):
        display, state, aux = s.frame(state=state, collect_aux=True)
        out.append((display.numpy(), pipeline.PassOutputs(*[x.numpy() for x in aux])))
    return out


@functools.lru_cache(maxsize=None)
def bvh_frames():
    """The reference: the "bvh" mode's frames (cached within a process)."""
    return frames(session("bvh"))


def hold_frames(got, want):
    """Frames pass by pass, as tests/test_torch_bvh_frame.py holds the
    port's to the JAX package's: primary hit ids equal except on edge rays
    (at most 1% of the pixels), each PassOutputs field within TOL but for
    FLIP_SHARE of the pixels (within FLIP_MAX), display RMSE <= 1e-3."""
    for (g_display, g_aux), (w_display, w_aux) in zip(got, want):
        diff = g_aux.gbuffer_prim != w_aux.gbuffer_prim
        edge = np.zeros_like(diff)
        for p, b in ((g_aux.gbuffer_prim, g_aux.gbuffer_bary),
                     (w_aux.gbuffer_prim, w_aux.gbuffer_bary)):
            u, v = b[..., 0], b[..., 1]
            edge |= (p >= 0) & ((u < 1e-5) | (v < 1e-5) | (1.0 - u - v < 1e-5))
        assert not np.any(diff & ~edge)
        assert diff.mean() <= 0.01
        assert (g_aux.gbuffer_prim >= 0).mean() > 0.5  # the camera sees the hall
        for field in pipeline.PassOutputs._fields:
            g, w = getattr(g_aux, field), getattr(w_aux, field)
            assert g.shape == w.shape, field
            g, w = g[~diff], w[~diff]
            off = ~np.isclose(g, w, **TOL)
            off = off.reshape(len(off), -1).any(-1)
            assert off.mean() <= FLIP_SHARE, (field, off.mean())
            np.testing.assert_allclose(g[off], w[off], rtol=0, atol=FLIP_MAX, err_msg=field)
        assert np.isfinite(g_display).all()
        assert float(np.sqrt(np.mean((g_display - w_display) ** 2))) <= RMSE_BAR


def hold_mesh_frame(traversal: str, want):
    """The mode's first frame on a mesh of 2 x "cpu" against the unsharded
    one: primary hit ids equal, display RMSE <= 1e-3."""
    from capsaicin_tpu_torch.parallel import make_mesh

    s = session(traversal, mesh=make_mesh(["cpu"] * 2))
    assert s.sharding is not None and len(s.sharding.blocks) == 2
    # the structure reaches each device as a copy whose attributes are there
    (replica,) = [r[1] for r in s._replicas.values()]
    assert type(replica) is type(s.accel) and replica is not s.accel
    for k, v in vars(s.accel).items():
        r = getattr(replica, k)
        assert torch.equal(r, v) and r.device == v.device if torch.is_tensor(v) else r == v
    display, _, aux = s.frame(collect_aux=True)
    w_display, w_aux = want
    np.testing.assert_array_equal(aux.gbuffer_prim.numpy(), w_aux.gbuffer_prim)
    assert float(np.sqrt(np.mean((display.numpy() - w_display) ** 2))) <= RMSE_BAR
