"""capsaicin_tpu_torch: the capsaicin-tpu renderer on PyTorch, with its
kernels written in CUDA C++ for NVIDIA Hopper (H100).

The JAX package `capsaicin_tpu` is the reference this port is held
against; this package imports no JAX. Module names follow the JAX
package's, so each counterpart is found under the same path.

Quick start::

    import capsaicin_tpu_torch as cap
    from capsaicin_tpu_torch.scene import build_scene
    from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera

    session = cap.create_session(1920, 1080)  # default RenderOptions
    session.set_camera(make_camera("cornell", 1920, 1080))
    session.set_scene(build_scene(cornell_box()))
    image = session.render()  # [H,W,3] numpy, gamma-encoded
"""

__version__ = "0.1.0"


def create_session(width: int = 1920, height: int = 1080, **kwargs):
    """A RenderSession (see render.session); device="cuda" by default."""
    from .render.session import RenderSession

    return RenderSession(width=width, height=height, **kwargs)
