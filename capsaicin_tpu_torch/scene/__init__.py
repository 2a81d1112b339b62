from .scene import Scene, build_scene  # noqa: F401
