from .input import CameraRig  # noqa: F401
