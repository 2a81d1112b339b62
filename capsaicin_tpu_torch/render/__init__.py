from .settings import RenderOptions, Settings, default_settings  # noqa: F401
