from .engine import Request, ServeConfig, ServeEngine  # noqa: F401
