from . import bind  # noqa: F401
