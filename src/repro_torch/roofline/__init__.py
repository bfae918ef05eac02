from . import analysis  # noqa: F401
