from . import model  # noqa: F401
