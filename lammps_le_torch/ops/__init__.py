from . import bond, cells, forces, pair  # noqa: F401
