from .config import NVE, ExLoad, ExUnload, Extrusion, Langevin  # noqa: F401
