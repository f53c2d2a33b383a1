from .config import (  # noqa: F401
    NVE,
    Extrusion,
    ExLoad,
    ExUnload,
    Langevin,
    NVELimit,
)
from .momentum import Momentum  # noqa: F401,E402  (registers the style)
from .viscous import Viscous  # noqa: F401,E402  (registers the style)
