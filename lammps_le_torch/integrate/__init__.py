from .simulation import Simulation  # noqa: F401
