from .verlet import Simulation, make_step, run, setup, thermo_row  # noqa: F401
