from .data import DataFile, system_from_data  # noqa: F401
from .lammps_restart import (LammpsRestart, RestartError,  # noqa: F401
                             read_lammps_restart, write_lammps_restart)
