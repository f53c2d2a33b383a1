from .data import DataFile, read_data, system_from_data, write_data  # noqa: F401
from .lammps_restart import (LammpsRestart, RestartError,  # noqa: F401
                             read_lammps_restart, write_lammps_restart)
