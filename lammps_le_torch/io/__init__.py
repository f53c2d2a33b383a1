from .data import DataFile, system_from_data  # noqa: F401
