"""The benchmark of lammps_le_torch, the PyTorch and CUDA port: one cell
a run (``python -m perfbench``), driven by the files of this folder."""
