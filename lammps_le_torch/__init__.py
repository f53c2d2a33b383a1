"""PyTorch + CUDA port of ``lammps_le_tpu``: the grid-resident LE engine
(``fast/``) and the general path (``integrate.run``).

Plain tensor code is PyTorch; the fast engine's kernels are hand-written
CUDA for Hopper (``csrc/``), bound in ``fast/kernels.py``.  The package
imports nothing of jax, flax or the reference package: the host modules
it shares with the reference (``system``, ``units``, ``scene``,
``io.data.system_from_data``, ``fixes.config``) are copies.
"""
