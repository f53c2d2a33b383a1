"""PyTorch + CUDA port of the grid-resident LE engine of ``lammps_le_tpu``.

Plain tensor code is PyTorch; the step's kernels are hand-written CUDA for
Hopper (``csrc/step.cu``), bound in ``fast/kernels.py``.  The package
imports nothing of jax, flax or the reference package: the host modules
it shares with the reference (``system``, ``units``, ``scene.serpentine``,
``io.data.system_from_data``, ``fixes.config``) are copies.
"""
