"""The plain reference of both configurations: the deployment's step
(``step``), its forces (``forces``), its LE events (``events``) and the
threefry streams they draw from (``threefry``), in plain PyTorch on any
device and float type.  It imports nothing of the program, of JAX or of
the JAX package."""
