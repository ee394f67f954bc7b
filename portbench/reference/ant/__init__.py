"""The ant's rigid-body engine, frozen: a copy of the port's batched
tensor engine (the JAX package's "array" pipeline written out in plain
PyTorch: kinematics by tree level, CRBA and RNEA, contact candidates and
rows, the primal Newton solve, RK4 on the configuration manifold),
importing nothing of the port.  The benchmark's ant cells hold the
program's per-env kernels to it; a later change to the program leaves it
as it is."""
