"""Articulated rigid-body physics for the ant POMDPs, PyTorch port of
:mod:`gym_po_tpu.physics`.

The subset of MuJoCo the reference's ant envs use (reference
``gym_po/envs/ant_tag.py`` / ``ant_heaven_hell.py`` drive MuJoCo's C
pipeline), as batched tensor code over a leading env axis:

* :mod:`.spatial` — quaternion/SO(3) algebra (MuJoCo wxyz conventions)
* :mod:`.ant_model` — the static model from the mjcf leg spec (a copy of
  the JAX package's NumPy module)
* :mod:`.linalg` — the batched 14x14 SPD solve
* :mod:`.dynamics` — FK, the world-frame Jacobian formulation of CRBA/RNEA
* :mod:`.contact` — static-shape collision candidates, soft-constraint
  rows, the primal Newton and APGD solvers
* :mod:`.engine` — forward dynamics, RK4 on the qpos manifold, Euler

It ports the JAX package's array pipeline; the JAX package's scalar
pipeline and trace-time-unrolled Cholesky, which exist to make XLA emit
straight-line TPU vector code, are not carried over.
"""

from .ant_model import AntModel, HEAVEN_HELL_WALLS, TAG_WALLS, make_ant_model
from .engine import PhysicsState, init_state

__all__ = ["AntModel", "make_ant_model", "TAG_WALLS", "HEAVEN_HELL_WALLS",
           "PhysicsState", "init_state"]
