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

These modules port the JAX package's array pipeline.  Its default scalar
pipeline (per-env straight-line code, which XLA turns into TPU vector
code) is ported as hand-written CUDA kernels
(:mod:`gym_po_tpu_torch.ops.ant_forward`), which :func:`.engine.forward`
runs for ``pipeline="scalar"`` on a CUDA tensor.
"""

from .ant_model import AntModel, HEAVEN_HELL_WALLS, TAG_WALLS, make_ant_model
from .engine import PhysicsState, init_state

__all__ = ["AntModel", "make_ant_model", "TAG_WALLS", "HEAVEN_HELL_WALLS",
           "PhysicsState", "init_state"]
