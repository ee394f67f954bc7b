"""gym-po-tpu, PyTorch + CUDA port.

A second package beside the JAX reference :mod:`gym_po_tpu`, with the same
layout and names.  It imports ``torch`` and numpy, never ``jax``; its CUDA
kernels (``csrc/``) are built with ``nvcc`` at first use on a CUDA device,
and every kernel has a plain PyTorch twin that CPU tensors go through.
"""

__version__ = "0.1.0"

from .core import Box, Discrete, Environment, EnvState, Space
from .registry import make, register, registered_envs

__all__ = [
    "Environment",
    "EnvState",
    "Space",
    "Discrete",
    "Box",
    "make",
    "register",
    "registered_envs",
    "__version__",
]
