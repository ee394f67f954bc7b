"""Per-chunk seeds of the chunked trainers, a copy of
:func:`gym_po_tpu.parallel.data_parallel.chunk_seeds` (NumPy only).

The multi-device half of that module (sharding, the per-chunk table
all-reduce) is not ported yet: ROADMAP Queue 1, "Multi-GPU".
"""

from __future__ import annotations

import numpy as np

__all__ = ["chunk_seeds"]


def chunk_seeds(seed: int, chunk_index: int, ndev: int) -> np.ndarray:
    """Disjoint per-shard seeds for one chunk: ``[ndev]`` int32.

    Every (chunk, shard) pair gets a distinct seed; shard ``i`` of chunk
    ``c`` never collides with any other pair for the same base ``seed``.
    """
    base = seed + chunk_index * ndev
    return (base + np.arange(ndev)).astype(np.int32)
