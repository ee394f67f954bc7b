"""Data-parallel execution of the fused trainers, PyTorch port of
:mod:`gym_po_tpu.parallel.data_parallel`.

The chunk-synchronous table-averaging scheme of the JAX package
(``docs/MULTIHOST.md``), across the ranks of a process group:

1. the env batch is sharded over the ranks; each runs the single-device
   trainer (a CUDA kernel, or its twin on the CPU) on its shard with its
   own table copy, seeded disjointly (:func:`chunk_seeds`);
2. after every chunk (one trainer call, K steps) the tables are averaged
   across the ranks: an ``all_reduce`` sum divided by the group's size,
   JAX's ``pmean``;
3. the next chunk resumes from the averaged tables.

Not ported: ``make_xla_q_chunk_trainer``, the JAX package's stand-in for
its kernel on a CPU mesh: the port's twins run on the CPU already.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from ..core import map_tensors
from .mesh import Mesh

__all__ = ["shard_fused_trainer", "chunk_seeds", "replicate"]


def replicate(mesh: Mesh, tree):
    """``tree`` (tensors or arrays) as rank 0 holds it, on every rank, on
    the mesh's device: a broadcast from rank 0.  A tensor that lies on the
    mesh's device already is overwritten in place (views of it, such as a
    model's parameters, follow)."""

    def bcast(x: torch.Tensor) -> torch.Tensor:
        x = x.to(mesh.device)
        if mesh.group is not None:
            dist.broadcast(x, src=0, group=mesh.group)
        return x

    return map_tensors(bcast, tree)


def chunk_seeds(seed: int, chunk_index: int, ndev: int) -> np.ndarray:
    """Disjoint per-shard seeds for one chunk: ``[ndev]`` int32.

    Every (chunk, shard) pair gets a distinct seed; shard ``i`` of chunk
    ``c`` never collides with any other pair for the same base ``seed``.
    """
    base = seed + chunk_index * ndev
    return (base + np.arange(ndev)).astype(np.int32)


def shard_fused_trainer(run_chunk: Callable, mesh: Mesh, *,
                        sharded_args: Iterable[int], averaged_outs: Iterable[int],
                        num_outs: int) -> Callable:
    """Wrap a single-device chunk trainer into a data-parallel one.

    ``run_chunk(seed: int, *args) -> (out_0, ..., out_{num_outs-1})`` is the
    contract of the fused trainer family (``make_fused_q_trainer`` et al.).
    The wrapped function takes ``(seeds [size], *args)`` on every rank:

    - args at positions in ``sharded_args`` (0-indexed after the seeds) are
      the rank's rows of the per-env state tiles (:func:`~.mesh.shard_batch`);
      all other args (scalars, table banks) are the same on every rank;
    - the rank runs ``run_chunk(seeds[rank], *args)``, which communicates
      nothing;
    - outputs at positions in ``averaged_outs`` are averaged over the ranks
      (the same on every rank afterwards: feed them back in as they are);
      the rest are the rank's own.
    """
    sharded = frozenset(sharded_args)
    averaged = frozenset(averaged_outs)
    if not averaged:
        raise ValueError("averaged_outs is empty: tables would never sync")

    def wrapped(seeds, *args):
        if len(seeds) != mesh.size:
            raise ValueError(f"{len(seeds)} seeds for {mesh.size} rank(s)")
        if sharded and max(sharded) >= len(args):
            raise ValueError(f"sharded_args {sorted(sharded)} past the "
                             f"{len(args)} arguments")
        out = run_chunk(int(seeds[mesh.rank]), *args)
        if len(out) != num_outs:
            raise ValueError(
                f"run_chunk returned {len(out)} outputs, expected {num_outs}")
        return tuple(mesh.all_mean_(o) if j in averaged else o
                     for j, o in enumerate(out))

    return wrapped
