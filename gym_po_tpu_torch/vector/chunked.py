"""Sequential chunked batching, PyTorch port of
:mod:`gym_po_tpu.vector.chunked`.

In the JAX package this is the remedy for a TPU batch cliff: above
B = 4,096 the ant engine's Newton solve spills out of VMEM, and a program
compiled at 4,096 and dispatched once per chunk outran the single program.
On the H100 there is no such cliff: one Euler ant step at B = 16,384 has
3.05-3.88x the rate of four steps at 4,096 (NVIDIA H100 80GB HBM3, 700 W;
``chip_smoke.py`` path 9's batch scan).  So here chunking is no speed
remedy.  It bounds what one step holds at once to a chunk's working set,
and it keeps the JAX package's API:

* :func:`chunked_rollout`: :func:`~gym_po_tpu_torch.vector.rollout` over
  ``num_envs / dispatch_batch`` chunks in turn;
* :func:`make_chunked_step`: a ``step_vec``-shaped callable that steps a
  batch chunk by chunk.

Chunk ``i`` draws from the ``i``-th generator of
:func:`~gym_po_tpu_torch.parallel.split_generator` of the caller's (the
counterpart of ``fold_in(key, i)``), so a chunked call draws otherwise
than a single one, from the same distributions.  At or below
``dispatch_batch`` envs a call is the plain one, with the caller's
generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..core import Environment, EnvState, map_tensors
from .vec_env import Transition, rollout

__all__ = ["chunked_rollout", "make_chunked_step", "DISPATCH_BATCH"]

#: the JAX package's compiled sweet spot of the ant engine on a TPU
DISPATCH_BATCH = 4096


def _split_chunks(tree, num_chunks: int) -> List[Any]:
    """A ``[B, ...]`` tree (tensors, states, tuples, dicts) as
    ``num_chunks`` trees of ``[B / num_chunks, ...]`` views."""

    def chunk(i):
        def rows(x):
            n = x.shape[0] // num_chunks
            return x[i * n:(i + 1) * n]
        return map_tensors(rows, tree)

    return [chunk(i) for i in range(num_chunks)]


def _concat_chunks(trees: List[Any], dim: int = 0):
    """Trees of the same structure joined along ``dim`` of every tensor."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees, dim)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _concat_chunks([getattr(t, f.name) for t in trees], dim)
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        items = [_concat_chunks([t[k] for t in trees], dim)
                 for k in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    if isinstance(first, dict):
        return {k: _concat_chunks([t[k] for t in trees], dim) for k in first}
    return first


def _chunk_generators(generator: torch.Generator, n: int) -> List[torch.Generator]:
    from ..parallel import split_generator  # parallel imports this package

    return split_generator(generator, n)


def _chunks(num_envs: int, dispatch_batch: int) -> int:
    if num_envs % dispatch_batch:
        raise ValueError(f"batch {num_envs} must be a multiple of "
                         f"dispatch_batch={dispatch_batch}")
    return num_envs // dispatch_batch


def chunked_rollout(
    env: Environment,
    generator: torch.Generator,
    policy: Optional[Callable[[torch.Generator, torch.Tensor], torch.Tensor]],
    num_envs: int,
    num_steps: int,
    dispatch_batch: int = DISPATCH_BATCH,
    init: Optional[Tuple[torch.Tensor, EnvState]] = None,
) -> Tuple[Transition, Tuple[torch.Tensor, EnvState]]:
    """:func:`~gym_po_tpu_torch.vector.rollout` of ``num_envs`` envs as
    ``num_envs / dispatch_batch`` rollouts of ``dispatch_batch`` envs in
    turn, chunk ``i`` of ``init``'s rows (or of a fresh reset) under the
    ``i``-th split generator.

    Returns ``rollout``'s ``([T, B, ...]`` trajectory, full-``B`` final
    ``(obs, state))``.  ``dispatch_batch`` must divide ``num_envs``; at or
    below ``dispatch_batch`` it is one plain rollout from ``generator``.
    """
    if num_envs <= dispatch_batch:
        return rollout(env, generator, policy, num_envs, num_steps, init=init)
    n = _chunks(num_envs, dispatch_batch)
    inits = [None] * n if init is None else _split_chunks(init, n)
    outs = [rollout(env, gen, policy, dispatch_batch, num_steps, init=chunk_init)
            for gen, chunk_init in zip(_chunk_generators(generator, n), inits)]
    return (_concat_chunks([o[0] for o in outs], dim=1),
            _concat_chunks([o[1] for o in outs]))


def make_chunked_step(env: Environment, dispatch_batch: int = DISPATCH_BATCH
                      ) -> Callable[[torch.Generator, EnvState, torch.Tensor], tuple]:
    """A ``step_vec``-shaped callable that steps a batch chunk by chunk.

    ``step(generator, state, actions)`` with ``[B, ...]`` inputs returns
    ``step_vec``'s ``(obs, state, reward, done, trunc, info)`` for all ``B``
    envs, each ``dispatch_batch`` rows stepped by their own ``step_vec``
    call under the chunk's split generator.  ``B`` must be a multiple of
    ``dispatch_batch``; at or below it the step is one plain ``step_vec``
    from ``generator``.
    """

    def step(generator: torch.Generator, state: EnvState, actions: torch.Tensor):
        B = actions.shape[0]
        if B <= dispatch_batch:
            return env.step_vec(generator, state, actions)
        n = _chunks(B, dispatch_batch)
        outs = [env.step_vec(gen, st, act) for gen, st, act in zip(
            _chunk_generators(generator, n), _split_chunks(state, n),
            _split_chunks(actions, n))]
        return tuple(_concat_chunks([o[k] for o in outs]) for k in range(6))

    return step
