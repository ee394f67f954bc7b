"""Core functional environment protocol, PyTorch port of
:mod:`gym_po_tpu.core.env`.

The JAX package threads an immutable ``flax.struct.PyTreeNode`` state
through pure functions keyed by ``jax.random`` keys.  Here the state is a
frozen ``dataclass`` of tensors with a ``replace`` method, and randomness is
an explicit ``torch.Generator`` argument: every draw an env makes comes from
the generator it is handed, on that generator's device.

``step`` keeps the reference's in-graph autoreset with reset-before-obs
semantics: for environments that finished, the returned obs belongs to the
new episode, and ``info["terminal_state"]`` holds the pre-reset state.
Each env also factors its dynamics into deterministic stages that take their
draws as arguments, so tests can feed both packages identical draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generic, List, Tuple, TypeVar

import numpy as np
import torch

from .spaces import Space

__all__ = ["EnvState", "Environment", "StepOut", "map_tensors"]


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Base class for environment states: a frozen dataclass of tensors.

    ``elapsed`` mirrors the reference's per-env step counter.
    """

    elapsed: torch.Tensor

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


TState = TypeVar("TState", bound=EnvState)

# (obs, state, reward, done, truncated, info)
StepOut = Tuple[torch.Tensor, TState, torch.Tensor, torch.Tensor, torch.Tensor,
                Dict[str, Any]]


def map_tensors(fn, tree):
    """``fn`` on every tensor of a tree of dataclasses (states), tuples,
    lists and dicts (a numpy array is taken as a tensor first); other
    leaves as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        items = [map_tensors(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [map_tensors(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def _stack(items: List[Any]):
    """Stack per-instance outputs (tensors, states, tuples, dicts) on a new
    axis 0."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, tuple):  # plain or named
        fields = [_stack([x[k] for x in items]) for k in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    if isinstance(first, EnvState):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(x, f.name) for x in items])
            for f in dataclasses.fields(first)
        })
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items]) for k in first}
    raise TypeError(f"cannot stack {type(first)}")


def _unstack(state: EnvState, i: int) -> EnvState:
    """Instance ``i`` of a batched state."""

    def pick(v):
        return _unstack(v, i) if isinstance(v, EnvState) else v[i]

    return dataclasses.replace(state, **{
        f.name: pick(getattr(state, f.name)) for f in dataclasses.fields(state)
    })


class Environment(Generic[TState]):
    """Single-instance environment with batched fast paths.

    Subclasses precompute their lookup tables on the host in ``__init__``
    and implement ``reset_env`` / ``step_env``.  The batched ``reset_vec`` /
    ``step_vec`` / ``observe_vec`` defaults below loop over instances and are
    correct for any env; each env overrides them with a version written over
    a leading batch axis.
    """

    #: human-readable name, mirrors reference ``metadata['name']``
    name: str = "Environment"

    # ---------------------------------------------------------------- spaces
    @property
    def observation_space(self) -> Space:
        raise NotImplementedError

    @property
    def action_space(self) -> Space:
        raise NotImplementedError

    # ------------------------------------------------------------- protocol
    def reset(self, generator: torch.Generator) -> Tuple[torch.Tensor, TState]:
        """Start a fresh episode."""
        return self.reset_env(generator)

    def step(self, generator: torch.Generator, state: TState,
             action: torch.Tensor) -> StepOut:
        """Advance one step with autoreset (reset-before-obs)."""
        return self.step_env(generator, state, action)

    # ------------------------------------------------------ implementations
    def reset_env(self, generator: torch.Generator) -> Tuple[torch.Tensor, TState]:
        raise NotImplementedError

    def step_env(self, generator: torch.Generator, state: TState,
                 action: torch.Tensor) -> StepOut:
        raise NotImplementedError

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, generator: torch.Generator,
                  num_envs: int) -> Tuple[torch.Tensor, TState]:
        """Reset a batch of ``num_envs`` instances."""
        return _stack([self.reset(generator) for _ in range(num_envs)])

    def step_vec(self, generator: torch.Generator, state: TState,
                 action: torch.Tensor) -> StepOut:
        """Step a batch (leading axis taken from ``action``)."""
        return _stack([self.step(generator, _unstack(state, i), action[i])
                       for i in range(action.shape[0])])

    # --------------------------------------------------------------- extras
    def observe(self, state: TState) -> torch.Tensor:
        """Observation as a pure function of state."""
        raise NotImplementedError

    def observe_vec(self, state: TState) -> torch.Tensor:
        """Batched :meth:`observe` (leading axis on every state leaf)."""
        return torch.stack([self.observe(_unstack(state, i))
                            for i in range(state.elapsed.shape[0])])

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.name})"
