"""Batched environment execution, PyTorch port of
:mod:`gym_po_tpu.vector.vec_env`.

The batch axis is a leading tensor axis: ``Environment.step_vec`` steps all
B envs with masked autoreset.  ``rollout`` is a Python loop over
``step_vec`` in place of the JAX package's ``lax.scan``; the fused CUDA
kernel (:mod:`gym_po_tpu_torch.ops.fused_taxi`) is the path that keeps a
whole K-step rollout on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core import Environment, EnvState, Space, batch_space
from ..core.env import _stack

__all__ = ["VecEnv", "Transition", "rollout", "RecordEpisodeStatistics", "EpisodeStatsState"]


class VecEnv:
    """Leading-batch-axis view of an :class:`Environment` (reference
    ``extended_taxi.py:171-202`` vec-env surface)."""

    def __init__(self, env: Environment, num_envs: int):
        self.env = env
        self.num_envs = int(num_envs)
        self.is_vector_env = True

    # ------------------------------------------------------------- spaces
    @property
    def single_observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def single_action_space(self) -> Space:
        return self.env.action_space

    @property
    def observation_space(self) -> Space:
        return batch_space(self.env.observation_space, self.num_envs)

    @property
    def action_space(self) -> Space:
        return batch_space(self.env.action_space, self.num_envs)

    # ------------------------------------------------------------ protocol
    def reset(self, generator: torch.Generator) -> Tuple[torch.Tensor, EnvState]:
        return self.env.reset_vec(generator, self.num_envs)

    def step(self, generator: torch.Generator, state: EnvState,
             actions: torch.Tensor):
        return self.env.step_vec(generator, state, actions)

    def __repr__(self) -> str:  # pragma: no cover
        return f"VecEnv({self.env!r}, num_envs={self.num_envs})"


class Transition(NamedTuple):
    """One time-slice of a rollout, shapes ``[B, ...]`` (``[T, B, ...]`` once
    stacked by :func:`rollout`)."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, Any]


def rollout(
    env: Environment,
    generator: torch.Generator,
    policy: Optional[Callable[[torch.Generator, torch.Tensor], torch.Tensor]],
    num_envs: int,
    num_steps: int,
    init: Optional[Tuple[torch.Tensor, EnvState]] = None,
    keep_infos: bool = False,
) -> Tuple[Transition, Tuple[torch.Tensor, EnvState]]:
    """Collect a ``[T, B]`` trajectory, one ``step_vec`` per step.

    Args:
      env: single-instance environment.
      generator: every draw (policy and env) comes from it, in step order.
      policy: ``(generator, obs[B]) -> actions[B]``; ``None`` samples the
        action space uniformly.
      init: optional ``(obs, state)`` from a previous call to continue from.
      keep_infos: stack per-step infos (costs memory: T×B×state).

    Returns:
      ``(traj, (final_obs, final_state))`` where ``traj`` fields have a
      leading time axis.
    """
    if policy is None:
        space = env.action_space

        def policy(g, obs):  # noqa: F811 — uniform random policy
            return space.sample_vec(g, obs.shape[0])

    if init is None:
        obs, state = env.reset_vec(generator, num_envs)
    else:
        obs, state = init

    steps = []
    for _ in range(num_steps):
        actions = policy(generator, obs)
        nobs, state, rew, done, trunc, info = env.step_vec(generator, state, actions)
        steps.append(Transition(obs, actions, rew, done, trunc,
                                info if keep_infos else {}))
        obs = nobs
    return _stack(steps), (obs, state)


@dataclasses.dataclass(frozen=True)
class EpisodeStatsState(EnvState):
    """Wrapper state: inner env state + episode accumulators."""

    env_state: EnvState
    episode_return: torch.Tensor  # running return of the current episode
    episode_length: torch.Tensor  # running length of the current episode
    returned_return: torch.Tensor  # return of the last finished episode
    returned_length: torch.Tensor  # length of the last finished episode


class RecordEpisodeStatistics(Environment):
    """Episode return/length accounting as a wrapper env (gymnax-style)."""

    def __init__(self, env: Environment):
        self.env = env
        self.name = f"Stats({env.name})"

    @property
    def observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    @staticmethod
    def _wrap(inner: EnvState) -> EpisodeStatsState:
        zf = torch.zeros_like(inner.elapsed, dtype=torch.float32)
        zi = torch.zeros_like(inner.elapsed, dtype=torch.int32)
        return EpisodeStatsState(
            elapsed=inner.elapsed,
            env_state=inner,
            episode_return=zf,
            episode_length=zi,
            returned_return=zf,
            returned_length=zi,
        )

    def reset_env(self, generator: torch.Generator):
        obs, inner = self.env.reset(generator)
        return obs, self._wrap(inner)

    def step_env(self, generator: torch.Generator, state: EpisodeStatsState,
                 action: torch.Tensor):
        out = self.env.step(generator, state.env_state, action)
        return self._account(state, out)

    # the accumulator arithmetic is elementwise, so the batched path
    # delegates to the inner env's batched step
    def reset_vec(self, generator: torch.Generator, num_envs: int):
        obs, inner = self.env.reset_vec(generator, num_envs)
        return obs, self._wrap(inner)

    def step_vec(self, generator: torch.Generator, state: EpisodeStatsState,
                 action: torch.Tensor):
        out = self.env.step_vec(generator, state.env_state, action)
        return self._account(state, out)

    def _account(self, state: EpisodeStatsState, out):
        obs, inner, rew, done, trunc, info = out
        fin = done | trunc
        ret = state.episode_return + rew.to(torch.float32)
        length = state.episode_length + 1
        new_state = EpisodeStatsState(
            elapsed=inner.elapsed,
            env_state=inner,
            episode_return=torch.where(fin, 0.0, ret),
            episode_length=torch.where(fin, 0, length),
            returned_return=torch.where(fin, ret, state.returned_return),
            returned_length=torch.where(fin, length, state.returned_length),
        )
        info = dict(info)
        info["episode_return"] = new_state.returned_return
        info["episode_length"] = new_state.returned_length
        info["episode_done"] = fin
        return obs, new_state, rew, done, trunc, info

    def observe(self, state: EpisodeStatsState) -> torch.Tensor:
        return self.env.observe(state.env_state)

    def observe_vec(self, state: EpisodeStatsState) -> torch.Tensor:
        return self.env.observe_vec(state.env_state)
