"""Potential-based reward shaping, PyTorch port of
:mod:`gym_po_tpu.envs.shaping`: the exploration aid for the sparse
±1-terminal POMDPs.

The wrapper adds the Ng-Harada-Russell term

    F(s, s') = γ·Φ(s')·(1 − done) − Φ(s)

to the reward, with ``s'`` the pre-reset successor
(``info["terminal_state"]``).  Φ reads the state, which knows the heaven
side, while the policy still sees only the observation, so shaping speeds
up learning without leaking the bit that a memory has to carry.  The
learners' ``pos/neg_reward_rate`` count rewards of magnitude at least 0.5
only, never the small shaping increments.

The potentials read the point-mass states' ``agent_xy``
(:mod:`gym_po_tpu_torch.envs.tag`) or the articulated ant's torso position
``qpos[..., :2]`` (:mod:`gym_po_tpu_torch.envs.ant_physics`).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import Environment, EnvState, Space
from ..utils.numerics import sqrt_rn

__all__ = ["PotentialShaped", "heaven_hell_potential", "tag_potential"]


def _agent_xy(state: EnvState) -> torch.Tensor:
    """The agent's xy: a point mass's ``agent_xy``, the ant's torso
    ``qpos[..., :2]``."""
    return state.agent_xy if hasattr(state, "agent_xy") else state.qpos[..., :2]


def heaven_hell_potential(coef: float = 0.1) -> Callable[[EnvState], torch.Tensor]:
    """Φ = −coef · (T-maze geodesic distance to the episode's heaven): the
    climb to the bar row (y = 6) plus the walk along the bar to
    (±6.25, 6), the task constants of reference ``ant_heaven_hell.py:29-48``.
    """

    def phi(state: EnvState) -> torch.Tensor:
        xy = _agent_xy(state)
        side = torch.where(state.heaven_right, 1.0, -1.0)
        d = torch.abs(6.0 - xy[..., 1]) + torch.abs(6.25 * side - xy[..., 0])
        return -coef * d

    return phi


def tag_potential(coef: float = 0.1) -> Callable[[EnvState], torch.Tensor]:
    """Φ = −coef · (distance to the fleeing target) for the tag task."""

    def phi(state: EnvState) -> torch.Tensor:
        d = sqrt_rn(((_agent_xy(state) - state.target_xy) ** 2).sum(-1) + 1e-12)
        return -coef * d

    return phi


class PotentialShaped(Environment):
    """Wrap an env with exact PBRS: reward += γ·Φ(s')·(1−done) − Φ(s).

    ``s'`` is the pre-reset successor, so the shaping never reaches across
    an autoreset; Φ(terminal) = 0 by the ``(1 − done)`` factor.  State,
    spaces and observations pass through untouched.

    ``gamma = 1.0`` (the default) is the within-episode telescoping form:
    ΣF = Φ(end) − Φ(start), so loitering pays exactly 0 and progress pays
    ``coef`` per unit.  ``gamma`` = the learner's discount gives exact
    policy invariance, but with a negative Φ it pays ``(1−γ)·|Φ|`` per step
    for loitering far from the goal, and PPO was measured to converge to
    such a loiter policy on heaven-hell (``docs/ARCHITECTURE.md``).
    """

    def __init__(self, env: Environment,
                 potential: Callable[[EnvState], torch.Tensor],
                 gamma: float = 1.0):
        self.env = env
        self.potential = potential
        self.gamma = float(gamma)
        self.name = f"Shaped({env.name})"

    @property
    def device(self) -> torch.device:
        return self.env.device

    @property
    def observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    def _shape(self, prev_state, out):
        obs, nstate, rew, done, trunc, info = out
        mid = info["terminal_state"]
        f = (self.gamma * self.potential(mid)
             * (1.0 - done.to(torch.float32))
             - self.potential(prev_state))
        return obs, nstate, rew + f.to(rew.dtype), done, trunc, info

    def reset_env(self, generator):
        return self.env.reset_env(generator)

    def step_env(self, generator, state, action):
        return self._shape(state, self.env.step_env(generator, state, action))

    def reset_vec(self, generator, num_envs):
        return self.env.reset_vec(generator, num_envs)

    def step_vec(self, generator, state, action):
        return self._shape(state, self.env.step_vec(generator, state, action))

    def observe(self, state):
        return self.env.observe(state)

    def observe_vec(self, state):
        return self.env.observe_vec(state)
