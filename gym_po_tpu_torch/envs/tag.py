"""TagContinuous / HeavenHellContinuous, the point-mass ant POMDP tasks:
PyTorch port of :mod:`gym_po_tpu.envs.tag_jax`.

The reference's AntTag/AntHeavenHell couple a MuJoCo ant body with a POMDP
task layer (a visibility-limited fleeing target; a priest-revealed heaven).
These envs keep every task constant from the reference (cage, visibility and
tag radii, the target's flee rule, the heaven/hell/priest geometry, terminal
rewards — reference ``ant_tag.py:27-158``, ``ant_heaven_hell.py:29-137``) and
replace the ant body with a velocity-clamped point mass, as the JAX package
does.

* **TagContinuous**: closed ±4.5 cage.  The agent moves by a clipped [2]
  force at 0.25 per step.  The target moves 0.5 per step {away, two
  orthogonals, stay} uniformly, cancelled at the cage edge.  Obs = own xy +
  target xy if within the visible radius else zeros + a visibility flag.
  A tag within 1.5 gives +1 and ends the episode.  The target spawns >= 5.0
  from the agent: the first of 8 uniform candidates that is, else the
  farthest cage corner (always >= 6.3 away).
* **HeavenHellContinuous**: T-maze free space = stem ∪ bar rectangles; moves
  leaving it are cancelled.  Heaven/hell at (±6.25, 6.0), priest at
  (0, 6.0), radius 2.0; obs = own xy + the heaven side iff within the
  priest's radius.  Reaching heaven or hell gives ±1 and ends the episode.

The dynamics are deterministic stages that take every draw as an argument
(``move_target`` takes the flee mode, ``spawn_target`` the 8 candidates,
``spawn_xy`` the uniforms); ``step_vec`` composes them with draws from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..core import Box, Environment, EnvState
from ..core.env import _stack, _unstack
from ..utils.numerics import sqrt_rn

__all__ = [
    "TagContinuous",
    "TagState",
    "HeavenHellContinuous",
    "HeavenHellState",
    "CAGE",
    "VISIBLE_RADIUS",
    "TAG_RADIUS",
    "MIN_SPAWN_DIST",
    "TARGET_STEP",
    "AGENT_SPEED",
    "HH_SITES",
    "HH_RADIUS",
    "STEM",
    "BAR",
]

# ------------------------------------------------------------------ tag
CAGE = 4.5
VISIBLE_RADIUS = 3.0
TAG_RADIUS = 1.5
MIN_SPAWN_DIST = 5.0
TARGET_STEP = 0.5
AGENT_SPEED = 0.25
CORNERS = np.array([[-CAGE, -CAGE], [-CAGE, CAGE], [CAGE, -CAGE], [CAGE, CAGE]],
                   np.float32)


@dataclasses.dataclass(frozen=True)
class TagState(EnvState):
    agent_xy: torch.Tensor  # f32 [..., 2]
    target_xy: torch.Tensor  # f32 [..., 2]


def _sq(x: torch.Tensor) -> torch.Tensor:
    return x * x


class TagContinuous(Environment[TagState]):
    """Point-mass tag POMDP (task constants from reference ant_tag.py).

    ``visible_radius``: target visibility cutoff (reference ant_tag.py:77-86
    uses 3.0); smaller values deepen the partial observability.  ``device``:
    the card by default; pass ``"cpu"`` for the CPU."""

    def __init__(self, time_limit: int = 500, agent_speed: float = AGENT_SPEED,
                 visible_radius: float = VISIBLE_RADIUS, device: Any = "cuda"):
        self.name = "TagContinuous-v0"
        self.time_limit = int(time_limit)
        self.agent_speed = float(agent_speed)
        self.visible_radius = float(visible_radius)
        self.device = torch.device(device)
        self._action_space = Box(-1.0, 1.0, (2,), dtype=torch.float32)
        hi = np.array([CAGE, CAGE, CAGE, CAGE, 1.0], np.float32)
        self._observation_space = Box(-hi, hi, (5,), dtype=torch.float32)
        self._corners = torch.as_tensor(CORNERS, device=self.device)

    @property
    def action_space(self) -> Box:
        return self._action_space

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    # ------------------------------------------------ deterministic stages
    def move_agent(self, agent: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        force = torch.clamp(action, -1.0, 1.0)
        return torch.clamp(agent + force * self.agent_speed, -CAGE, CAGE)

    def move_target(self, agent: torch.Tensor, target: torch.Tensor,
                    mode: torch.Tensor) -> torch.Tensor:
        """Reference ant_tag.py:105-123 with a zero-distance guard; ``mode``
        in {0 away, 1 and 2 the orthogonals, 3 stay}."""
        away = target - agent  # flee direction = -(agent - target)
        nrm = sqrt_rn(_sq(away).sum(-1, keepdim=True))
        away = torch.where(nrm > 1e-9, away / torch.clamp(nrm, min=1e-9), 0.0)
        ortho1 = torch.stack([-away[..., 1], away[..., 0]], -1)
        m = mode[..., None]
        step = torch.where(m == 0, away, torch.where(
            m == 1, ortho1, torch.where(m == 2, -ortho1, 0.0)))
        new = target + step * TARGET_STEP
        return torch.where((new.abs() > CAGE).any(-1, keepdim=True), target, new)

    def advance(self, state: TagState, action: torch.Tensor, mode: torch.Tensor):
        """The agent's move, the target's flee, the tag test and the time
        limit; returns ``(mid_state, rew, done, trunc)``."""
        agent = self.move_agent(state.agent_xy, action)
        target = self.move_target(agent, state.target_xy, mode)
        done = _sq(agent - target).sum(-1) <= TAG_RADIUS**2
        elapsed = state.elapsed + 1
        trunc = elapsed >= self.time_limit
        mid = TagState(elapsed=elapsed, agent_xy=agent, target_xy=target)
        return mid, done.to(torch.float32), done, trunc

    def spawn_target(self, agent: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
        """The first of the candidates ``[..., 8, 2]`` at least
        ``MIN_SPAWN_DIST`` from ``agent [..., 2]``, else the farthest cage
        corner (reference ant_tag.py:88-103)."""
        ok = _sq(cands - agent[..., None, :]).sum(-1) >= MIN_SPAWN_DIST**2
        cd = _sq(self._corners.to(agent.device) - agent[..., None, :]).sum(-1)
        far = self._corners.to(agent.device)[cd.argmax(-1)]
        idx = ok.to(torch.int32).argmax(-1)  # the first True
        picked = torch.gather(cands, -2, idx[..., None, None].expand(
            *idx.shape, 1, 2).long())[..., 0, :]
        return torch.where(ok.any(-1, keepdim=True), picked, far)

    def apply_reset(self, state: TagState, mask: torch.Tensor,
                    agent_new: torch.Tensor, target_new: torch.Tensor) -> TagState:
        m = mask[..., None]
        return TagState(elapsed=torch.where(mask, 0, state.elapsed),
                        agent_xy=torch.where(m, agent_new, state.agent_xy),
                        target_xy=torch.where(m, target_new, state.target_xy))

    def observe(self, state: TagState) -> torch.Tensor:
        visible = _sq(state.agent_xy - state.target_xy).sum(-1) \
            < self.visible_radius**2
        tgt = torch.where(visible[..., None], state.target_xy, 0.0)
        return torch.cat([state.agent_xy, tgt,
                          visible[..., None].to(torch.float32)], -1)

    def observe_vec(self, state: TagState) -> torch.Tensor:
        return self.observe(state)  # written over any leading axes

    # ------------------------------------------------------- random sampling
    def _sample_spawn_vec(self, generator: torch.Generator, num: int):
        """Agents uniform in the cage, then 8 candidates each."""
        dev = self.device
        agent = torch.rand((num, 2), generator=generator, device=dev) \
            * (2 * CAGE) - CAGE
        cands = torch.rand((num, 8, 2), generator=generator, device=dev) \
            * (2 * CAGE) - CAGE
        return agent, self.spawn_target(agent, cands)

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator) -> Tuple[torch.Tensor, TagState]:
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _unstack(state, 0)

    def step_env(self, generator: torch.Generator, state: TagState,
                 action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _stack([state]), action.reshape(1, 2))
        info = {"terminal_state": _unstack(info["terminal_state"], 0),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _unstack(st, 0), rew[0], done[0], trunc[0], info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, generator: torch.Generator, num_envs: int):
        agent, target = self._sample_spawn_vec(generator, num_envs)
        state = TagState(
            elapsed=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            agent_xy=agent, target_xy=target)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: TagState,
                 action: torch.Tensor):
        """One step of B envs: the flee modes, then the respawns, in the JAX
        package's key order (km, kr)."""
        B = action.shape[0]
        mode = torch.randint(0, 4, (B,), generator=generator, device=self.device,
                             dtype=torch.int32)
        mid, rew, done, trunc = self.advance(state, action.reshape(B, 2), mode)
        reset = done | trunc
        new_state = self.apply_reset(mid, reset,
                                     *self._sample_spawn_vec(generator, B))
        info = {"terminal_state": mid, "reset_mask": reset}
        return self.observe(new_state), new_state, rew, done, trunc, info


# ----------------------------------------------------------- heaven/hell
HH_SITES = np.array([[-6.25, 6.0], [6.25, 6.0], [0.0, 6.0]], np.float32)
HH_RADIUS = 2.0
# free space: stem corridor + top bar (the reference's mjcf walls)
STEM = (-2.0, 2.0, -1.5, 4.5)  # x_lo, x_hi, y_lo, y_hi
BAR = (-8.0, 8.0, 4.0, 8.0)


@dataclasses.dataclass(frozen=True)
class HeavenHellState(EnvState):
    agent_xy: torch.Tensor  # f32 [..., 2]
    heaven_right: torch.Tensor  # bool [...]: heaven on the +x side


class HeavenHellContinuous(Environment[HeavenHellState]):
    """Point-mass T-maze POMDP (task constants from reference
    ant_heaven_hell.py).  ``device``: the card by default; pass ``"cpu"``
    for the CPU."""

    def __init__(self, time_limit: int = 500, agent_speed: float = AGENT_SPEED,
                 device: Any = "cuda"):
        self.name = "HeavenHellContinuous-v0"
        self.time_limit = int(time_limit)
        self.agent_speed = float(agent_speed)
        self.device = torch.device(device)
        self._action_space = Box(-1.0, 1.0, (2,), dtype=torch.float32)
        hi = np.array([8.0, 8.0, 1.0], np.float32)
        self._observation_space = Box(-hi, hi, (3,), dtype=torch.float32)
        self._sites = torch.as_tensor(HH_SITES, device=self.device)

    @property
    def action_space(self) -> Box:
        return self._action_space

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    @staticmethod
    def _in_free_space(xy: torch.Tensor) -> torch.Tensor:
        x, y = xy[..., 0], xy[..., 1]
        in_stem = (x >= STEM[0]) & (x <= STEM[1]) & (y >= STEM[2]) & (y <= STEM[3])
        in_bar = (x >= BAR[0]) & (x <= BAR[1]) & (y >= BAR[2]) & (y <= BAR[3])
        return in_stem | in_bar

    def advance(self, state: HeavenHellState, action: torch.Tensor):
        """The clamped move, the heaven/hell test and the time limit;
        returns ``(mid_state, rew, done, trunc)``."""
        force = torch.clamp(action, -1.0, 1.0)
        proposed = state.agent_xy + force * self.agent_speed
        ok = self._in_free_space(proposed)
        agent = torch.where(ok[..., None], proposed, state.agent_xy)
        d2 = _sq(agent[..., None, :] - self._sites.to(agent.device)).sum(-1)
        at_left = d2[..., 0] <= HH_RADIUS**2
        at_right = d2[..., 1] <= HH_RADIUS**2
        done = at_left | at_right
        reached = torch.where(state.heaven_right, at_right, at_left)
        one = torch.ones_like(d2[..., 0])
        rew = torch.where(done, torch.where(reached, one, -one), 0.0)
        elapsed = state.elapsed + 1
        trunc = elapsed >= self.time_limit
        mid = HeavenHellState(elapsed=elapsed, agent_xy=agent,
                              heaven_right=state.heaven_right)
        return mid, rew, done, trunc

    @staticmethod
    def spawn_xy(u: torch.Tensor) -> torch.Tensor:
        """Spawn from uniforms ``u [..., 2]``: x ~ U(-1, 1), y ~ U(0, 1)
        (reference ant_heaven_hell.py:50-75)."""
        # u * (2, 1) + (-1, 0), written without a host tensor so that a
        # CUDA graph can capture it
        return torch.stack([u[..., 0] * 2.0 - 1.0, u[..., 1]], -1)

    def apply_reset(self, state: HeavenHellState, mask: torch.Tensor,
                    xy_new: torch.Tensor, heaven_new: torch.Tensor) -> HeavenHellState:
        return HeavenHellState(
            elapsed=torch.where(mask, 0, state.elapsed),
            agent_xy=torch.where(mask[..., None], xy_new, state.agent_xy),
            heaven_right=torch.where(mask, heaven_new, state.heaven_right))

    def observe(self, state: HeavenHellState) -> torch.Tensor:
        d = state.agent_xy - self._sites[2].to(state.agent_xy.device)
        near_priest = _sq(d).sum(-1) <= HH_RADIUS**2
        one = torch.ones_like(d[..., 0])
        direction = torch.where(
            near_priest, torch.where(state.heaven_right, one, -one), 0.0)
        return torch.cat([state.agent_xy, direction[..., None]], -1)

    def observe_vec(self, state: HeavenHellState) -> torch.Tensor:
        return self.observe(state)

    def _sample_spawn_vec(self, generator: torch.Generator, num: int):
        u = torch.rand((num, 2), generator=generator, device=self.device)
        heaven = torch.rand(num, generator=generator, device=self.device) < 0.5
        return self.spawn_xy(u), heaven

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator):
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _unstack(state, 0)

    def step_env(self, generator: torch.Generator, state: HeavenHellState,
                 action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _stack([state]), action.reshape(1, 2))
        info = {"terminal_state": _unstack(info["terminal_state"], 0),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _unstack(st, 0), rew[0], done[0], trunc[0], info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, generator: torch.Generator, num_envs: int):
        xy, heaven = self._sample_spawn_vec(generator, num_envs)
        state = HeavenHellState(
            elapsed=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            agent_xy=xy, heaven_right=heaven)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: HeavenHellState,
                 action: torch.Tensor):
        B = action.shape[0]
        mid, rew, done, trunc = self.advance(state, action.reshape(B, 2))
        reset = done | trunc
        new_state = self.apply_reset(mid, reset,
                                     *self._sample_spawn_vec(generator, B))
        info = {"terminal_state": mid, "reset_mask": reset}
        return self.observe(new_state), new_state, rew, done, trunc, info
