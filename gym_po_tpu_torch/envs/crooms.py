"""Vectorizable C-ROOMS (continuous rooms), PyTorch port of
:mod:`gym_po_tpu.envs.crooms`.

Re-expresses the reference ``CRoomsEnv`` (reference
``gym_po/envs/rooms/crooms.py:91-338``): continuous (y, x) coordinates over
the same 12 layouts, optional velocity dynamics, wall hits resolved by
resampling within the current cell.  The dynamics keep the JAX package's
deterministic stages (``effective_action``, ``propose``, ``resolve``,
``apply_reset``, ``observe``), which take every draw as an argument;
``step_env`` / ``step_vec`` compose them with draws from an explicit
``torch.Generator``.  The stages keep their input's float dtype: float32 by
default, float64 for the JAX package's parity mode.

Replicated reference quirks (documented, numerics preserved):

* Random spawns and the fixed *goal* spawn convert cell -> coordinate with the
  default ``cell_size=1.0`` even when the env's ``cell_size`` differs; only the
  fixed *agent* spawn passes ``cell_size`` (reference crooms.py:222-244).
* Wall-hit resample noise has fixed scale 0.5 regardless of ``cell_size``
  (reference crooms.py:324).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Box, Discrete, Environment, EnvState
from ..core.env import _stack, _unstack
from ..maps.layouts import LAYOUT_NAMES, layout_end, layout_grid, layout_start
from ..obs.observations import make_rooms_obs
from ..utils.actions import (
    ACTIONS_CARDINAL,
    ACTIONS_ORDINAL,
    failure_cumsum,
    make_exec_action,
)
from ..utils.numerics import sqrt_rn

__all__ = ["CRooms", "CRoomsState", "MAX_VELOCITY", "grid_to_coord_np"]

MAX_VELOCITY = 5.0  # reference crooms.py:169


def grid_to_coord_np(cell_yx: np.ndarray, cell_size: float = 1.0) -> np.ndarray:
    """Cell index -> cell-center coordinate (reference rooms/utils.py:7-12)."""
    return (cell_yx * cell_size) + (cell_size / 2)


@dataclasses.dataclass(frozen=True)
class CRoomsState(EnvState):
    agent_yx: torch.Tensor  # float [..., 2]
    goal_yx: torch.Tensor  # float [..., 2]
    vel_yx: torch.Tensor  # float [..., 2]


class CRooms(Environment[CRoomsState]):
    """Continuous ROOMS domain.

    Args mirror the JAX package's constructor (reference crooms.py:104-153
    minus ``num_envs``/``render_mode``), plus ``device`` (the card by
    default; pass ``"cpu"`` for the CPU).  Defaults preserved: layout '4',
    500-step limit, no velocity, cell_size 1.0, 'mdp' obs, 0.2 action
    failure, 'yx' continuous actions, action noise std 0.2, power 1.0, fixed
    goal at the layout end, random agent, rewards (0, 0, 1), goal threshold
    0.5.
    """

    def __init__(
        self,
        layout: str = "4",
        time_limit: int = 500,
        use_velocity: bool = False,
        cell_size: float = 1.0,
        obs_type: str = "mdp",
        obs_m: int = 3,
        action_failure_probability: float = 0.2,
        action_type: str = "yx",
        action_std: float = 0.2,
        action_power: float = 1.0,
        agent_xy: Optional[Sequence[int]] = None,
        goal_xy: Optional[Sequence[int]] = (0, 0),
        step_reward: float = 0.0,
        wall_reward: float = 0.0,
        goal_reward: float = 1.0,
        goal_threshold: float = 0.5,
        device: Any = "cuda",
        **kwargs,
    ):
        if layout not in LAYOUT_NAMES:
            raise ValueError(f"unknown layout {layout!r}; one of {LAYOUT_NAMES}")
        self.name = f"CRooms__{layout}__{action_type}__{obs_type}"
        self.layout = layout
        self.device = torch.device(device)
        grid = layout_grid(layout)
        self.grid_np = grid
        self.gridshape = np.asarray(grid.shape, np.int64)
        self.time_limit = int(time_limit)
        self.use_velocity = bool(use_velocity)
        self.cell_size = float(cell_size)
        self.action_type = action_type
        self.action_std = float(action_std)
        self.action_power = float(action_power)
        self.step_reward = float(step_reward)
        self.wall_reward = float(wall_reward)
        self.goal_reward = float(goal_reward)
        self.goal_threshold = float(goal_threshold)
        self._grid_flat = torch.as_tensor(grid.reshape(-1), dtype=torch.int32,
                                          device=self.device)
        self._W = grid.shape[1]
        self._rewards = torch.tensor(
            [self.goal_reward, self.wall_reward, self.step_reward],
            dtype=torch.float32, device=self.device)
        # position clip ceiling (reference crooms.py:312-314), float64 on the
        # host, cast once to the stage's dtype
        self._pos_hi = self.gridshape.astype(np.float64) - 1 - 1e-6

        if action_type == "yx":
            self._action_space = Box(-1.0, 1.0, (2,), dtype=torch.float32)
            self.num_actions = None
            self._disp = self._cum = self._exec = None
        else:
            actions = (ACTIONS_CARDINAL if action_type == "cardinal"
                       else ACTIONS_ORDINAL)
            self.num_actions = actions.shape[0]
            self._disp = torch.as_tensor(actions, dtype=torch.float32,
                                         device=self.device)
            self._disp_np = np.asarray(actions, np.int64)
            self._cum = failure_cumsum(self.num_actions, action_failure_probability)
            self._exec = make_exec_action(self._cum, self.device)
            self._action_space = Discrete(self.num_actions)

        # 'vel' in obs_type appends the velocity to any vector obs: the
        # reference declares it but never implements it (reference
        # crooms.py:131); the parameter is ``obs_m`` as in the reference
        self.obs_includes_velocity = "vel" in obs_type.replace("velocity", "vel")
        base = obs_type.replace("velocity", "").replace("vel", "").strip("_")
        self.base_obs_type = base or "mdp"
        self.obs_m = obs_m
        self._observation_space, self._obs_fn = make_rooms_obs(
            self.base_obs_type, grid, obs_m, cell_size=self.cell_size,
            device=self.device)
        if self.obs_includes_velocity:
            sp = self._observation_space
            if not isinstance(sp, Box) or len(sp.shape) != 1:
                raise NotImplementedError(
                    "'vel' obs flag requires a 1-D vector obs_type")
            self._observation_space = Box(
                np.concatenate([sp.low_arr, [-MAX_VELOCITY, -MAX_VELOCITY]]),
                np.concatenate([sp.high_arr, [MAX_VELOCITY, MAX_VELOCITY]]),
                (sp.shape[0] + 2,), dtype=sp.dtype)

        self.valid_states = np.flatnonzero(grid >= 0)
        valid_yx = np.stack(np.unravel_index(self.valid_states, grid.shape), -1)
        # random spawn: cell center with implicit cell_size=1.0 (quirk above)
        self._valid_coord = torch.as_tensor(grid_to_coord_np(valid_yx, 1.0),
                                            device=self.device)

        # fixed spawns (reference crooms.py:216-244); STARTS/ENDS are (x, y)
        self.fixed_goal_coord: Optional[np.ndarray] = None
        if goal_xy is not None:
            yx = tuple(reversed(goal_xy))
            if grid[yx] < 0:
                yx = tuple(reversed(layout_end(layout)))
            self.fixed_goal_coord = grid_to_coord_np(np.asarray(yx, np.int64), 1.0)
        self.fixed_agent_coord: Optional[np.ndarray] = None
        if agent_xy is not None:
            yx = tuple(reversed(agent_xy))
            if grid[yx] < 0:
                yx = tuple(reversed(layout_start(layout)))
            self.fixed_agent_coord = grid_to_coord_np(np.asarray(yx, np.int64),
                                                      self.cell_size)

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self):
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def _cell(self, coord: torch.Tensor) -> torch.Tensor:
        """coord -> cell index (reference rooms/utils.py:15-20)."""
        return torch.floor(coord / self.cell_size).to(torch.int32)

    def _wall_at(self, coord: torch.Tensor) -> torch.Tensor:
        """A flat cell outside the grid reads 0, not a wall, as the JAX
        package's one-hot lookup reads it."""
        c = self._cell(coord)
        i = (c[..., 0] * self._W + c[..., 1]).long()
        n = self._grid_flat.numel()
        inside = (i >= 0) & (i < n)
        return inside & (self._grid_flat[i.clamp(0, n - 1)] == -1)

    def effective_action(self, action: torch.Tensor, u: Optional[torch.Tensor],
                         noise: torch.Tensor) -> torch.Tensor:
        """Stage 0: the effective action from uniform ``u`` (discrete action
        types) and standard normals ``noise [..., 2]`` (reference
        crooms.py:171-198).  'yx': ``(action + noise·std)·power``; discrete:
        the executed action's displacement, ``+ noise·std`` when std > 0,
        ``·power``."""
        if self.action_type == "yx":
            return (action + noise * self.action_std) * self.action_power
        disp = self._disp[self._exec(action, u).long()]
        if self.action_std:
            disp = disp + noise.to(disp.dtype) * self.action_std
        return disp * self.action_power

    def propose(self, state: CRoomsState, a_eff: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stage A: proposed position from the effective action.

        Velocity integration + grid clip + wall test
        (reference crooms.py:300-315).  Returns (proposed, vel_new, oob).
        """
        dt = state.agent_yx.dtype
        if self.use_velocity:
            vel = torch.clamp(state.vel_yx + a_eff, -MAX_VELOCITY, MAX_VELOCITY)
            proposed = state.agent_yx + vel
        else:
            vel = state.vel_yx
            proposed = state.agent_yx + a_eff
        hi = torch.as_tensor(self._pos_hi, dtype=dt, device=proposed.device)
        proposed = torch.minimum(torch.clamp(proposed, min=0), hi)
        return proposed, vel, self._wall_at(proposed)

    def resolve(self, state: CRoomsState, proposed: torch.Tensor,
                vel_new: torch.Tensor, oob: torch.Tensor,
                cell_noise: torch.Tensor):
        """Stage B: commit movement, wall resample, rewards.

        ``cell_noise`` is the N(0, 0.5) draw used only when ``oob``
        (reference crooms.py:316-330).  Returns (mid_state, rew, done, trunc).
        """
        dt = state.agent_yx.dtype
        elapsed = state.elapsed + 1
        cs = self.cell_size
        center = self._cell(state.agent_yx).to(dt) * cs + cs / 2
        # upper bound: the reference uses boundary - 1e-8 (crooms.py:327).
        # In float32 that margin underflows (cell+1-1e-8 rounds to cell+1),
        # so also clamp one ULP below the boundary; in float64
        # nextafter(boundary) > boundary-1e-8 and the minimum is a no-op.
        boundary = center + cs / 2
        hi = torch.minimum(boundary - 1e-8,
                           torch.nextafter(boundary, torch.zeros_like(boundary)))
        resampled = torch.minimum(torch.maximum(center + cell_noise,
                                                center - cs / 2), hi)
        m = oob[..., None]
        agent = torch.where(m, resampled, proposed)
        vel = torch.where(m, torch.zeros_like(vel_new), vel_new)
        diff = agent - state.goal_yx
        done = sqrt_rn((diff * diff).sum(-1)) <= self.goal_threshold
        r_goal, r_wall, r_step = self._rewards.to(done.device)
        rew = torch.where(done, r_goal, torch.where(oob, r_wall, r_step))
        trunc = elapsed > self.time_limit
        mid = state.replace(agent_yx=agent, vel_yx=vel, elapsed=elapsed)
        return mid, rew, done, trunc

    def apply_reset(self, state: CRoomsState, mask: torch.Tensor,
                    goal_new: torch.Tensor, agent_new: torch.Tensor) -> CRoomsState:
        """Masked partial reset, zero velocity (reference crooms.py:268-274)."""
        m = mask[..., None]
        return state.replace(
            agent_yx=torch.where(m, agent_new, state.agent_yx),
            goal_yx=torch.where(m, goal_new, state.goal_yx),
            vel_yx=torch.where(m, torch.zeros_like(state.vel_yx), state.vel_yx),
            elapsed=torch.where(mask, 0, state.elapsed),
        )

    def observe(self, state: CRoomsState) -> torch.Tensor:
        base = self._obs_fn(state.agent_yx, state.goal_yx)
        if self.obs_includes_velocity:
            return torch.cat([base.to(torch.float32),
                              state.vel_yx.to(torch.float32)], -1)
        return base

    def observe_vec(self, state: CRoomsState) -> torch.Tensor:
        return self.observe(state)  # written over any leading axes

    # ------------------------------------------------------- random sampling
    def _sample_spawn_vec(self, generator: torch.Generator, num: int, fixed,
                          dtype=torch.float32) -> torch.Tensor:
        """``[num, 2]`` spawn coordinates: the fixed one, or a uniform
        walkable cell's center (one draw of ``num`` from ``generator``)."""
        if fixed is not None:
            return torch.as_tensor(fixed, dtype=dtype,
                                   device=self.device).expand(num, 2).clone()
        idx = torch.randint(0, self._valid_coord.shape[0], (num,),
                            generator=generator, device=self.device)
        return self._valid_coord[idx].to(dtype)

    def sample_effective_action(self, generator: torch.Generator,
                                action: torch.Tensor) -> torch.Tensor:
        """Perf-mode action randomization over any leading shape (reference
        crooms.py:171-198): the uniform (discrete types), then the normals."""
        dev = action.device
        if self.action_type == "yx":
            u, lead, dtype = None, action.shape[:-1], action.dtype
        else:
            u = torch.rand(action.shape, generator=generator, device=dev)
            lead, dtype = action.shape, torch.float32
        noise = torch.randn((*lead, 2), generator=generator, device=dev,
                            dtype=dtype)
        return self.effective_action(action, u, noise)

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator) -> Tuple[torch.Tensor, CRoomsState]:
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _unstack(state, 0)

    def step_env(self, generator: torch.Generator, state: CRoomsState,
                 action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _stack([state]), action[None])
        info = {"terminal_state": _unstack(info["terminal_state"], 0),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _unstack(st, 0), rew[0], done[0], trunc[0], info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, generator: torch.Generator, num_envs: int):
        # goal, then agent: the JAX package's key order (kg, ka)
        goal = self._sample_spawn_vec(generator, num_envs, self.fixed_goal_coord)
        agent = self._sample_spawn_vec(generator, num_envs, self.fixed_agent_coord)
        state = CRoomsState(
            elapsed=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            agent_yx=agent, goal_yx=goal,
            vel_yx=torch.zeros((num_envs, 2), dtype=torch.float32,
                               device=self.device))
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: CRoomsState,
                 action: torch.Tensor):
        """One step of B envs: draws the effective action, the resample
        noise, then the goal and agent respawns, in the JAX package's key
        order (ka, kc, kg, kag)."""
        B = action.shape[0]
        dt = state.agent_yx.dtype
        a_eff = self.sample_effective_action(generator, action)
        proposed, vel_new, oob = self.propose(state, a_eff)
        cell_noise = torch.randn((B, 2), generator=generator, device=self.device,
                                 dtype=dt) * 0.5
        mid, rew, done, trunc = self.resolve(state, proposed, vel_new, oob,
                                             cell_noise)
        reset_mask = done | trunc
        new_state = self.apply_reset(
            mid, reset_mask,
            self._sample_spawn_vec(generator, B, self.fixed_goal_coord, dt),
            self._sample_spawn_vec(generator, B, self.fixed_agent_coord, dt))
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info
