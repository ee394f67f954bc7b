"""Vectorizable ROOMS (discrete), PyTorch port of :mod:`gym_po_tpu.envs.rooms`.

Re-expresses the reference ``RoomsEnv`` (reference
``gym_po/envs/rooms/rooms.py:71-227``): grid lookups for collision,
cumsum-threshold action failure, masked in-graph autoreset.  The dynamics
keep the JAX package's deterministic stages (``exec_action``, ``advance``,
``apply_reset``, ``observe``), which take every draw as an argument;
``step_env`` / ``step_vec`` compose them with draws from an explicit
``torch.Generator``.  Lookups are native indexing where the JAX package
routes them through its matrix unit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Discrete, Environment, EnvState
from ..maps.layouts import LAYOUT_NAMES, layout_end, layout_grid, layout_start
from ..obs.observations import make_rooms_obs
from ..utils.actions import (
    ACTIONS_CARDINAL,
    ACTIONS_ORDINAL,
    failure_cumsum,
    make_exec_action,
)

__all__ = ["Rooms", "RoomsState"]


@dataclasses.dataclass(frozen=True)
class RoomsState(EnvState):
    agent_yx: torch.Tensor  # int32 [..., 2]
    goal_yx: torch.Tensor  # int32 [..., 2]


class Rooms(Environment[RoomsState]):
    """Discrete ROOMS domain (12 layouts, 1–32 rooms).

    Args mirror the JAX package's constructor (reference rooms.py:84-118
    minus ``num_envs``/``render_mode``), plus ``device`` (the card by
    default; pass ``"cpu"`` for the CPU).  Defaults preserved: layout '4',
    500-step time limit, 'mdp' obs, 0.2 action failure, ordinal actions,
    fixed goal at the layout end, random agent spawn, rewards (0, 0, 1).
    """

    def __init__(
        self,
        layout: str = "4",
        time_limit: int = 500,
        obs_type: str = "mdp",
        obs_n: int = 3,
        action_failure_probability: float = 0.2,
        action_type: str = "ordinal",
        agent_xy: Optional[Sequence[int]] = None,
        goal_xy: Optional[Sequence[int]] = (0, 0),
        step_reward: float = 0.0,
        wall_reward: float = 0.0,
        goal_reward: float = 1.0,
        device: Any = "cuda",
        **kwargs,
    ):
        if layout not in LAYOUT_NAMES:
            raise ValueError(f"unknown layout {layout!r}; one of {LAYOUT_NAMES}")
        self.name = f"Rooms__{layout}__{action_type}__{obs_type}"
        self.layout = layout
        self.device = torch.device(device)
        grid = layout_grid(layout)
        self.grid_np = grid
        self.time_limit = int(time_limit)
        self.step_reward = float(step_reward)
        self.wall_reward = float(wall_reward)
        self.goal_reward = float(goal_reward)

        def dev(x, dtype=torch.int32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        self._grid_flat = dev(grid.reshape(-1))
        self._W = grid.shape[1]
        actions = ACTIONS_CARDINAL if action_type == "cardinal" else ACTIONS_ORDINAL
        self.actions_np = actions
        self._actions = dev(actions)
        self.num_actions = actions.shape[0]
        self._cum = failure_cumsum(self.num_actions, action_failure_probability)
        self._exec = make_exec_action(self._cum, self.device)

        self._observation_space, self._obs_fn = make_rooms_obs(
            obs_type, grid, obs_n, device=self.device)
        self._action_space = Discrete(self.num_actions)

        # Spawn cells: flat indices of walkable cells (reference rooms.py:130-132)
        self.valid_states = np.flatnonzero(grid >= 0)
        valid_yx = np.stack(np.unravel_index(self.valid_states, grid.shape), -1)
        self._valid_yx = dev(valid_yx)
        self._rewards = dev(
            [self.goal_reward, self.wall_reward, self.step_reward], torch.float32)

        # Fixed-vs-random spawn resolution (reference rooms.py:152-172):
        # an invalid fixed coordinate falls back to the layout default.
        # STARTS/ENDS are (x, y) and get reversed (reference rooms.py:156,167).
        self.fixed_goal_yx = self._resolve_fixed(
            goal_xy, tuple(reversed(layout_end(layout))))
        self.fixed_agent_yx = self._resolve_fixed(
            agent_xy, tuple(reversed(layout_start(layout))))

    def _resolve_fixed(self, xy, default_yx) -> Optional[np.ndarray]:
        if xy is None:
            return None
        yx = tuple(reversed(xy))
        if self.grid_np[yx] < 0:
            yx = default_yx
        return np.asarray(yx, np.int64)

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def exec_action(self, action: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Stochastic action failure given uniform u (reference rooms.py:210)."""
        return self._exec(action, u)

    def advance(
        self, state: RoomsState, executed: torch.Tensor
    ) -> Tuple[RoomsState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Deterministic move + reward (reference rooms.py:208-220)."""
        elapsed = state.elapsed + 1
        proposed = state.agent_yx + self._actions[executed.long()]
        oob = self._grid_flat[
            (proposed[..., 0] * self._W + proposed[..., 1]).long()] == -1
        agent = torch.where(oob[..., None], state.agent_yx, proposed)
        done = (agent == state.goal_yx).all(-1)
        r_goal, r_wall, r_step = self._rewards
        rew = torch.where(done, r_goal, torch.where(oob, r_wall, r_step))
        trunc = elapsed > self.time_limit
        return state.replace(agent_yx=agent, elapsed=elapsed), rew, done, trunc

    def apply_reset(self, state: RoomsState, mask: torch.Tensor,
                    goal_new: torch.Tensor, agent_new: torch.Tensor) -> RoomsState:
        """Masked partial reset (reference rooms.py:191-196)."""
        m = mask[..., None]
        return state.replace(
            agent_yx=torch.where(m, agent_new, state.agent_yx),
            goal_yx=torch.where(m, goal_new, state.goal_yx),
            elapsed=torch.where(mask, 0, state.elapsed),
        )

    def observe(self, state: RoomsState) -> torch.Tensor:
        return self._obs_fn(state.agent_yx, state.goal_yx)

    def observe_vec(self, state: RoomsState) -> torch.Tensor:
        return self.observe(state)  # written over any leading axes

    # ------------------------------------------------------- random sampling
    def _sample_spawn_vec(self, generator: torch.Generator, num: int,
                          fixed) -> torch.Tensor:
        """``[num, 2]`` spawn cells: the fixed one, or uniform over the
        walkable cells (one draw of ``num`` from ``generator``)."""
        if fixed is not None:
            return torch.as_tensor(fixed, dtype=torch.int32,
                                   device=self.device).expand(num, 2).clone()
        idx = torch.randint(0, self._valid_yx.shape[0], (num,),
                            generator=generator, device=self.device)
        return self._valid_yx[idx]

    def sample_goal(self, generator: torch.Generator) -> torch.Tensor:
        return self._sample_spawn_vec(generator, 1, self.fixed_goal_yx)[0]

    def sample_agent(self, generator: torch.Generator) -> torch.Tensor:
        return self._sample_spawn_vec(generator, 1, self.fixed_agent_yx)[0]

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator) -> Tuple[torch.Tensor, RoomsState]:
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _first(state)

    def step_env(self, generator: torch.Generator, state: RoomsState,
                 action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _batch1(state), action.reshape(1))
        info = {"terminal_state": _first(info["terminal_state"]),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _first(st), rew[0], done[0], trunc[0], info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, generator: torch.Generator, num_envs: int):
        # goal, then agent: the JAX package's key order (kg, ka)
        goal = self._sample_spawn_vec(generator, num_envs, self.fixed_goal_yx)
        agent = self._sample_spawn_vec(generator, num_envs, self.fixed_agent_yx)
        state = RoomsState(
            elapsed=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            agent_yx=agent, goal_yx=goal)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: RoomsState,
                 action: torch.Tensor):
        B = action.shape[0]
        u = torch.rand(B, generator=generator, device=self.device)
        executed = self.exec_action(action, u)
        mid, rew, done, trunc = self.advance(state, executed)
        reset_mask = done | trunc
        new_state = self.apply_reset(
            mid, reset_mask,
            self._sample_spawn_vec(generator, B, self.fixed_goal_yx),
            self._sample_spawn_vec(generator, B, self.fixed_agent_yx))
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info


def _first(state: RoomsState) -> RoomsState:
    return RoomsState(elapsed=state.elapsed[0], agent_yx=state.agent_yx[0],
                      goal_yx=state.goal_yx[0])


def _batch1(state: RoomsState) -> RoomsState:
    return RoomsState(elapsed=state.elapsed.reshape(1),
                      agent_yx=state.agent_yx.reshape(1, 2),
                      goal_yx=state.goal_yx.reshape(1, 2))
