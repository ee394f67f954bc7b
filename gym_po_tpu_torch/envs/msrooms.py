"""Vectorizable Multistory FourRooms, PyTorch port of
:mod:`gym_po_tpu.envs.msrooms`.

S stacked 13x13 FourRooms floors connected by stairs: up-stairs at
NE = (1, 11) on floors 0..S-2, down-stairs at SW = (11, 1) on floors
1..S-1; moving onto a stair teleports to the matching square of the
adjacent floor (reference ``gym_po/envs/rooms/msrooms.py:69-90,419-428``).
The dynamics keep the JAX package's deterministic stages (``exec_action``,
``advance``, ``apply_reset``, ``observe``), which take every draw as an
argument; ``step_env`` / ``step_vec`` compose them with draws from an
explicit ``torch.Generator``.  Lookups are native indexing where the JAX
package routes them through its matrix unit.

The JAX package's documented reference behaviours are kept, so that the two
agree exactly:

* a FIXED ``goal_xyz`` always falls back to the default goal ``END_XYZ``,
  which lands at zyx = (S-1, 7, 9) (reference msrooms.py:341-347);
* RANDOM goals may land on the top floor's stair squares;
* the Hansen alias chain maps every non-wall square to 2, and scalar Hansen
  obs are float32 (the JAX package without x64);
* the 'room' obs_type is not implemented (``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Box, Discrete, Environment, EnvState, Space
from ..utils.actions import (
    ACTIONS_CARDINAL_Z,
    ACTIONS_ORDINAL_Z,
    failure_cumsum,
    make_exec_action,
)

__all__ = [
    "MultistoryFourRooms",
    "MSRoomsState",
    "FR_MAP",
    "build_walk_map",
    "make_msrooms_obs",
]

# cell-type codes (reference msrooms.py:27-34)
WALL, GOAL_CODE, STAIR_DOWN, STAIR_UP = 0, 1, 2, 3
MAX_CODE = 3
UPSTAIRS_NE = (1, 11)  # stair-up square (reference msrooms.py:21-23)
DOWNSTAIRS_SW = (11, 1)  # stair-down square (reference msrooms.py:19-24)
END_XYZ = (9, 7, -1)  # default goal, east hallway top floor (msrooms.py:17)
START_XYZ = (1, 1, 0)  # default agent, NW corner ground floor (msrooms.py:18)


def _four_rooms_map() -> np.ndarray:
    """13x13 FourRooms; 0 = wall, rooms numbered 1-4 clockwise (the
    reference's geometry, msrooms.py:50-66, rebuilt procedurally)."""
    m = np.zeros((13, 13), np.int64)
    m[1:6, 1:6] = 4  # NW room (rows 1-5)
    m[1:7, 7:12] = 1  # NE room (rows 1-6, one row taller than NW)
    m[7:12, 1:6] = 3  # SW room (rows 7-11)
    m[8:12, 7:12] = 2  # SE room (rows 8-11)
    m[3, 6] = 4  # doorway NW <-> NE
    m[6, 2] = 3  # doorway NW <-> SW
    m[7, 9] = 1  # doorway NE <-> SE
    m[10, 6] = 2  # doorway SW <-> SE
    return m


FR_MAP = _four_rooms_map()


def build_walk_map(floor_map: np.ndarray = FR_MAP, num_floors: int = 1) -> np.ndarray:
    """Stack S floors and plant stairs (reference msrooms.py:69-90)."""
    walk = (floor_map > 0).astype(np.int64)
    ms = np.stack([walk] * num_floors, 0)
    if num_floors > 1:
        ms[1:, DOWNSTAIRS_SW[0], DOWNSTAIRS_SW[1]] = STAIR_DOWN
        ms[:-1, UPSTAIRS_NE[0], UPSTAIRS_NE[1]] = STAIR_UP
    return ms


def make_msrooms_obs(
    obs_type: str, grid: np.ndarray, device=None
) -> Tuple[Space, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """Obs factory for the multistory walk map (reference msrooms.py:192-254).

    ``obs_fn(agent_zyx, goal_zyx)`` is written over any leading batch axes
    (``[..., 3]`` int coordinates in).  A lookup outside the grid reads 0,
    as the JAX package's one-hot ``table_gather`` reads it.
    """
    is_vector = "vector" in obs_type
    has_goal = "goal" in obs_type
    HW, GW = grid.shape[1] * grid.shape[2], grid.shape[2]

    def lookup(table, zyx):
        i = (zyx[..., 0] * HW + zyx[..., 1] * GW + zyx[..., 2]).long()
        inside = (i >= 0) & (i < table.numel())
        return torch.where(inside, table[i.clamp(0, table.numel() - 1)], 0)

    grid_flat = torch.as_tensor(grid.reshape(-1), dtype=torch.int32, device=device)
    a_max = np.asarray(grid.shape, np.int64) - 2
    a_max[0] += 1
    a_min = np.array([0, 1, 1], np.int64)

    if "mdp" in obs_type:
        if is_vector:
            if has_goal:
                space = Box(np.tile(a_min, 2), np.tile(a_max, 2), (6,),
                            dtype=torch.int32)

                def obs(agent, goal):
                    return torch.cat((agent, goal), -1).to(torch.int32)
            else:
                space = Box(a_min, a_max, (3,), dtype=torch.int32)

                def obs(agent, goal):
                    return agent.to(torch.int32)
        else:
            # dense ids over all non-wall cells incl. stairs (msrooms.py:226)
            sg_np = ((grid - 1) >= 0).cumsum().reshape(grid.shape) - 1
            n = int((grid > 0).sum())
            sg_flat = torch.as_tensor(sg_np.reshape(-1), dtype=torch.int32,
                                      device=device)
            if has_goal:
                space = Discrete(int(n**2))

                def obs(agent, goal):
                    return lookup(sg_flat, agent) + n * lookup(sg_flat, goal)
            else:
                space = Discrete(int(n))

                def obs(agent, goal):
                    return lookup(sg_flat, agent)
    elif "hansen" in obs_type:
        base_n = 8 if "8" in obs_type else 4
        offs = torch.as_tensor(
            ACTIONS_CARDINAL_Z if base_n == 4 else ACTIONS_ORDINAL_Z,
            dtype=torch.int32, device=device)

        def neighbor_codes(agent, goal):
            nb = agent[..., None, :] + offs  # [..., k, 3]
            # alias chain (msrooms.py:154-155): every non-wall square -> 2
            sq = torch.where(lookup(grid_flat, nb) > 0, 2, 0).to(torch.int32)
            is_goal = (nb == goal[..., None, :]).all(-1)
            return sq, is_goal

        if is_vector:
            space = Box(0, 3 if has_goal else 2, (base_n,), dtype=torch.int32)
            if has_goal:
                def obs(agent, goal):
                    sq, is_goal = neighbor_codes(agent, goal)
                    return torch.where(is_goal, 3, sq).to(torch.int32)
            else:
                def obs(agent, goal):
                    return neighbor_codes(agent, goal)[0]
        else:
            space = Discrete(int(3**base_n * (base_n + 1)))
            mult = torch.as_tensor([3**i for i in range(base_n)],
                                   dtype=torch.int32, device=device)

            def obs(agent, goal):
                sq, is_goal = neighbor_codes(agent, goal)
                code = (sq * mult).sum(-1)
                # first goal neighbour + 1, or 1 without one
                goal_mult = torch.where(
                    is_goal.any(-1), is_goal.to(torch.int32).argmax(-1) + 1, 1)
                # float, as in the reference (msrooms.py:180,189); f32 as in
                # the JAX package without x64
                return (code * goal_mult).to(torch.float32)
    else:
        raise NotImplementedError(
            f"Observation type {obs_type!r} not supported for MultistoryFourRooms "
            "('room' is broken in the reference, see module docstring)"
        )
    return space, obs


@dataclasses.dataclass(frozen=True)
class MSRoomsState(EnvState):
    agent_zyx: torch.Tensor  # int32 [..., 3]
    goal_zyx: torch.Tensor  # int32 [..., 3]


class MultistoryFourRooms(Environment[MSRoomsState]):
    """Multistory FourRooms (reference msrooms.py:257-433).

    Args mirror the JAX package's constructor plus ``device`` (the card by
    default; pass ``"cpu"`` for the CPU).  Defaults preserved: 1 floor,
    500-step limit, 'mdp' obs, 1/3 action failure, cardinal actions, fixed
    top-floor goal, random ground-floor agent spawn, rewards (0, 0, 1).
    """

    def __init__(
        self,
        grid_z: int = 1,
        floor_map: np.ndarray = FR_MAP,
        time_limit: int = 500,
        obs_type: str = "mdp",
        obs_n: int = 3,
        action_failure_probability: float = 1.0 / 3,
        action_type: str = "cardinal",
        agent_xyz: Optional[Sequence[int]] = None,
        goal_xyz: Optional[Sequence[int]] = END_XYZ,
        step_reward: float = 0.0,
        wall_reward: float = 0.0,
        goal_reward: float = 1.0,
        device: Any = "cuda",
        **kwargs,
    ):
        self.name = f"MultistoryFourRooms{grid_z}__{action_type}__{obs_type}"
        self.device = torch.device(device)
        grid = build_walk_map(floor_map, grid_z)
        self.grid_np = grid
        self.gridshape = np.asarray(grid.shape, np.int64)
        self.time_limit = int(time_limit)
        self.step_reward = float(step_reward)
        self.wall_reward = float(wall_reward)
        self.goal_reward = float(goal_reward)

        def dev(x, dtype=torch.int32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        self._grid_flat = dev(grid.reshape(-1))
        self._HW = grid.shape[1] * grid.shape[2]
        self._W3 = grid.shape[2]
        actions = ACTIONS_CARDINAL_Z if action_type == "cardinal" else ACTIONS_ORDINAL_Z
        self.actions_np = actions
        self._actions = dev(actions)
        self.num_actions = actions.shape[0]
        self._cum = failure_cumsum(self.num_actions, action_failure_probability)
        self._exec = make_exec_action(self._cum, self.device)

        self._observation_space, self._obs_fn = make_msrooms_obs(
            obs_type, grid, device=self.device)
        self._action_space = Discrete(self.num_actions)

        # spawn banks (reference msrooms.py:314-321): flat cells of the
        # ground floor for the agent, of the top floor for the goal
        spawn_vs = np.array(np.nonzero(grid > WALL))  # [3, N]
        self.valid_agent_states = np.ravel_multi_index(
            spawn_vs[:, spawn_vs[0] == 0], grid.shape)
        self.valid_goal_states = np.ravel_multi_index(
            spawn_vs[:, spawn_vs[0] == grid.shape[0] - 1], grid.shape)
        self._valid_agent_zyx = dev(np.stack(
            np.unravel_index(self.valid_agent_states, grid.shape), -1))
        self._valid_goal_zyx = dev(np.stack(
            np.unravel_index(self.valid_goal_states, grid.shape), -1))
        self._rewards = dev(
            [self.goal_reward, self.wall_reward, self.step_reward], torch.float32)

        # fixed spawns (reference msrooms.py:340-364)
        self.fixed_goal_zyx: Optional[np.ndarray] = None
        if goal_xyz is not None:
            # grid values never exceed MAX_CODE, so the reference's stair
            # guard ALWAYS falls back to END_XYZ (see module docstring)
            zyx = np.asarray(tuple(reversed(END_XYZ)), np.int64)
            if zyx[0] == -1:
                zyx[0] = grid.shape[0] - 1
            self.fixed_goal_zyx = zyx
        self.fixed_agent_zyx: Optional[np.ndarray] = None
        if agent_xyz is not None:
            zyx = tuple(reversed(agent_xyz))
            if grid[zyx] == WALL:
                zyx = tuple(reversed(START_XYZ))
            self.fixed_agent_zyx = np.asarray(zyx, np.int64)

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def _cell(self, zyx: torch.Tensor) -> torch.Tensor:
        return self._grid_flat[
            (zyx[..., 0] * self._HW + zyx[..., 1] * self._W3 + zyx[..., 2]).long()]

    def exec_action(self, action: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Stochastic action failure given uniform u (reference msrooms.py:400)."""
        return self._exec(action, u)

    def advance(
        self, state: MSRoomsState, executed: torch.Tensor
    ) -> Tuple[MSRoomsState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Move + stair transit + reward (reference msrooms.py:398-413)."""
        elapsed = state.elapsed + 1
        proposed = state.agent_zyx + self._actions[executed.long()]
        oob = self._cell(proposed) == WALL
        agent = torch.where(oob[..., None], state.agent_zyx, proposed)
        # stair transit only when the agent moved (reference :419-428)
        acell = self._cell(agent)
        go_up = ((acell == STAIR_UP) & ~oob)[..., None]
        go_down = ((acell == STAIR_DOWN) & ~oob)[..., None]
        z = agent[..., :1]
        up_pos = torch.cat([z + 1, torch.as_tensor(
            DOWNSTAIRS_SW, dtype=agent.dtype, device=agent.device).expand_as(
                agent[..., 1:])], -1)
        down_pos = torch.cat([z - 1, torch.as_tensor(
            UPSTAIRS_NE, dtype=agent.dtype, device=agent.device).expand_as(
                agent[..., 1:])], -1)
        agent = torch.where(go_up, up_pos, torch.where(go_down, down_pos, agent))
        done = (agent == state.goal_zyx).all(-1)
        r_goal, r_wall, r_step = self._rewards
        rew = torch.where(done, r_goal, torch.where(oob, r_wall, r_step))
        trunc = elapsed > self.time_limit
        return state.replace(agent_zyx=agent, elapsed=elapsed), rew, done, trunc

    def apply_reset(self, state: MSRoomsState, mask: torch.Tensor,
                    goal_new: torch.Tensor, agent_new: torch.Tensor) -> MSRoomsState:
        """Masked partial reset (reference msrooms.py:383-388)."""
        m = mask[..., None]
        return state.replace(
            agent_zyx=torch.where(m, agent_new, state.agent_zyx),
            goal_zyx=torch.where(m, goal_new, state.goal_zyx),
            elapsed=torch.where(mask, 0, state.elapsed),
        )

    def observe(self, state: MSRoomsState) -> torch.Tensor:
        return self._obs_fn(state.agent_zyx, state.goal_zyx)

    def observe_vec(self, state: MSRoomsState) -> torch.Tensor:
        return self.observe(state)  # written over any leading axes

    # ------------------------------------------------------- random sampling
    def _sample_spawn_vec(self, generator: torch.Generator, num: int, fixed,
                          bank: torch.Tensor) -> torch.Tensor:
        """``[num, 3]`` spawn cells: the fixed one, or uniform over ``bank``
        (one draw of ``num`` from ``generator``)."""
        if fixed is not None:
            return torch.as_tensor(fixed, dtype=torch.int32,
                                   device=self.device).expand(num, 3).clone()
        idx = torch.randint(0, bank.shape[0], (num,), generator=generator,
                            device=self.device)
        return bank[idx]

    def sample_goal(self, generator: torch.Generator) -> torch.Tensor:
        return self._sample_spawn_vec(generator, 1, self.fixed_goal_zyx,
                                      self._valid_goal_zyx)[0]

    def sample_agent(self, generator: torch.Generator) -> torch.Tensor:
        return self._sample_spawn_vec(generator, 1, self.fixed_agent_zyx,
                                      self._valid_agent_zyx)[0]

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator):
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _first(state)

    def step_env(self, generator: torch.Generator, state: MSRoomsState,
                 action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _batch1(state), action.reshape(1))
        info = {"terminal_state": _first(info["terminal_state"]),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _first(st), rew[0], done[0], trunc[0], info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, generator: torch.Generator, num_envs: int):
        # goal, then agent: the JAX package's key order (kg, ka)
        goal = self._sample_spawn_vec(generator, num_envs, self.fixed_goal_zyx,
                                      self._valid_goal_zyx)
        agent = self._sample_spawn_vec(generator, num_envs,
                                       self.fixed_agent_zyx, self._valid_agent_zyx)
        state = MSRoomsState(
            elapsed=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            agent_zyx=agent, goal_zyx=goal)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: MSRoomsState,
                 action: torch.Tensor):
        B = action.shape[0]
        u = torch.rand(B, generator=generator, device=self.device)
        executed = self.exec_action(action, u)
        mid, rew, done, trunc = self.advance(state, executed)
        reset_mask = done | trunc
        new_state = self.apply_reset(
            mid, reset_mask,
            self._sample_spawn_vec(generator, B, self.fixed_goal_zyx,
                                   self._valid_goal_zyx),
            self._sample_spawn_vec(generator, B, self.fixed_agent_zyx,
                                   self._valid_agent_zyx))
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info


def _first(state: MSRoomsState) -> MSRoomsState:
    return MSRoomsState(elapsed=state.elapsed[0], agent_zyx=state.agent_zyx[0],
                        goal_zyx=state.goal_zyx[0])


def _batch1(state: MSRoomsState) -> MSRoomsState:
    return MSRoomsState(elapsed=state.elapsed.reshape(1),
                        agent_zyx=state.agent_zyx.reshape(1, 3),
                        goal_zyx=state.goal_zyx.reshape(1, 3))
