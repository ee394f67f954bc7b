"""The MultistoryFourRooms step that the port's fused MSRooms kernels share,
as a plain twin.

``csrc/msrooms_step.cuh`` holds the device side: the move in flat zyx cells
clipped to ``[0, Z*H*W)``, the wall test on the cell codes {0 wall, 1 room,
2 stair down, 3 stair up}, the stair transit when the agent moved (up lands
at ``(z+1)*HW + SW``, down at ``(z-1)*HW + NE``), the goal test after the
transit, the reward, ``elapsed > time_limit`` truncation, and the respawns
from the ground-floor (agent) and top-floor (goal) banks.
:class:`MSRoomsDynamics` is its plain PyTorch twin, vectorized over ``[B]``,
together with the constants and per-cell tables the kernels take: the
rollout (:mod:`.fused_msrooms`) and the tabular Q trainer
(:mod:`.fused_qlearning`) step through it.

The step draws nothing itself: each kernel draws its failure coin, its
alternative action and its respawns at its own sites, as its JAX kernel
does (the rollout compares ``runiform() < f32(p_fail)``, the trainer
``r24() < int(p_fail * 2**24)``), and hands the results in.  The ROOMS step
(:mod:`.rooms_dynamics`) tests the goal before any transit, so it is not
this one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..envs.msrooms import DOWNSTAIRS_SW, STAIR_DOWN, STAIR_UP, UPSTAIRS_NE, WALL
from .kernel_rng import KernelRNG
from .rooms_dynamics import RoomsDynamics, RoomsMove

__all__ = ["MSRoomsDynamics"]


def _flat(env, zyx) -> int:
    if zyx is None:
        return -1
    _, H, GW = env.grid_np.shape
    return int(zyx[0] * H * GW + zyx[1] * GW + zyx[2])


class MSRoomsDynamics:
    """Constants, per-cell tables on each device, and the twin's step of a
    :class:`~gym_po_tpu_torch.envs.msrooms.MultistoryFourRooms` env, as the
    fused kernels see them.  Cells are flat: ``z * H * W + y * W + x``.

    ``obs_table=True`` adds ``"obs"``, the observation index of every cell
    under the fixed goal, from the env's own observation function, clipped
    to ``[0, n_obs)`` (walls read 0), as the trainer indexes its table by
    it."""

    executed = staticmethod(RoomsDynamics.executed)

    def __init__(self, env, obs_table: bool = False):
        grid = env.grid_np
        self.Z, self.H, self.W = grid.shape
        self.HW = self.H * self.W
        self.ncells = self.Z * self.HW
        self.n_act = int(env.num_actions)
        self.time_limit = int(env.time_limit)
        self.rewards = (env.step_reward, env.wall_reward, env.goal_reward)
        # p = 1 - P(executed = 0 | commanded = 0), in f64 from the cumsum
        self.p_fail = 1.0 - float(env._cum[0][0])
        self.goal = _flat(env, env.fixed_goal_zyx)  # -1: random goal
        self.fixed_agent = _flat(env, env.fixed_agent_zyx)  # -1: random agent
        self.up_to = DOWNSTAIRS_SW[0] * self.W + DOWNSTAIRS_SW[1]
        self.down_to = UPSTAIRS_NE[0] * self.W + UPSTAIRS_NE[1]
        disp = np.asarray(env.actions_np)
        self.host: Dict[str, np.ndarray] = {
            "cell": grid.reshape(-1).astype(np.uint8),
            "agent_bank": np.asarray(env.valid_agent_states, np.int32),
            "goal_bank": np.asarray(env.valid_goal_states, np.int32),
            "disp": (disp[:, 1] * self.W + disp[:, 2]).astype(np.int32),
        }
        if obs_table:
            n_obs = int(env.observation_space.n)
            cells = np.stack(np.unravel_index(np.arange(self.ncells), grid.shape), -1)
            goal = np.broadcast_to(np.asarray(env.fixed_goal_zyx), cells.shape)
            obs = env._obs_fn(
                torch.as_tensor(cells, dtype=torch.int32, device=env.device),
                torch.tensor(goal, dtype=torch.int32, device=env.device))
            obs = np.clip(obs.cpu().numpy().astype(np.int64), 0, n_obs - 1)
            obs[grid.reshape(-1) == WALL] = 0  # never queried
            self.host["obs"] = obs.astype(np.int32)
        self.n_agent = int(self.host["agent_bank"].size)
        self.n_goal = int(self.host["goal_bank"].size)
        self._tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables_on(self, device) -> Dict[str, torch.Tensor]:
        if device not in self._tables:
            tab = {k: torch.as_tensor(v, device=device)
                   for k, v in self.host.items()}
            tab["rew"] = torch.tensor(self.rewards, dtype=torch.float32,
                                      device=device)
            self._tables[device] = tab
        return self._tables[device]

    def move(self, tab, agent: torch.Tensor, goal, executed: torch.Tensor,
             elapsed: torch.Tensor) -> RoomsMove:
        """One step of every env from flat cell ``agent`` by the executed
        action (``goal`` a flat cell or a tensor of them)."""
        cell = tab["cell"]
        proposed = torch.clamp(agent + tab["disp"][executed.long()], 0,
                               self.ncells - 1)
        oob = cell[proposed.long()] == WALL
        agent2 = torch.where(oob, agent, proposed)
        # stair transit only when the agent moved (reference msrooms.py:419-428)
        code = cell[agent2.long()]
        z = agent2 // self.HW
        agent2 = torch.where((code == STAIR_UP) & ~oob,
                             (z + 1) * self.HW + self.up_to, agent2)
        agent2 = torch.where((code == STAIR_DOWN) & ~oob,
                             (z - 1) * self.HW + self.down_to, agent2)
        done = agent2 == goal  # after the transit
        r_step, r_wall, r_goal = tab["rew"]
        rew = torch.where(done, r_goal, torch.where(oob, r_wall, r_step))
        elapsed = elapsed + 1
        reset = done | (elapsed > self.time_limit)  # strict >
        return RoomsMove(agent=agent2, rew=rew, done=done, reset=reset,
                         ep_len=elapsed,
                         elapsed=torch.where(reset, 0, elapsed))

    def spawn_agent(self, tab, rng: KernelRNG) -> torch.Tensor:
        """A uniform ground-floor cell per env from one draw site."""
        return tab["agent_bank"][rng.rbits(self.n_agent).long()]

    def spawn_goal(self, tab, rng: KernelRNG) -> torch.Tensor:
        """A uniform top-floor cell per env from one draw site."""
        return tab["goal_bank"][rng.rbits(self.n_goal).long()]
