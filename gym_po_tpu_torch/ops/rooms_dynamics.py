"""The ROOMS step that the port's fused ROOMS kernels share, as a plain twin.

``csrc/rooms_step.cuh`` holds the device side: the executed action under
generative failure, the flat-cell move with its wall test, the goal
reward, ``elapsed > time_limit`` truncation and the respawn from the
walkable-cell list.  :class:`RoomsDynamics` is its plain PyTorch twin,
vectorized over ``[B]``, together with the constants and per-cell tables the
kernels take: the rollout (:mod:`.fused_rooms`), the tabular Q trainers
(:mod:`.fused_qlearning`, :mod:`.fused_qlambda`) and the actor-critic
(:mod:`.fused_ac`) all step through it.

The step draws nothing itself: each kernel draws its failure coin, its
alternative action and its respawns at its own sites, as its JAX kernel
does (the rollout compares ``runiform() < f32(p_fail)``, the trainers
``r24() < int(p_fail * 2**24)``), and hands the results in.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .kernel_rng import KernelRNG

__all__ = ["RoomsDynamics", "RoomsMove"]


class RoomsMove(NamedTuple):
    """One env step, as ``gpt::RoomsMove`` in ``csrc/rooms_step.cuh``."""

    agent: torch.Tensor  # after the move, before a respawn
    rew: torch.Tensor
    done: torch.Tensor  # the goal was reached
    reset: torch.Tensor  # done or truncated: the episode ended
    ep_len: torch.Tensor  # elapsed at the end of the step, before a reset
    elapsed: torch.Tensor  # carried, zeroed at a reset


def _flat(env, yx) -> int:
    return -1 if yx is None else int(yx[0] * env.grid_np.shape[1] + yx[1])


class RoomsDynamics:
    """Constants, per-cell tables on each device, and the twin's step of a
    :class:`~gym_po_tpu_torch.envs.rooms.Rooms` env, as the fused kernels
    see them.  Cells are flat: ``y * W + x``.

    ``obs_table=True`` adds ``"obs"``, the observation index of every cell
    under the fixed goal, from the env's own observation function (walls
    read 0), as the trainers index their tables by it."""

    def __init__(self, env, obs_table: bool = False):
        grid = env.grid_np
        self.H, self.W = grid.shape
        self.ncells = self.H * self.W
        self.n_act = int(env.num_actions)
        self.time_limit = int(env.time_limit)
        self.rewards = (env.step_reward, env.wall_reward, env.goal_reward)
        # p = 1 - P(executed = 0 | commanded = 0), in f64 from the cumsum
        self.p_fail = 1.0 - float(env._cum[0][0])
        self.goal = _flat(env, env.fixed_goal_yx)  # -1: random goal
        self.fixed_agent = _flat(env, env.fixed_agent_yx)  # -1: random agent
        disp = np.asarray(env.actions_np)
        wall = grid.reshape(-1) == -1
        self.host: Dict[str, np.ndarray] = {
            "wall": wall.astype(np.uint8),
            "valid": np.flatnonzero(~wall).astype(np.int32),
            "disp": (disp[:, 0] * self.W + disp[:, 1]).astype(np.int32),
        }
        if obs_table:
            n_obs = int(env.observation_space.n)
            cells = np.stack(np.divmod(np.arange(self.ncells), self.W), -1)
            goal = np.broadcast_to(np.asarray(env.fixed_goal_yx), cells.shape)
            obs = env._obs_fn(
                torch.as_tensor(cells, dtype=torch.int32, device=env.device),
                torch.tensor(goal, dtype=torch.int32, device=env.device))
            obs = np.clip(obs.cpu().numpy().astype(np.int64), 0, n_obs - 1)
            obs[wall] = 0  # never queried
            self.host["obs"] = obs.astype(np.int32)
        self.n_valid = int(self.host["valid"].size)
        self._tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables_on(self, device) -> Dict[str, torch.Tensor]:
        if device not in self._tables:
            tab = {k: torch.as_tensor(v, device=device)
                   for k, v in self.host.items()}
            tab["wall"] = tab["wall"].bool()
            tab["rew"] = torch.tensor(self.rewards, dtype=torch.float32,
                                      device=device)
            self._tables[device] = tab
        return self._tables[device]

    @staticmethod
    def executed(fail: torch.Tensor, alt: torch.Tensor,
                 a_cmd: torch.Tensor) -> torch.Tensor:
        """The commanded action, or on failure one of the other ``A - 1``."""
        return torch.where(fail, alt + (alt >= a_cmd).to(alt.dtype), a_cmd)

    def move(self, tab, agent: torch.Tensor, goal, executed: torch.Tensor,
             elapsed: torch.Tensor) -> RoomsMove:
        """One step of every env from flat cell ``agent`` by the executed
        action (``goal`` a flat cell or a tensor of them)."""
        proposed = torch.clamp(agent + tab["disp"][executed.long()], 0,
                               self.ncells - 1)
        oob = tab["wall"][proposed.long()]
        agent2 = torch.where(oob, agent, proposed)
        done = agent2 == goal
        r_step, r_wall, r_goal = tab["rew"]
        rew = torch.where(done, r_goal, torch.where(oob, r_wall, r_step))
        elapsed = elapsed + 1
        reset = done | (elapsed > self.time_limit)  # strict >
        return RoomsMove(agent=agent2, rew=rew, done=done, reset=reset,
                         ep_len=elapsed,
                         elapsed=torch.where(reset, 0, elapsed))

    def spawn(self, tab, rng: KernelRNG) -> torch.Tensor:
        """A uniform walkable cell per env from one draw site."""
        return tab["valid"][rng.rbits(self.n_valid).long()]

    spawn_goal = spawn_agent = spawn  # one bank for both
