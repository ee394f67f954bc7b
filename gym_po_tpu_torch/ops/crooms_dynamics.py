"""The CRooms step that the port's fused CRooms kernels share, as a plain twin.

``csrc/crooms_step.cuh`` holds the device side: the velocity clip, the
position clip to ``_pos_hi``, the wall test on the discretized cell, the
in-cell resample of a wall hit with its one-ULP clamp below the cell's upper
edge, the zeroed velocity on a hit, the goal test by squared distance
against ``thr²``, the wall/step/goal reward and ``elapsed > time_limit``
truncation.  :class:`CRoomsDynamics` is its plain PyTorch twin, vectorized
over ``[B]``, together with the constants and tables the kernels take: the
rollout (:mod:`.fused_crooms`) and the Q trainer (:mod:`.fused_q_crooms`)
both step through it.  It is the step of the JAX package's CRooms kernels
(``gym_po_tpu/ops/fused_crooms.py:138-172``, ``fused_q_crooms.py:199-232``),
which differs from :meth:`CRooms.resolve` in its goal test (squared
distance, not the square root) and in its upper clamp (``nextafter`` alone).

Every float operation is one f32 operation rounded to nearest, in the JAX
kernels' order: the kernel writes them with ``__fmul_rn``/``__fadd_rn``/
``__fsub_rn``/``__fdiv_rn``, which nvcc never contracts into an FMA, and the
twin divides by a device tensor, not a Python scalar (PyTorch's CUDA
division by a CPU scalar multiplies by its reciprocal).

The step draws nothing itself: each kernel draws its effective action's
uniforms and normals, the two resample normals and its respawns at its own
sites and hands them in.  Lookups read the JAX kernels' 128-lane banks: a
table padded to a multiple of 128 (walls with 1, observations with 0), and
an index past the padding reads lane ``idx % 128`` of the first row.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..envs.crooms import MAX_VELOCITY
from .kernel_rng import KernelRNG, W

__all__ = ["CRoomsDynamics", "CRoomsMove", "bank"]


def bank(values: np.ndarray, fill) -> np.ndarray:
    """``values`` padded with ``fill`` to a multiple of 128 entries."""
    out = np.full(-(-values.size // W) * W, fill, values.dtype)
    out[: values.size] = values
    return out


class CRoomsMove(NamedTuple):
    """One env step, as ``gpt::CRoomsMove`` in ``csrc/crooms_step.cuh``."""

    py: torch.Tensor  # after the move, before a respawn
    px: torch.Tensor
    vy: torch.Tensor
    vx: torch.Tensor
    rew: torch.Tensor
    done: torch.Tensor  # the goal was reached
    reset: torch.Tensor  # done or truncated: the episode ended
    ep_len: torch.Tensor  # elapsed at the end of the step, before a reset
    elapsed: torch.Tensor  # carried, zeroed at a reset


class CRoomsDynamics:
    """Constants, tables on each device, and the twin's step of a
    :class:`~gym_po_tpu_torch.envs.crooms.CRooms` env, as the fused kernels
    see them.  Every constant is an f32 cast of the double the JAX kernels
    build it from.

    ``obs_table=True`` adds ``"obs"``, the observation index of every cell
    under the fixed goal, from the port's own observation function at the
    cell centers on the CPU (walls read 0), as the Q trainer indexes its
    table by it; and ``"dy"``/``"dx"``, the f32 displacement of each
    discrete action."""

    def __init__(self, env, obs_table: bool = False):
        grid = env.grid_np
        self.H, self.W = grid.shape
        f32 = np.float32
        self.cs, self.half = f32(env.cell_size), f32(env.cell_size / 2)
        self.std, self.power = f32(env.action_std), f32(env.action_power)
        self.use_vel = bool(env.use_velocity)
        self.thr2 = f32(float(env.goal_threshold) ** 2)
        self.rewards = tuple(f32(r) for r in (
            env.step_reward, env.wall_reward, env.goal_reward))
        self.time_limit = int(env.time_limit)
        self.pos_hi = env._pos_hi.astype(f32)  # one cast of the f64 ceiling
        # fixed spawn coordinates as Python floats holding f32 values
        self.fixed_goal = (None if env.fixed_goal_coord is None else
                           tuple(float(f32(v)) for v in env.fixed_goal_coord))
        self.fixed_agent = (None if env.fixed_agent_coord is None else
                            tuple(float(f32(v)) for v in env.fixed_agent_coord))
        wall = grid.reshape(-1) == -1
        self.host: Dict[str, np.ndarray] = {
            "wall": bank(wall.astype(np.uint8), 1),
            "valid": np.flatnonzero(~wall).astype(np.int32),
        }
        if obs_table:
            from ..obs.observations import make_rooms_obs

            _, obs_fn = make_rooms_obs(env.base_obs_type, grid, env.obs_m,
                                       cell_size=env.cell_size, device="cpu")
            n_obs = int(env.observation_space.n)
            iy, ix = np.divmod(np.arange(self.H * self.W), self.W)
            centers = np.stack([(iy + 0.5) * env.cell_size,
                                (ix + 0.5) * env.cell_size], -1).astype(f32)
            goal = np.broadcast_to(np.asarray(env.fixed_goal_coord, f32),
                                   centers.shape)
            obs = obs_fn(torch.as_tensor(centers), torch.tensor(goal))
            obs = np.clip(obs.numpy().astype(np.int64), 0, n_obs - 1)
            obs[wall] = 0  # never queried
            self.host["obs"] = bank(obs.astype(np.int32), 0)
            disp = np.asarray(env._disp_np, f32)
            self.host["dy"], self.host["dx"] = disp[:, 0].copy(), disp[:, 1].copy()
        self.n_valid = int(self.host["valid"].size)
        self.nbank = int(self.host["wall"].size)
        self._tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables_on(self, device) -> Dict[str, torch.Tensor]:
        if device not in self._tables:
            tab = {k: torch.as_tensor(v, device=device)
                   for k, v in self.host.items()}
            tab["cs"] = torch.tensor(self.cs, device=device)
            self._tables[device] = tab
        return self._tables[device]

    @staticmethod
    def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``table[idx]`` as the JAX kernels' bank gather reads it: past the
        padded table, lane ``idx % 128`` of the first row."""
        n = table.numel()
        idx = idx.long()
        return torch.where((idx >= 0) & (idx < n), table[idx.clamp(0, n - 1)],
                           table[idx % W])

    def cell_of(self, tab, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Flat cell ``floor(y / cs) * W + floor(x / cs)`` (int32 math)."""
        cy = torch.floor(y / tab["cs"]).to(torch.int32)
        cx = torch.floor(x / tab["cs"]).to(torch.int32)
        return cy * self.W + cx

    def move(self, tab, py, px, vy, vx, ay, ax, nry, nrx, gy, gx,
             elapsed) -> CRoomsMove:
        """One step of every env by the effective action ``(ay, ax)``, with
        the standard normals ``(nry, nrx)`` for a wall resample and the goal
        ``(gy, gx)`` (tensors or f32 scalars)."""
        if self.use_vel:
            vy2 = torch.clamp(vy + ay, -MAX_VELOCITY, MAX_VELOCITY)
            vx2 = torch.clamp(vx + ax, -MAX_VELOCITY, MAX_VELOCITY)
            ny, nx = py + vy2, px + vx2
        else:
            vy2, vx2 = vy, vx
            ny, nx = py + ay, px + ax
        ny = torch.clamp(ny, 0.0, float(self.pos_hi[0]))
        nx = torch.clamp(nx, 0.0, float(self.pos_hi[1]))
        oob = self.lookup(tab["wall"], self.cell_of(tab, ny, nx)) == 1
        # a wall hit resamples within the current cell; the upper edge is
        # clamped one ULP down
        cs, half = float(self.cs), float(self.half)
        ceny = torch.floor(py / tab["cs"]) * cs + half
        cenx = torch.floor(px / tab["cs"]) * cs + half
        hiy = torch.nextafter(ceny + half, torch.zeros_like(ceny))
        hix = torch.nextafter(cenx + half, torch.zeros_like(cenx))
        ry = torch.minimum(torch.maximum(ceny + nry * 0.5, ceny - half), hiy)
        rx = torch.minimum(torch.maximum(cenx + nrx * 0.5, cenx - half), hix)
        py2 = torch.where(oob, ry, ny)
        px2 = torch.where(oob, rx, nx)
        vy3 = torch.where(oob, 0.0, vy2)
        vx3 = torch.where(oob, 0.0, vx2)
        dy, dx = py2 - gy, px2 - gx
        done = dy * dy + dx * dx <= float(self.thr2)
        r_step, r_wall, r_goal = (float(r) for r in self.rewards)
        rew = torch.where(done, r_goal, torch.where(oob, r_wall, r_step)).to(
            torch.float32)
        elapsed = elapsed + 1
        reset = done | (elapsed > self.time_limit)  # strict >
        return CRoomsMove(py2, px2, vy3, vx3, rew, done, reset, elapsed,
                          torch.where(reset, 0, elapsed))

    def spawn(self, tab, rng: KernelRNG):
        """A uniform walkable cell's center from one draw site, with the
        implicit cell size 1 of the reference's spawns."""
        cell = tab["valid"][rng.rbits(self.n_valid).long()]
        return ((cell // self.W).to(torch.float32) + 0.5,
                (cell % self.W).to(torch.float32) + 0.5)
