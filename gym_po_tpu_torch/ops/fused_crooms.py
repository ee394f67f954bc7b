"""Fused multi-step continuous-ROOMS rollout: a hand-written CUDA kernel and
its twin.

Port of the Pallas kernel
:func:`gym_po_tpu.ops.fused_crooms.make_fused_crooms_rollout`: K steps of
random-policy CRooms per call for the continuous ('yx') action type: noisy
action (uniform in [-1, 1) plus Box-Muller noise, times the power), optional
velocity integration, the position clip, the wall test on the discretized
cell, the in-cell resample on a wall hit (one-ULP clamp), the goal-distance
test, truncation, and masked respawns at cell centers, with optional
per-env episode statistics.  The kernel (``csrc/fused_crooms.cu``) runs one
thread per env over the flat ``[B]`` layout and keeps a whole rollout in
registers; its source note says what bounds it on the card and what it
skips of the draws the twin makes.  The host hands it the invariant
divisors of its spawns (``run.divisors``) and, where the cell size is a
power of two, its inverse (``run.inv_cs``, :func:`inverse_cell_size`).
The step is shared with the Q trainer (:mod:`.crooms_dynamics`).  ``run.twin`` is the
plain PyTorch version of the same function.

``run(seed, py, px, vy, vx, gy, gx, *tape)`` keeps the JAX package's
contract: six f32 ``[B // 128, 128]`` tiles in; ``(py', px', vy', vx', gy',
gx', reward_sums)`` out, plus ``(ep_ret, ep_len, ep_cnt)`` with
``episode_stats=True``; ``run.tape_shape`` and ``run.n_sites`` are the same.
On a CUDA tensor ``run`` launches the kernel (or raises); on a CPU tensor it
runs the twin.  Draws follow :mod:`gym_po_tpu_torch.ops.kernel_rng` (tape,
or Philox keyed on ``seed``).  As in the JAX kernel, ``elapsed`` starts from
zero at every call.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .crooms_dynamics import CRoomsDynamics
from .kernel_rng import UDiv
from .state_rollout import Header, make_state_rollout

__all__ = ["make_fused_crooms_rollout", "inverse_cell_size"]


class _CRoomsParams(Header):
    """Mirror of ``CRoomsParams`` in ``csrc/fused_crooms.cu``."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "W", "nbank", "n_valid", "use_vel", "rand_goal", "rand_agent")]
    _fields_ += [(n, ctypes.c_float) for n in (
        "cs", "half", "pos_hi_y", "pos_hi_x", "thr2", "r_step", "r_wall",
        "r_goal", "std", "power", "goal_y", "goal_x", "agent_y", "agent_x",
        "inv_cs")]
    _fields_ += [("valid_div", UDiv), ("col_div", UDiv)]


def inverse_cell_size(cs) -> float:
    """``2^-k`` where the f32 cell size ``cs`` is ``2^k`` and ``2^-k`` is an
    f32, else 0.0.  For such a size ``y * 2^-k`` and ``y / 2^k`` are the
    correctly rounded values of the same real number, so the kernel's
    multiply equals the twin's division for every f32 ``y``; for any other
    size (0.0) the kernel divides."""
    cs = np.float32(cs)
    if not (np.isfinite(cs) and cs > 0) or math.frexp(float(cs))[0] != 0.5:
        return 0.0
    with np.errstate(over="ignore"):
        inv = np.float32(1.0) / cs
    return float(inv) if float(inv) * float(cs) == 1.0 else 0.0


def make_fused_crooms_rollout(env, num_envs: int, num_steps: int,
                              rows_per_tile: int = 128,
                              episode_stats: bool = False,
                              rng_tape: bool = False):
    """Build ``run(seed, py, px, vy, vx, gy, gx, *tape) -> (py', px', vy',
    vx', gy', gx', reward_sums[, ep_ret, ep_len, ep_cnt])`` for a
    :class:`CRooms` env with ``action_type='yx'``.

    ``seed`` is an int (Philox key; pass a new one to each chained call).
    ``rows_per_tile`` only sets the tape layout (the JAX kernel's tile
    height); ``rng_tape=True`` makes ``run`` take a trailing int32 tape of
    shape ``run.tape_shape`` in place of Philox.
    """
    if env.action_type != "yx":
        raise ValueError("fused crooms kernel supports action_type='yx'")
    dyn = CRoomsDynamics(env)
    fg, fa = dyn.fixed_goal, dyn.fixed_agent
    # draw sites per step, in body order: ay (uniform, then a two-draw
    # normal), ax (the same), the wall-resample normals ry and rx (two draws
    # each), goal respawn, agent respawn (fixed spawns draw nothing)
    n_sites = 10 + int(fg is None) + int(fa is None)

    def step(tab, rng, state, elapsed):
        py, px, vy, vx, gy, gx = state
        std, power = float(dyn.std), float(dyn.power)
        ay = (rng.runiform() * 2.0 - 1.0 + rng.rnormal() * std) * power
        ax = (rng.runiform() * 2.0 - 1.0 + rng.rnormal() * std) * power
        nry, nrx = rng.rnormal(), rng.rnormal()
        mv = dyn.move(tab, py, px, vy, vx, ay, ax, nry, nrx, gy, gx, elapsed)
        # goal first, then agent: the JAX kernel's body order
        ngy, ngx = dyn.spawn(tab, rng) if fg is None else fg
        nay, nax = dyn.spawn(tab, rng) if fa is None else fa
        zero = torch.zeros_like(py)
        new = (torch.where(mv.reset, nay, mv.py), torch.where(mv.reset, nax, mv.px),
               torch.where(mv.reset, zero, mv.vy), torch.where(mv.reset, zero, mv.vx),
               torch.where(mv.reset, ngy, gy), torch.where(mv.reset, ngx, gx))
        return new, mv.rew, mv.reset, mv.ep_len, mv.elapsed

    r_step, r_wall, r_goal = dyn.rewards
    params = dict(
        time_limit=dyn.time_limit, W=dyn.W, nbank=dyn.nbank, n_valid=dyn.n_valid,
        use_vel=int(dyn.use_vel), rand_goal=int(fg is None),
        rand_agent=int(fa is None), cs=dyn.cs, half=dyn.half,
        pos_hi_y=dyn.pos_hi[0], pos_hi_x=dyn.pos_hi[1], thr2=dyn.thr2,
        r_step=r_step, r_wall=r_wall, r_goal=r_goal, std=dyn.std,
        power=dyn.power, goal_y=fg[0] if fg else 0.0,
        goal_x=fg[1] if fg else 0.0, agent_y=fa[0] if fa else 0.0,
        agent_x=fa[1] if fa else 0.0, inv_cs=inverse_cell_size(dyn.cs),
        valid_div=UDiv.of(dyn.n_valid), col_div=UDiv.of(dyn.W))
    run = make_state_rollout(
        "fused_crooms", "fused_crooms_launch", "fused_crooms",
        (torch.float32,) * 6, n_sites, num_envs, num_steps, rows_per_tile,
        episode_stats, rng_tape, _CRoomsParams, params, step,
        tables_on=dyn.tables_on, table_names=("wall", "valid"))
    run.divisors = {"n_valid": dyn.n_valid, "W": dyn.W}  # the spawns' UDiv
    run.inv_cs = params["inv_cs"]
    return run
