"""Fused multi-step MultistoryFourRooms rollout: a hand-written CUDA kernel
and its twin.

Port of the Pallas kernel
:func:`gym_po_tpu.ops.fused_msrooms.make_fused_msrooms_rollout`: K steps of
random-policy MultistoryFourRooms per call over flat zyx cells, with
generative action failure, the wall test, the stair transit, the goal
reward, truncation, goal respawns from the top-floor bank and agent
respawns from the ground-floor bank, and optional per-env episode
statistics.  The kernel (``csrc/fused_msrooms.cu``) runs one thread per env
over the flat ``[B]`` layout and keeps a whole rollout in registers, with
the step's tables in shared memory; its source note says what bounds it on
the card.  It reduces every draw, and finds the floor of a cell, by
invariant divisors whose constants the host hands in (``run.divisors``:
the actions, the actions less one, the two spawn banks' sizes, the cells
per floor), and draws a respawn only where an episode ends; the twin draws
every site every step.  ``run.twin`` is the plain PyTorch version of the
same function.

``run(seed, agent, goal, *tape)`` keeps the JAX package's contract:
``agent`` and ``goal`` are flat cells (``z * H * W + y * W + x``) laid out
int32 ``[B // 128, 128]``; the outputs are ``(agent', goal', reward_sums)``
plus ``(ep_ret, ep_len, ep_cnt)`` with ``episode_stats=True``;
``run.tape_shape`` and ``run.n_sites`` are the same.  On a CUDA tensor
``run`` launches the kernel (or raises); on a CPU tensor it runs the twin.
Draws follow :mod:`gym_po_tpu_torch.ops.kernel_rng` (tape, or Philox keyed
on ``seed``).  As in the JAX kernel, ``elapsed`` starts from zero at every
call.
"""

from __future__ import annotations

import ctypes

from .fused_rooms import rooms_family_rollout
from .kernel_rng import UDiv
from .msrooms_dynamics import MSRoomsDynamics

__all__ = ["make_fused_msrooms_rollout"]


class _MSRoomsParams(ctypes.Structure):
    """Mirror of ``MSRoomsParams`` in ``csrc/fused_msrooms.cu``."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "num_envs", "num_steps", "rows_per_tile", "n_sites", "ncells",
        "floor_cells", "up_to", "down_to", "n_agent", "n_goal", "n_act",
        "time_limit", "episode_stats", "fixed_goal", "fixed_agent")]
    _fields_ += [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)]
    _fields_ += [(n, ctypes.c_float) for n in (
        "p_fail", "r_step", "r_wall", "r_goal")]
    _fields_ += [(n, UDiv) for n in (
        "act_div", "alt_div", "goal_div", "agent_div", "floor_div")]


def make_fused_msrooms_rollout(env, num_envs: int, num_steps: int,
                               rows_per_tile: int = 128,
                               episode_stats: bool = False,
                               rng_tape: bool = False):
    """Build ``run(seed, agent, goal, *tape) -> (agent', goal', reward_sums[,
    ep_ret, ep_len, ep_cnt])`` for a :class:`MultistoryFourRooms` env.

    ``seed`` is an int (Philox key; pass a new one to each chained call).
    ``rows_per_tile`` only sets the tape layout (it is the JAX kernel's
    tile height); ``rng_tape=True`` makes ``run`` take a trailing int32 tape
    of shape ``run.tape_shape`` in place of Philox.
    """
    dyn = MSRoomsDynamics(env)
    divisors = {"n_act": dyn.n_act, "n_act - 1": dyn.n_act - 1,
                "n_goal": dyn.n_goal, "n_agent": dyn.n_agent,
                "floor_cells": dyn.HW}
    run = rooms_family_rollout(
        dyn, "fused_msrooms", _MSRoomsParams,
        dict(floor_cells=dyn.HW, up_to=dyn.up_to, down_to=dyn.down_to,
             n_agent=dyn.n_agent, n_goal=dyn.n_goal,
             **dict(zip(("act_div", "alt_div", "goal_div", "agent_div",
                         "floor_div"), map(UDiv.of, divisors.values())))),
        ("cell", "agent_bank", "goal_bank", "disp"), num_envs, num_steps,
        rows_per_tile, episode_stats, rng_tape)
    run.divisors = divisors
    return run
