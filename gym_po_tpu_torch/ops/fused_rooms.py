"""Fused multi-step ROOMS rollout: a hand-written CUDA kernel and its twin.

Port of the Pallas kernel :func:`gym_po_tpu.ops.fused_rooms.make_fused_rooms_rollout`:
K steps of random-policy ROOMS per call, with generative action failure,
the wall test, the goal reward and respawn, truncation, masked agent and
goal respawns from the walkable cells, and optional per-env episode
statistics.  The kernel (``csrc/fused_rooms.cu``) runs one thread per env
over the flat ``[B]`` layout and keeps a whole rollout in registers, with
the step's tables in shared memory; its source note says what bounds it on
the card.  It reduces every draw by invariant divisors whose constants the
host hands in (``run.divisors``: the actions, the actions less one, the
walkable cells), and draws a respawn only where an episode ends; the twin
draws every site every step.  ``run.twin`` is the plain PyTorch version of
the same function.

``run(seed, agent, goal, *tape)`` keeps the JAX package's contract:
``agent`` and ``goal`` are flat cells (``y * W + x``) laid out int32
``[B // 128, 128]``; the outputs are ``(agent', goal', reward_sums)`` plus
``(ep_ret, ep_len, ep_cnt)`` with ``episode_stats=True``; ``run.tape_shape``
and ``run.n_sites`` are the same.  On a CUDA tensor ``run`` launches the
kernel (or raises); on a CPU tensor it runs the twin.  Draws follow
:mod:`gym_po_tpu_torch.ops.kernel_rng` (tape, or Philox keyed on ``seed``).
As in the JAX kernel, ``elapsed`` starts from zero at every call.

:func:`rooms_family_rollout` is the wrapper and twin around any rooms-family
rollout kernel and its env step; the MultistoryFourRooms rollout
(:mod:`.fused_msrooms`) uses it too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import count_launch
from .kernel_rng import MASK32, KernelRNG, UDiv, W, check_batch
from .rooms_dynamics import RoomsDynamics

__all__ = ["make_fused_rooms_rollout", "rooms_family_rollout"]


class _RoomsParams(ctypes.Structure):
    """Mirror of ``RoomsParams`` in ``csrc/fused_rooms.cu``."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "num_envs", "num_steps", "rows_per_tile", "n_sites", "ncells",
        "n_valid", "n_act", "time_limit", "episode_stats", "fixed_goal",
        "fixed_agent")]
    _fields_ += [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)]
    _fields_ += [(n, ctypes.c_float) for n in (
        "p_fail", "r_step", "r_wall", "r_goal")]
    _fields_ += [(n, UDiv) for n in ("act_div", "alt_div", "valid_div")]


@functools.cache
def _launcher(kernel: str, params_cls, n_tables: int):
    from ._build import load_library

    fn = getattr(load_library(kernel), f"{kernel}_launch")
    fn.argtypes = ([ctypes.POINTER(params_cls)]
                   + [ctypes.c_void_p] * (10 + n_tables))
    fn.restype = ctypes.c_int
    return fn


def make_fused_rooms_rollout(env, num_envs: int, num_steps: int,
                             rows_per_tile: int = 128,
                             episode_stats: bool = False,
                             rng_tape: bool = False):
    """Build ``run(seed, agent, goal, *tape) -> (agent', goal', reward_sums[,
    ep_ret, ep_len, ep_cnt])`` for a :class:`Rooms` env.

    ``seed`` is an int (Philox key; pass a new one to each chained call).
    ``rows_per_tile`` only sets the tape layout (it is the JAX kernel's
    tile height); ``rng_tape=True`` makes ``run`` take a trailing int32 tape
    of shape ``run.tape_shape`` in place of Philox.
    """
    dyn = RoomsDynamics(env)
    divisors = {"n_act": dyn.n_act, "n_act - 1": dyn.n_act - 1,
                "n_valid": dyn.n_valid}
    run = rooms_family_rollout(
        dyn, "fused_rooms", _RoomsParams,
        dict(n_valid=dyn.n_valid,
             **dict(zip(("act_div", "alt_div", "valid_div"),
                        map(UDiv.of, divisors.values())))),
        ("wall", "valid", "disp"), num_envs, num_steps, rows_per_tile,
        episode_stats, rng_tape)
    run.divisors = divisors
    return run


def rooms_family_rollout(dyn, kernel: str, params_cls, params: dict,
                         tables, num_envs: int, num_steps: int,
                         rows_per_tile: int, episode_stats: bool,
                         rng_tape: bool):
    """``run`` and its twin for a rollout kernel of the rooms family over
    the env step ``dyn`` (:class:`RoomsDynamics` or
    :class:`~gym_po_tpu_torch.ops.msrooms_dynamics.MSRoomsDynamics`).  The
    kernel ``csrc/<kernel>.cu`` takes ``params_cls`` (the fields every
    family member shares, and ``params``) and the tables named in
    ``tables`` after the agent and goal tiles."""
    if num_envs % W:
        raise ValueError("num_envs must be a multiple of 128")
    R = min(rows_per_tile, num_envs // W)
    if num_envs % (R * W):
        raise ValueError("num_envs must divide into [rows_per_tile, 128] tiles")
    grid = num_envs // (R * W)
    p_fail = np.float32(dyn.p_fail)
    rand_goal, rand_agent = dyn.goal < 0, dyn.fixed_agent < 0
    # draw sites per step, in body order: commanded action, failure coin,
    # alternative action, goal respawn, agent respawn (fixed spawns: none)
    n_sites = 3 + int(rand_goal) + int(rand_agent)
    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid * slab, W)
    n_out = 3 + (3 if episode_stats else 0)
    rows = num_envs // W

    def check(agent, goal, tape):
        check_batch(agent, rows, rng_tape, tape_shape, tape)
        check_batch(goal, rows, False, tape_shape, ())
        if goal.device != agent.device:
            raise ValueError("agent and goal must be on one device")

    def twin(seed: int, agent: torch.Tensor, goal: torch.Tensor,
             *tape: torch.Tensor):
        """Plain PyTorch version of the kernel, on ``agent``'s device."""
        check(agent, goal, tape)
        dev = agent.device
        tab = dyn.tables_on(dev)
        rng = KernelRNG(seed, num_envs, num_steps, n_sites, R,
                        tape=tape[0] if rng_tape else None, device=dev)
        agent, goal = agent.reshape(-1), goal.reshape(-1)
        bad = (agent < 0) | (agent >= dyn.ncells)  # inactive: -1, NaN sums
        agent = torch.where(bad, 0, agent)
        elapsed = torch.zeros_like(agent)
        racc = torch.zeros(num_envs, dtype=torch.float32, device=dev)
        cur_ret, ep_ret, ep_len, ep_cnt = (torch.zeros_like(racc) for _ in range(4))
        for step in range(num_steps):
            rng.begin_step(step)
            a_cmd = rng.rbits(dyn.n_act)
            fail = rng.runiform() < p_fail
            alt = rng.rbits(dyn.n_act - 1)
            mv = dyn.move(tab, agent, goal, dyn.executed(fail, alt, a_cmd),
                          elapsed)
            # goal first, then agent: the JAX kernel's body order
            g_new = dyn.spawn_goal(tab, rng) if rand_goal else dyn.goal
            a_new = dyn.spawn_agent(tab, rng) if rand_agent else dyn.fixed_agent
            goal = torch.where(mv.reset, g_new, goal)
            agent = torch.where(mv.reset, a_new, mv.agent)
            elapsed = mv.elapsed
            if episode_stats:
                cur_ret = cur_ret + mv.rew
                ep_ret = torch.where(mv.reset, ep_ret + cur_ret, ep_ret)
                ep_len = torch.where(mv.reset,
                                     ep_len + mv.ep_len.to(torch.float32), ep_len)
                ep_cnt = torch.where(mv.reset, ep_cnt + 1.0, ep_cnt)
                cur_ret = torch.where(mv.reset, 0.0, cur_ret)
            racc = racc + mv.rew
        rng.finalize(n_sites)
        outs = [torch.where(bad, -1, agent), torch.where(bad, -1, goal)]
        outs += [torch.where(bad, torch.nan, x)
                 for x in (racc, ep_ret, ep_len, ep_cnt)[:n_out - 2]]
        return tuple(o.reshape(rows, W) for o in outs)

    def run(seed: int, agent: torch.Tensor, goal: torch.Tensor,
            *tape: torch.Tensor):
        """One K-step rollout: the CUDA kernel on a CUDA tensor, the twin on
        a CPU tensor.  An env whose agent cell lies outside the grid comes
        out as ``agent' = goal' = -1`` with NaN sums on both paths."""
        check(agent, goal, tape)
        if agent.device.type == "cpu":
            return twin(seed, agent, goal, *tape)
        if agent.device.type != "cuda":
            raise ValueError(f"unsupported device {agent.device}")
        tab = dyn.tables_on(agent.device)
        outs = [torch.empty_like(agent), torch.empty_like(agent)]
        outs += [torch.empty(agent.shape, dtype=torch.float32,
                             device=agent.device) for _ in range(n_out - 2)]
        stats = outs[3:] if episode_stats else [None] * 3
        P = params_cls(
            num_envs=num_envs, num_steps=num_steps, rows_per_tile=R,
            n_sites=n_sites, ncells=dyn.ncells, n_act=dyn.n_act,
            time_limit=dyn.time_limit, episode_stats=int(episode_stats),
            fixed_goal=dyn.goal, fixed_agent=dyn.fixed_agent,
            key0=seed & MASK32, key1=(seed >> 32) & MASK32, p_fail=p_fail,
            **params)
        P.r_step, P.r_wall, P.r_goal = dyn.rewards

        def ptr(x):
            return None if x is None else x.data_ptr()

        with torch.cuda.device(agent.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launcher(kernel, params_cls, len(tables))(
                ctypes.byref(P), ptr(agent), ptr(goal),
                *(ptr(tab[t]) for t in tables),
                ptr(tape[0] if rng_tape else None), ptr(outs[0]),
                ptr(outs[1]), ptr(outs[2]), *map(ptr, stats), stream)
        if err:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
        count_launch(run, kernel)
        return tuple(outs)

    run.twin = twin
    run.launches = 0
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
