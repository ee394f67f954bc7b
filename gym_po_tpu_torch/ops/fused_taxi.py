"""Fused multi-step Taxi rollout: a hand-written CUDA kernel and its twin.

Port of the Pallas kernel :func:`gym_po_tpu.ops.fused_taxi.make_fused_taxi_rollout`.
The kernel (``csrc/fused_taxi.cu``) runs one thread per env over the flat
``[B]`` layout and keeps a whole K-step rollout in registers, with the
per-cell tables (and the optional greedy policy table) in shared memory.
Its source note says what bounds it on the card and what the design does
about that.

``run(seed, s, *tape)`` keeps the JAX package's public contract: ``s`` is
int32 ``[B // 128, 128]``; the outputs are ``(s', reward_sums)`` plus
``(ep_ret, ep_len, ep_cnt)`` with ``episode_stats=True``, all
``[B // 128, 128]``; ``run.tape_shape`` and ``run.n_sites`` are the same.
On a CUDA tensor ``run`` launches the kernel (or raises); on a CPU tensor
it runs :func:`run.twin`, the plain PyTorch version of the same function,
which tests and ``chip_smoke.py`` also call directly on the card.  Draws
follow :mod:`gym_po_tpu_torch.ops.kernel_rng` (tape, or Philox keyed on
``seed``).

As in the JAX kernel, ``completed`` and ``elapsed`` start from zero at every
call: they are not carried across chained calls, unlike ``step_vec``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..envs.taxi import TaxiState
from .kernel_rng import MASK32, KernelRNG, W

__all__ = ["make_fused_taxi_rollout", "state_policy_table"]

_MAX_SMEM = 48 * 1024  # static shared-memory limit without an opt-in


def state_policy_table(env, policy: Callable) -> np.ndarray:
    """Compose the env's state->obs map with a ``(generator, obs) -> action``
    policy into an ``[ns]`` per-encoded-state action table for the kernel.

    Works for any deterministic policy on a ``Discrete`` obs space; the
    Hansen variants are handled because their obs is a pure function of the
    encoded state.
    """
    ns = env.tables.ns
    s = torch.arange(ns, dtype=torch.int32, device=env.device)
    z = torch.zeros_like(s)
    obs = env.observe(TaxiState(elapsed=z, s=s, completed=z))
    return np.asarray(policy(None, obs).cpu(), np.int32)


@functools.cache
def _launcher():
    from ._build import load_library

    lib = load_library("fused_taxi")
    fn = lib.fused_taxi_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 11 + [ctypes.c_uint] * 2 + [i] * 12 + [f] * 3 + [i, p]
    fn.restype = i
    return fn


def make_fused_taxi_rollout(env, num_envs: int, num_steps: int,
                            rows_per_tile: int = 128,
                            policy: Optional[np.ndarray] = None,
                            episode_stats: bool = False,
                            rng_tape: bool = False):
    """Build ``run(seed, s, *tape) -> (s', reward_sums[, ep_ret, ep_len,
    ep_cnt])`` for a Taxi env.

    ``seed`` is an int (Philox key; pass a new one to each chained call).
    ``policy`` is an ``[ns]`` int32 per-state action table (see
    :func:`state_policy_table`); without it actions are uniform draws.
    ``rows_per_tile`` only sets the tape layout (it is the JAX kernel's
    tile height); ``rng_tape=True`` makes ``run`` take a trailing int32 tape
    of shape ``run.tape_shape`` in place of Philox.
    """
    t = env.tables
    nc = t.rows * t.cols
    if nc > W:
        raise ValueError(f"map has {nc} cells; fused kernel supports <= {W}")
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    pd = (nlocs + 1) * nlocs
    ns = nc * pd
    all_valid = env._all_cells_valid

    if num_envs % W:
        raise ValueError("num_envs must be a multiple of 128")
    R = min(rows_per_tile, num_envs // W)
    tile_envs = R * W
    if num_envs % tile_envs:
        raise ValueError("num_envs must divide into [rows_per_tile, 128] tiles")
    grid = num_envs // tile_envs

    host: Dict[str, np.ndarray] = {
        "cm": np.asarray(env._cell_move.cpu(), np.int32),  # [nc * 4]
        "la": np.asarray(env._loc_at.cpu(), np.int32),  # [nc]
        "vc": np.flatnonzero((t.tgrid != "|").reshape(-1)).astype(np.int32),
    }
    if policy is not None:
        host["pol"] = np.asarray(policy, np.int32).reshape(-1)
        if host["pol"].size != ns:
            raise ValueError(f"policy table must have {ns} entries")
        if ((host["pol"] < 0) | (host["pol"] >= 5)).any():
            raise ValueError("policy actions must lie in [0, 5)")
    n_valid = host["vc"].size
    ns_policy = host["pol"].size if policy is not None else 0
    if 4 * (nc * 5 + n_valid + ns_policy) > _MAX_SMEM:
        raise ValueError("tables exceed the kernel's 48 KB of shared memory")

    # draw sites per step, in body order: action (random policy only),
    # task pn, task d0, full-reset cell (2 draws when every cell is
    # navigable, else 1 bank draw), reset pr, reset dr0
    n_sites = (1 if policy is None else 0) + 2 + (2 if all_valid else 1) + 2
    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid * slab, W)
    n_out = 2 + (3 if episode_stats else 0)
    rewards = (env.reward_goal, env.reward_bad, env.reward_any)
    tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables_on(device) -> Dict[str, torch.Tensor]:
        if device not in tables:
            tables[device] = {k: torch.as_tensor(v, device=device)
                              for k, v in host.items()}
            tables[device]["rew"] = torch.tensor(rewards, dtype=torch.float32,
                                                 device=device)
        return tables[device]

    def check(s: torch.Tensor, tape: Tuple[torch.Tensor, ...]) -> None:
        if not isinstance(s, torch.Tensor) or s.dtype != torch.int32:
            raise ValueError("s must be an int32 tensor")
        if tuple(s.shape) != (num_envs // W, W) or not s.is_contiguous():
            raise ValueError(
                f"s must be contiguous with shape {(num_envs // W, W)}, got "
                f"{tuple(s.shape)}"
            )
        if len(tape) != int(rng_tape):
            raise ValueError(
                f"run takes {int(rng_tape)} tape argument(s), got {len(tape)}"
            )
        if rng_tape:
            tp = tape[0]
            if tuple(tp.shape) != tape_shape:
                raise ValueError(
                    f"rng tape must have shape {tape_shape}, got {tuple(tp.shape)}"
                )
            if (tp.dtype != torch.int32 or tp.device != s.device
                    or not tp.is_contiguous()):
                raise ValueError(
                    "rng tape must be a contiguous int32 tensor on s's device"
                )

    def twin(seed: int, s: torch.Tensor, *tape: torch.Tensor):
        """Plain PyTorch version of the kernel, on ``s``'s device."""
        check(s, tape)
        dev = s.device
        tab = tables_on(dev)
        cm, la, vc = tab["cm"], tab["la"], tab["vc"]
        r_goal, r_bad, r_any = tab["rew"]
        rng = KernelRNG(seed, num_envs, num_steps, n_sites, R,
                        tape=tape[0] if rng_tape else None, device=dev)
        s = s.reshape(-1)
        bad_in = (s < 0) | (s >= ns)  # out-of-range input: s' = -1, NaN sums
        s = torch.where(bad_in, 0, s)
        completed = torch.zeros_like(s)
        elapsed = torch.zeros_like(s)
        racc = torch.zeros(num_envs, dtype=torch.float32, device=dev)
        cur_ret, ep_ret, ep_len, ep_cnt = (torch.zeros_like(racc) for _ in range(4))
        for step in range(num_steps):
            rng.begin_step(step)
            a = tab["pol"][s] if policy is not None else rng.rbits(5)
            rc = s // pd
            rem = s % pd
            p = rem // nlocs
            d = rem % nlocs
            moved = cm[rc * 4 + torch.clamp(a, max=3)]
            is_pd = a == 4
            loc = la[rc]
            goal = is_pd & (p == nlocs) & (loc == d)
            pickup = is_pd & (p < nlocs) & (loc == p)
            bad = is_pd & ~goal & ~pickup
            p2 = torch.where(pickup, nlocs, p)
            rc2 = torch.where(is_pd, rc, moved)
            completed = completed + goal.to(torch.int32)
            rew = torch.where(goal, r_goal, torch.where(bad, r_bad, r_any))
            elapsed = elapsed + 1
            done = completed == env.num_passengers
            trunc = elapsed > env.time_limit
            task = goal & ~(done | trunc)
            pn = rng.rbits(nlocs)
            d0 = rng.rbits(nlocs - 1)
            p3 = torch.where(task, pn, p2)
            d3 = torch.where(task, d0 + (d0 >= pn), d)
            reset = done | trunc
            if all_valid:
                rr = rng.rbits(rows)
                rc_new = rr * cols + rng.rbits(cols)
            else:
                rc_new = vc[rng.rbits(n_valid)]
            pr = rng.rbits(nlocs)
            dr0 = rng.rbits(nlocs - 1)
            rc3 = torch.where(reset, rc_new, rc2)
            p4 = torch.where(reset, pr, p3)
            d4 = torch.where(reset, dr0 + (dr0 >= pr), d3)
            completed = torch.where(reset, 0, completed)
            s = (rc3 * (nlocs + 1) + p4) * nlocs + d4
            if episode_stats:
                cur_ret = cur_ret + rew
                ep_ret = torch.where(reset, ep_ret + cur_ret, ep_ret)
                ep_len = torch.where(reset, ep_len + elapsed.to(torch.float32),
                                     ep_len)
                ep_cnt = torch.where(reset, ep_cnt + 1.0, ep_cnt)
                cur_ret = torch.where(reset, 0.0, cur_ret)
            elapsed = torch.where(reset, 0, elapsed)
            racc = racc + rew
        rng.finalize(n_sites)
        outs = [torch.where(bad_in, -1, s)]
        outs += [torch.where(bad_in, torch.nan, x)
                 for x in (racc, ep_ret, ep_len, ep_cnt)[:n_out - 1]]
        return tuple(o.reshape(num_envs // W, W) for o in outs)

    def run(seed: int, s: torch.Tensor, *tape: torch.Tensor):
        """One K-step rollout: the CUDA kernel on a CUDA tensor, the twin on
        a CPU tensor.  ``s`` holds encoded states (as ``reset_vec`` makes
        them); an env whose state lies outside ``[0, ns)`` comes out as
        ``s' = -1`` with NaN sums on both paths, and the others are
        unaffected."""
        check(s, tape)
        if s.device.type == "cpu":
            return twin(seed, s, *tape)
        if s.device.type != "cuda":
            raise ValueError(f"unsupported device {s.device}")
        tab = tables_on(s.device)
        launch = _launcher()
        s_out = torch.empty_like(s)
        f32 = [torch.empty(s.shape, dtype=torch.float32, device=s.device)
               for _ in range(n_out - 1)]
        stats = f32[1:] if episode_stats else [None] * 3

        def ptr(x):
            return None if x is None else x.data_ptr()

        with torch.cuda.device(s.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                ptr(s), ptr(s_out), ptr(f32[0]), *map(ptr, stats),
                ptr(tab["cm"]), ptr(tab["la"]), ptr(tab["vc"]),
                ptr(tab.get("pol")), ptr(tape[0] if rng_tape else None),
                seed & MASK32, (seed >> 32) & MASK32, num_envs, num_steps, R,
                n_sites, nlocs, rows, cols, n_valid, int(all_valid), ns_policy,
                env.num_passengers, env.time_limit, *rewards,
                int(episode_stats), stream,
            )
        if err:
            raise RuntimeError(f"fused_taxi launch failed: CUDA error {err}")
        run.launches += 1
        return (s_out, *f32)

    run.twin = twin
    run.launches = 0
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
