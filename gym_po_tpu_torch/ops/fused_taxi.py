"""Fused multi-step Taxi rollout: a hand-written CUDA kernel and its twin.

Port of the Pallas kernel :func:`gym_po_tpu.ops.fused_taxi.make_fused_taxi_rollout`.
The kernel (``csrc/fused_taxi.cu``) runs one thread per env over the flat
``[B]`` layout and keeps a whole K-step rollout in registers, with the
per-cell tables (and the optional greedy policy table) in shared memory.
Its source note says what bounds it on the card and what the design does
about that: among others, every draw's ``u % n`` divides by an invariant
divisor whose constants (:class:`~.kernel_rng.UDiv`) each
:func:`make_fused_taxi_rollout` call computes once from the env's map
(``run.divisors``).

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
from typing import Callable, Optional

import numpy as np
import torch

from ..envs.taxi import TaxiState
from ._build import count_launch
from .kernel_rng import MASK32, KernelRNG, UDiv, W, check_batch
from .taxi_dynamics import TaxiDynamics

__all__ = ["make_fused_taxi_rollout", "state_policy_table"]

_MAX_SMEM = 48 * 1024  # static shared-memory limit without an opt-in
# gpt::TaxiDivs in csrc/taxi_step.cuh, field for field
TAXI_DIVISORS = ("pd", "nlocs", "nlocs1", "rows", "cols", "n_valid")


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
    fn.argtypes = ([p] * 11 + [ctypes.c_uint] * 2 + [i] * 12 + [f] * 3
                   + [i, ctypes.POINTER(UDiv), p])
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
    if num_envs % W:
        raise ValueError("num_envs must be a multiple of 128")
    R = min(rows_per_tile, num_envs // W)
    tile_envs = R * W
    if num_envs % tile_envs:
        raise ValueError("num_envs must divide into [rows_per_tile, 128] tiles")
    grid = num_envs // tile_envs

    extra = {}
    if policy is not None:
        extra["pol"] = np.asarray(policy, np.int32).reshape(-1)
    dyn = TaxiDynamics(env, extra)
    if policy is not None:
        if extra["pol"].size != dyn.ns:
            raise ValueError(f"policy table must have {dyn.ns} entries")
        if ((extra["pol"] < 0) | (extra["pol"] >= 5)).any():
            raise ValueError("policy actions must lie in [0, 5)")
    ns_policy = extra["pol"].size if policy is not None else 0
    if 4 * (dyn.nc * 5 + dyn.n_valid + ns_policy) > _MAX_SMEM:
        raise ValueError("tables exceed the kernel's 48 KB of shared memory")

    if dyn.nlocs < 2:
        raise ValueError("the Taxi kernels need a map with two or more "
                         "landmarks (a destination differs from the pickup)")
    divisors = dict(zip(TAXI_DIVISORS, (dyn.pd, dyn.nlocs, dyn.nlocs - 1,
                                        dyn.rows, dyn.cols, dyn.n_valid)))
    div = (UDiv * len(divisors))(*map(UDiv.of, divisors.values()))

    # draw sites per step, in body order: action (random policy only), then
    # the Taxi step's (taxi_dynamics.py)
    n_sites = (1 if policy is None else 0) + dyn.n_sites
    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid * slab, W)
    n_out = 2 + (3 if episode_stats else 0)

    def twin(seed: int, s: torch.Tensor, *tape: torch.Tensor):
        """Plain PyTorch version of the kernel, on ``s``'s device."""
        check_batch(s, num_envs // W, rng_tape, tape_shape, tape)
        dev = s.device
        tab = dyn.tables_on(dev)
        rng = KernelRNG(seed, num_envs, num_steps, n_sites, R,
                        tape=tape[0] if rng_tape else None, device=dev)
        s = s.reshape(-1)
        bad_in = (s < 0) | (s >= dyn.ns)  # out-of-range input: s' = -1, NaN sums
        s = torch.where(bad_in, 0, s)
        completed = torch.zeros_like(s)
        elapsed = torch.zeros_like(s)
        racc = torch.zeros(num_envs, dtype=torch.float32, device=dev)
        cur_ret, ep_ret, ep_len, ep_cnt = (torch.zeros_like(racc) for _ in range(4))
        for step in range(num_steps):
            rng.begin_step(step)
            a = tab["pol"][s] if policy is not None else rng.rbits(5)
            st = dyn.step(rng, tab, s, a, completed, elapsed)
            s, completed, elapsed = st.s, st.completed, st.elapsed
            if episode_stats:
                cur_ret = cur_ret + st.rew
                ep_ret = torch.where(st.reset, ep_ret + cur_ret, ep_ret)
                ep_len = torch.where(st.reset,
                                     ep_len + st.ep_len.to(torch.float32),
                                     ep_len)
                ep_cnt = torch.where(st.reset, ep_cnt + 1.0, ep_cnt)
                cur_ret = torch.where(st.reset, 0.0, cur_ret)
            racc = racc + st.rew
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
        check_batch(s, num_envs // W, rng_tape, tape_shape, tape)
        if s.device.type == "cpu":
            return twin(seed, s, *tape)
        if s.device.type != "cuda":
            raise ValueError(f"unsupported device {s.device}")
        tab = dyn.tables_on(s.device)
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
                n_sites, dyn.nlocs, dyn.rows, dyn.cols, dyn.n_valid,
                int(dyn.all_valid), ns_policy, dyn.n_pass, dyn.time_limit,
                *dyn.rewards, int(episode_stats), div, stream,
            )
        if err:
            raise RuntimeError(f"fused_taxi launch failed: CUDA error {err}")
        count_launch(run, "fused_taxi")
        return (s_out, *f32)

    run.twin = twin
    run.launches = 0
    run.divisors = divisors
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
