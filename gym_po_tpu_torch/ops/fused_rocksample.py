"""Fused multi-step RockSample rollout: a hand-written CUDA kernel and its
twin.

Port of the Pallas kernel
:func:`gym_po_tpu.ops.fused_rocksample.make_fused_rocksample_rollout`: K
steps of random-policy RockSample per call, with the state packed into two
int32 words per env, the flat cell ``y * cols + x`` and the rock-quality
bitmask (bit i set: rock i is good), so a sample is one AND-NOT and an
episode reset one draw of k random bits; moving east off the map exits
(+10), a sample reads the rock at the cell before the move, truncation is
``elapsed >= time_limit``, and optional per-env episode statistics.  The
kernel (``csrc/fused_rocksample.cu``) runs one thread per env over the flat
``[B]`` layout with the rock-at-cell table in shared memory; its source note
says what bounds it on the card.  The action's ``u % (5 + k)`` divides by an
invariant divisor whose constants (:class:`~.kernel_rng.UDiv`) each
``make_fused_rocksample_rollout`` call computes once (``run.divisors``).
``run.twin`` is the plain PyTorch version of the same function.

The sensor draw is taken every step, as in the JAX kernel, but its result
is dead there (the reading is not materialized), so neither the kernel nor
the twin computes the sensor accuracy.

``run(seed, pos, mask, *tape)`` keeps the JAX package's contract: ``pos``
and ``mask`` int32 ``[B // 128, 128]``; the outputs are ``(pos', mask',
reward_sums)`` plus ``(ep_ret, ep_len, ep_cnt)`` with
``episode_stats=True``; ``run.tape_shape`` and ``run.n_sites`` are the same.
On a CUDA tensor ``run`` launches the kernel (or raises); on a CPU tensor it
runs the twin.  As in the JAX kernel, ``elapsed`` starts from zero at every
call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from ..envs.rocksample import (
    BAD_PENALTY,
    EXIT_REWARD,
    GOOD_REWARD,
    ILLEGAL_SAMPLE_PENALTY,
)
from ._build import count_launch
from .kernel_rng import MASK32, KernelRNG, UDiv, W, check_batch

__all__ = ["make_fused_rocksample_rollout", "rock_bitmask"]

MAX_ROCKS = 30  # the bitmask is an int32


class _RockSampleParams(ctypes.Structure):
    """Mirror of ``RockSampleParams`` in ``csrc/fused_rocksample.cu``."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "num_envs", "num_steps", "rows_per_tile", "n_sites", "rows", "cols",
        "k", "init_cell", "time_limit", "episode_stats")]
    _fields_ += [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32),
                 ("n_act", UDiv)]


@functools.cache
def _launcher():
    from ._build import load_library

    fn = load_library("fused_rocksample").fused_rocksample_launch
    fn.argtypes = [ctypes.POINTER(_RockSampleParams)] + [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


def rock_bitmask(rock_good: torch.Tensor) -> torch.Tensor:
    """``[..., k]`` bool rock qualities -> int32 bitmask (bit i: rock i)."""
    k = rock_good.shape[-1]
    bits = 2 ** torch.arange(k, dtype=torch.int32, device=rock_good.device)
    return (rock_good.to(torch.int32) * bits).sum(-1, dtype=torch.int32)


def make_fused_rocksample_rollout(env, num_envs: int, num_steps: int,
                                  rows_per_tile: int = 128,
                                  episode_stats: bool = False,
                                  rng_tape: bool = False):
    """Build ``run(seed, pos, mask, *tape) -> (pos', mask', reward_sums[,
    ep_ret, ep_len, ep_cnt])`` for a :class:`RockSample` env with at most
    128 cells and 30 rocks.

    ``seed`` is an int (Philox key; pass a new one to each chained call).
    ``rows_per_tile`` only sets the tape layout (it is the JAX kernel's
    tile height); ``rng_tape=True`` makes ``run`` take a trailing int32 tape
    of shape ``run.tape_shape`` in place of Philox.
    """
    rows_m, cols, k = env.rows, env.cols, env.k
    ncells = rows_m * cols
    if ncells > W:
        raise ValueError(f"map has {ncells} cells; fused kernel supports <= {W}")
    if k > MAX_ROCKS:
        raise ValueError(f"fused kernel packs rock quality into int32: "
                         f"k <= {MAX_ROCKS}")
    if num_envs % W:
        raise ValueError("num_envs must be a multiple of 128")
    R = min(rows_per_tile, num_envs // W)
    if num_envs % (R * W):
        raise ValueError("num_envs must divide into [rows_per_tile, 128] tiles")
    grid = num_envs // (R * W)
    time_limit = env.time_limit
    n_act = 5 + k
    div_act = UDiv.of(n_act)  # the kernel's u % n_act (u % 2^k is a mask)
    init_cell = int(env.init_pos_np[0]) * cols + int(env.init_pos_np[1])
    rock_at = np.full(ncells, k, np.int32)  # k: no rock
    rp = env.rock_positions_np
    rock_at[rp[:, 0] * cols + rp[:, 1]] = np.arange(k)
    tables: Dict[torch.device, torch.Tensor] = {}

    # draw sites per step, in body order: action, sensor uniform, reset
    # rock-quality mask
    n_sites = 3
    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid * slab, W)
    n_out = 3 + (3 if episode_stats else 0)
    rows = num_envs // W

    def rock_at_on(device) -> torch.Tensor:
        if device not in tables:
            tables[device] = torch.as_tensor(rock_at, device=device)
        return tables[device]

    def check(pos, mask, tape):
        check_batch(pos, rows, rng_tape, tape_shape, tape)
        check_batch(mask, rows, False, tape_shape, ())
        if mask.device != pos.device:
            raise ValueError("pos and mask must be on one device")

    def twin(seed: int, pos: torch.Tensor, mask: torch.Tensor,
             *tape: torch.Tensor):
        """Plain PyTorch version of the kernel, on ``pos``'s device."""
        check(pos, mask, tape)
        dev = pos.device
        rock_at_t = rock_at_on(dev)
        rng = KernelRNG(seed, num_envs, num_steps, n_sites, R,
                        tape=tape[0] if rng_tape else None, device=dev)
        pos, mask = pos.reshape(-1), mask.reshape(-1)
        bad = (pos < 0) | (pos >= ncells)  # inactive: -1, NaN sums
        pos = torch.where(bad, 0, pos)
        elapsed = torch.zeros_like(pos)
        racc = torch.zeros(num_envs, dtype=torch.float32, device=dev)
        cur_ret, ep_ret, ep_len, ep_cnt = (torch.zeros_like(racc) for _ in range(4))
        for step in range(num_steps):
            rng.begin_step(step)
            a = rng.rbits(n_act)
            y, x = pos // cols, pos % cols
            # movement (N=0 E=1 S=2 W=3); exit east off-grid terminates
            is_move = a < 4
            ny = y + torch.where(a == 0, -1, (a == 2).to(torch.int32))
            nx = x + torch.where(a == 3, -1, (a == 1).to(torch.int32))
            exited = is_move & (nx >= cols)
            inside = is_move & (ny >= 0) & (ny < rows_m) & (nx >= 0) & (nx < cols)
            pos2 = torch.where(inside, ny * cols + nx, pos)
            # sampling: the rock at the cell before the move
            ridx = rock_at_t[pos.long()]
            on_rock = ridx < k
            rbit = torch.clamp(ridx, max=k - 1)
            is_sample = a == 4
            sample_rew = torch.where(
                on_rock, torch.where(((mask >> rbit) & 1) == 1, GOOD_REWARD,
                                     BAD_PENALTY),
                ILLEGAL_SAMPLE_PENALTY).to(torch.float32)
            mask2 = torch.where(is_sample & on_rock, mask & ~(1 << rbit), mask)
            rng.runiform()  # sensor draw: taken, unused (module docstring)
            rew = torch.where(exited, EXIT_REWARD,
                              torch.where(is_sample, sample_rew, 0.0))
            elapsed = elapsed + 1
            reset = exited | (elapsed >= time_limit)  # >=
            if episode_stats:
                cur_ret = cur_ret + rew
                ep_ret = torch.where(reset, ep_ret + cur_ret, ep_ret)
                ep_len = torch.where(reset, ep_len + elapsed.to(torch.float32),
                                     ep_len)
                ep_cnt = torch.where(reset, ep_cnt + 1.0, ep_cnt)
                cur_ret = torch.where(reset, 0.0, cur_ret)
            new_mask = rng.rbits(1 << k)
            pos = torch.where(reset, init_cell, pos2)
            mask = torch.where(reset, new_mask, mask2)
            elapsed = torch.where(reset, 0, elapsed)
            racc = racc + rew
        rng.finalize(n_sites)
        outs = [torch.where(bad, -1, pos), torch.where(bad, -1, mask)]
        outs += [torch.where(bad, torch.nan, x)
                 for x in (racc, ep_ret, ep_len, ep_cnt)[:n_out - 2]]
        return tuple(o.reshape(rows, W) for o in outs)

    def run(seed: int, pos: torch.Tensor, mask: torch.Tensor,
            *tape: torch.Tensor):
        """One K-step rollout: the CUDA kernel on a CUDA tensor, the twin on
        a CPU tensor.  An env whose position lies outside the map comes out
        as ``pos' = mask' = -1`` with NaN sums on both paths."""
        check(pos, mask, tape)
        if pos.device.type == "cpu":
            return twin(seed, pos, mask, *tape)
        if pos.device.type != "cuda":
            raise ValueError(f"unsupported device {pos.device}")
        outs = [torch.empty_like(pos), torch.empty_like(pos)]
        outs += [torch.empty(pos.shape, dtype=torch.float32, device=pos.device)
                 for _ in range(n_out - 2)]
        stats = outs[3:] if episode_stats else [None] * 3
        P = _RockSampleParams(
            num_envs=num_envs, num_steps=num_steps, rows_per_tile=R,
            n_sites=n_sites, rows=rows_m, cols=cols, k=k, init_cell=init_cell,
            time_limit=time_limit, episode_stats=int(episode_stats),
            key0=seed & MASK32, key1=(seed >> 32) & MASK32, n_act=div_act)

        def ptr(x):
            return None if x is None else x.data_ptr()

        with torch.cuda.device(pos.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launcher()(
                ctypes.byref(P), ptr(pos), ptr(mask), ptr(rock_at_on(pos.device)),
                ptr(tape[0] if rng_tape else None), ptr(outs[0]), ptr(outs[1]),
                ptr(outs[2]), *map(ptr, stats), stream)
        if err:
            raise RuntimeError(f"fused_rocksample launch failed: CUDA error {err}")
        count_launch(run, "fused_rocksample")
        return tuple(outs)

    run.twin = twin
    run.launches = 0
    run.divisors = {"n_act": n_act}
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
