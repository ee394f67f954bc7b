"""Wrapper and twin loop shared by the rollout kernels whose env state is a
tuple of ``[B // 128, 128]`` tiles: the CRooms rollout
(:mod:`.fused_crooms`) and the Tag and HeavenHell rollouts
(:mod:`.fused_tag`).

Each kernel ``csrc/<source>.cu`` has a C entry point ``<entry>(params, in,
out, tables, tape, stream)`` taking arrays of device pointers: the state
tiles in, the state tiles out, the reward sums and the three episode-stat
tiles (null without ``episode_stats``), and its tables.  Its ``params``
struct starts with :class:`Header`'s fields.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Sequence

import torch

from ._build import count_launch
from .kernel_rng import MASK32, KernelRNG, W

__all__ = ["Header", "make_state_rollout", "tiling"]


class Header(ctypes.Structure):
    """The fields every state-rollout params struct starts with (``struct
    RolloutHeader`` in the kernels)."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "num_envs", "num_steps", "rows_per_tile", "n_sites", "time_limit",
        "episode_stats")]
    _fields_ += [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)]


def tiling(num_envs: int, rows_per_tile: int):
    """``(R, tiles)`` of the JAX kernels' tape layout."""
    if num_envs % W:
        raise ValueError("num_envs must be a multiple of 128")
    R = min(rows_per_tile, num_envs // W)
    if num_envs % (R * W):
        raise ValueError("num_envs must divide into [rows_per_tile, 128] tiles")
    return R, num_envs // (R * W)


@functools.cache
def _launcher(source: str, entry: str):
    from ._build import load_library

    fn = getattr(load_library(source), entry)
    fn.argtypes = [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


def _ptrs(tensors):
    arr = (ctypes.c_void_p * max(len(tensors), 1))()
    for i, t in enumerate(tensors):
        arr[i] = None if t is None else t.data_ptr()
    return arr


def make_state_rollout(source: str, entry: str, count_name: str,
                       state_dtypes: Sequence[torch.dtype], n_sites: int,
                       num_envs: int, num_steps: int, rows_per_tile: int,
                       episode_stats: bool, rng_tape: bool, params_cls,
                       params: dict, step: Callable, tables_on=None,
                       table_names: Sequence[str] = ()):
    """``run(seed, *state, *tape)`` and its twin.

    ``step(tab, rng, state, elapsed) -> (state', rew, reset, ep_len,
    elapsed')`` is one twin step of every env over flat ``[B]`` tensors,
    drawing at its sites in the kernel's order (``state'`` after the
    respawns); ``tab`` is ``tables_on(device)`` (or None).  ``params`` fill
    ``params_cls`` beside the header's fields."""
    R, tiles = tiling(num_envs, rows_per_tile)
    tape_shape = (tiles * KernelRNG.tape_rows(n_sites, num_steps, R), W)
    rows = num_envs // W
    n_state = len(state_dtypes)

    def check(state, tape):
        if len(state) != n_state:
            raise ValueError(f"run takes {n_state} state tiles, got {len(state)}")
        if len(tape) != int(rng_tape):
            raise ValueError(f"run takes {int(rng_tape)} tape argument(s), got "
                             f"{len(tape)}")
        dev = state[0].device if isinstance(state[0], torch.Tensor) else None
        for i, (x, dt) in enumerate(zip(state, state_dtypes)):
            if (not isinstance(x, torch.Tensor) or x.dtype != dt
                    or tuple(x.shape) != (rows, W) or not x.is_contiguous()
                    or x.device != dev):
                raise ValueError(f"state tile {i} must be a contiguous {dt} "
                                 f"tensor of shape {(rows, W)} on one device")
        if rng_tape:
            tp = tape[0]
            if tuple(tp.shape) != tape_shape:
                raise ValueError(f"rng tape must have shape {tape_shape}, got "
                                 f"{tuple(tp.shape)}")
            if (tp.dtype != torch.int32 or tp.device != dev
                    or not tp.is_contiguous()):
                raise ValueError("rng tape must be a contiguous int32 tensor "
                                 "on the state's device")

    def twin(seed: int, *args: torch.Tensor):
        """Plain PyTorch version of the kernel, on the state's device."""
        state, tape = args[:n_state], args[n_state:]
        check(state, tape)
        dev = state[0].device
        tab = tables_on(dev) if tables_on else None
        rng = KernelRNG(seed, num_envs, num_steps, n_sites, R,
                        tape=tape[0] if rng_tape else None, device=dev)
        state = tuple(x.reshape(-1) for x in state)
        elapsed = torch.zeros(num_envs, dtype=torch.int32, device=dev)
        racc = torch.zeros(num_envs, dtype=torch.float32, device=dev)
        cur_ret, ep_ret, ep_len, ep_cnt = (torch.zeros_like(racc) for _ in range(4))
        for t in range(num_steps):
            rng.begin_step(t)
            state, rew, reset, length, elapsed = step(tab, rng, state, elapsed)
            if episode_stats:
                cur_ret = cur_ret + rew
                ep_ret = torch.where(reset, ep_ret + cur_ret, ep_ret)
                ep_len = torch.where(reset, ep_len + length.to(torch.float32),
                                     ep_len)
                ep_cnt = torch.where(reset, ep_cnt + 1.0, ep_cnt)
                cur_ret = torch.where(reset, 0.0, cur_ret)
            racc = racc + rew
        rng.finalize(n_sites)
        outs = (*state, racc) + ((ep_ret, ep_len, ep_cnt) if episode_stats else ())
        return tuple(o.reshape(rows, W) for o in outs)

    def run(seed: int, *args: torch.Tensor):
        """One K-step rollout: the CUDA kernel on CUDA tensors, the twin on
        CPU tensors."""
        state, tape = args[:n_state], args[n_state:]
        check(state, tape)
        dev = state[0].device
        if dev.type == "cpu":
            return twin(seed, *args)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        outs = [torch.empty_like(x) for x in state]
        outs += [torch.empty((rows, W), dtype=torch.float32, device=dev)
                 for _ in range(4 if episode_stats else 1)]
        stats = outs[n_state + 1:] if episode_stats else [None] * 3
        P = params_cls(num_envs=num_envs, num_steps=num_steps, rows_per_tile=R,
                       n_sites=n_sites, episode_stats=int(episode_stats),
                       key0=seed & MASK32, key1=(seed >> 32) & MASK32, **params)
        tab = tables_on(dev) if tables_on else {}
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launcher(source, entry)(
                ctypes.byref(P), _ptrs(state), _ptrs(outs[:n_state + 1] + stats),
                _ptrs([tab[n] for n in table_names]),
                tape[0].data_ptr() if rng_tape else None, stream)
        if err:
            raise RuntimeError(f"{entry} failed: CUDA error {err}")
        count_launch(run, count_name)
        return tuple(outs)

    run.twin = twin
    run.launches = 0
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
