"""The discrete first layer's backward: a hand-written CUDA kernel and its
plain twin.

:func:`embed_grad` ``(grad [..., H], idx [...], n) -> (gw [H, n], gb [H])``
is the gradient of ``weight.t()[idx] + bias`` for a ``Linear(n, H)``: ``gw``
in the weight's own layout, each column ``o`` the sum of the rows of
``grad`` whose ``idx`` is ``o``, and ``gb`` the sum of all rows.  Both are
float32 (the parameters' type), summed in float32; for a bfloat16 ``grad``
(the compute dtype) each is rounded once to bfloat16, as XLA rounds the
one-hot product's gradient of the JAX package's first layer.

On a CUDA tensor it launches ``csrc/embed.cu`` (two passes: per row slice
a table of partial sums in shared memory, then the slices' partials summed
in a fixed order; see the source) or raises; on a CPU tensor it runs
:func:`embed_grad_twin`.  The kernel replaces PyTorch's index backward (a
sort, then a serial sum per run of equal observations) that autograd would
run for the index; it sums in a fixed order, so two calls on the same
inputs agree bit for bit, as a CUDA graph's replays must agree with eager
updates.  Its bound is the gradient's bytes, read once.  Launches:
``embed_grad.launches`` and ``_build.LAUNCHES["embed_grad"]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ._build import count_launch

__all__ = ["embed_grad", "embed_grad_twin", "plan"]

_G_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def embed_grad_twin(grad: torch.Tensor, idx: torch.Tensor,
                    n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`embed_grad`, on any device: a
    float32 ``index_add_`` in row order (on the CPU what autograd's index
    backward computes), the bias a ``sum`` over the rows."""
    H = grad.shape[-1]
    g = grad.reshape(-1, H).float()
    gw = torch.zeros(n, H, dtype=torch.float32, device=grad.device)
    gw.index_add_(0, idx.reshape(-1).long(), g)
    gb = g.sum(0)
    if grad.dtype != torch.float32:
        gw, gb = gw.to(grad.dtype).float(), gb.to(grad.dtype).float()
    return gw.t(), gb


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library("embed")
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.embed_grad_plan.argtypes = [i, ll, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.embed_grad_launch.argtypes = [i, ll, i, i, i, i, i] + [p] * 6
    lib.embed_grad_plan.restype = lib.embed_grad_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _plan(g_dtype: int, N: int, n: int, H: int,
          device_index: int) -> Tuple[int, int, int]:
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        err = _lib().embed_grad_plan(g_dtype, N, n, H, out)
    if err:
        raise RuntimeError(f"embed_grad_plan failed: CUDA error {err}")
    return tuple(out)


def plan(grad: torch.Tensor, idx: torch.Tensor, n: int) -> Tuple[int, int, int]:
    """The kernel's launch on these inputs: ``(P, T, tile)``, ``P`` row
    slices and ``T`` tiles of ``tile`` observations (one tile's sums are a
    block's shared memory); its scratch holds ``P * H * (n + T)`` floats."""
    H = grad.shape[-1]
    return _plan(_G_DTYPES[grad.dtype], idx.numel(), n, H,
                 grad.device.index if grad.device.index is not None
                 else torch.cuda.current_device())


def embed_grad(grad: torch.Tensor, idx: torch.Tensor,
               n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of a ``Linear(n, H)`` used as ``weight.t()[idx] +
    bias``, from its output's gradient ``grad [..., H]`` (float32 or
    bfloat16) and ``idx [...]`` (integers in ``[0, n)``; the kernel reads
    them as int32): ``(gw [H, n], gb [H])``, float32.  The kernel on a CUDA
    tensor, the twin on a CPU tensor."""
    if grad.shape[:-1] != idx.shape:
        raise ValueError(f"grad {tuple(grad.shape)} and idx {tuple(idx.shape)}: "
                         "one row of grad an index")
    if grad.device != idx.device:
        raise ValueError(f"grad on {grad.device}, idx on {idx.device}")
    if grad.device.type == "cpu":
        return embed_grad_twin(grad, idx, n)
    if grad.device.type != "cuda":
        raise ValueError(f"unsupported device {grad.device}")
    if grad.dtype not in _G_DTYPES:
        raise ValueError(f"the kernel takes a float32 or bfloat16 gradient, "
                         f"not {grad.dtype}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} observations: the kernel indexes them in int32")
    H = grad.shape[-1]
    g = grad.reshape(-1, H).contiguous()
    i = idx.reshape(-1).to(torch.int32).contiguous()
    P, T, _ = launch = plan(g, i, n)
    part = torch.empty(P * H * (n + T), dtype=torch.float32, device=g.device)
    gw = torch.empty(H, n, dtype=torch.float32, device=g.device)
    gb = torch.empty(H, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = _lib().embed_grad_launch(
            _G_DTYPES[g.dtype], i.numel(), n, H, *launch,
            g.data_ptr(), i.data_ptr(), part.data_ptr(), gw.data_ptr(),
            gb.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"embed_grad launch failed: CUDA error {err}")
    count_launch(embed_grad, "embed_grad")
    return gw, gb


embed_grad.launches = 0
