"""Debug-mode runtime checks, PyTorch port of :mod:`gym_po_tpu.utils.debug`.

The failure modes of a functional env step are numeric (NaN) and indexing
(an index out of range, an integer division by zero).  :func:`checked`
wraps any function so that each of them raises where it first happens,
naming the operation, instead of spreading silently: the counterpart of
``jax.experimental.checkify`` with its float, index and division checks.
It watches every ATen operation the function runs (a
``TorchDispatchMode``), so it costs a check per operation: a debug mode,
not a fast path.  Usage::

    step = checked(env.step_vec)
    obs, state, *rest = step(generator, state, action)  # raises on NaN/OOB

:func:`assert_finite` checks a fetched result on the host.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import map_tensors

__all__ = ["checked", "assert_finite", "CheckError"]

_aten = torch.ops.aten
# ops whose integer index argument selects along a dimension: (op, the
# position of the index tensor, the position of the dim, or None for dim 0)
_INDEXED = {
    _aten.index_select.default: (2, 1),
    _aten.gather.default: (2, 1),
    _aten.index_add.default: (2, 1),
    _aten.index_add_.default: (2, 1),
    _aten.index_put.default: (1, None),
    _aten.index_put_.default: (1, None),
    _aten.index.Tensor: (1, None),
    _aten.scatter.src: (2, 1),
    _aten.scatter_.src: (2, 1),
    _aten.scatter_add.default: (2, 1),
    _aten.scatter_add_.default: (2, 1),
    _aten.take.default: (1, None),
}
_DIVISIONS = {_aten.div.Tensor_mode, _aten.div_.Tensor_mode,
              _aten.remainder.Tensor, _aten.fmod.Tensor, _aten.floor_divide.default}


class CheckError(FloatingPointError):
    """A NaN, an index out of range or an integer division by zero, with the
    operation that made it."""


def _check_index(op, args) -> None:
    pos, dim_pos = _INDEXED[op]
    src = args[0]
    idx = args[pos]
    if dim_pos is None:
        if op is _aten.take.default:
            size, idxs = src.numel(), [idx]
        else:  # a list of index tensors, one per leading dim
            idxs = [i for i in idx if i is not None]
            sizes = [src.shape[d] for d, i in enumerate(idx) if i is not None]
            for i, n in zip(idxs, sizes):
                _bounds(op, i, n)
            return
    else:
        dim = args[dim_pos]
        size, idxs = (src.shape[dim] if src.dim() else 1), [idx]
    for i in idxs:
        _bounds(op, i, size)


def _bounds(op, idx, size: int) -> None:
    if not isinstance(idx, torch.Tensor) or idx.dtype == torch.bool or idx.numel() == 0:
        return
    if bool(((idx < -size) | (idx >= size)).any()):
        raise CheckError(f"{op}: index out of range for size {size} "
                         f"(min {int(idx.min())}, max {int(idx.max())})")


def _integral(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point()
    return isinstance(x, int)


class _Checks(TorchDispatchMode):
    """Raise at the first operation that makes a NaN, indexes out of range
    or divides an integer by zero."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _INDEXED:
            _check_index(func, args)
        if func in _DIVISIONS and len(args) > 1 and _integral(args[0]) \
                and _integral(args[1]) and bool((torch.as_tensor(args[1]) == 0).any()):
            raise CheckError(f"{func}: integer division by zero")
        out = func(*args, **kwargs)

        def nan(t: torch.Tensor) -> None:
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise CheckError(f"{func}: nan in its output")

        map_tensors(nan, out)
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` run under the float, index and division checks: the first
    operation that makes a NaN, indexes out of range or divides an integer
    by zero raises :class:`CheckError` naming it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _Checks():
            return fn(*args, **kwargs)

    return wrapper


def assert_finite(tree, name: str = "tree") -> None:
    """Host-side check that every floating tensor or array of ``tree`` is
    finite; raises ``FloatingPointError`` naming the first that is not."""
    bad = []

    def check(t: torch.Tensor) -> None:
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad.append(t)

    map_tensors(check, tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}")
