"""Timing and tracing helpers, PyTorch port of
:mod:`gym_po_tpu.utils.profiling`.

* :class:`Timer`: an accumulating wall-clock timer;
* :func:`steps_per_second`: a throughput meter that waits for the device
  of ``fn``'s output before it reads the clock;
* :func:`trace`: a ``torch.profiler`` session over a region, written as a
  Chrome trace (Perfetto reads it);
* :func:`annotate`: a named span on the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

from ..core import map_tensors

__all__ = ["steps_per_second", "trace", "annotate", "Timer"]


class Timer:
    """Accumulating wall-clock timer (``with timer: ...`` adds to
    ``elapsed``); the caller synchronises the device inside the block."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        return False


def _sync(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    devices = set()
    map_tensors(lambda t: devices.add(t.device) if t.is_cuda else None, out)
    for d in devices:
        torch.cuda.synchronize(d)


def steps_per_second(fn: Callable[..., Any], *args: Any, steps_per_call: int,
                     iters: int = 3, warmup: int = 1) -> float:
    """Env-steps/s of ``fn(*args)`` (any output tree of tensors).

    Make ``fn`` cover many env steps (a fused rollout) so that the launch
    cost is amortised; the clock is read after the device of ``fn``'s
    output has finished.
    """
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    dt = time.perf_counter() - t0
    return steps_per_call * iters / dt


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region (CPU, and CUDA where there is a card) and write its
    Chrome trace to ``log_dir/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span on the profiler's timeline (host, and the device work
    it launches)."""
    return torch.profiler.record_function(name)
