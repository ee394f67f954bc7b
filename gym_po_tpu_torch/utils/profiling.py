"""Timing and tracing helpers, PyTorch port of
:mod:`gym_po_tpu.utils.profiling`.

* :class:`Timer`: an accumulating wall-clock timer;
* :func:`trace`: a ``torch.profiler`` session over a region, spans on
  inside it, written as a Chrome trace (Perfetto reads it);
* :func:`annotate`: a named span, a no-op unless spans are on
  (:func:`enable_spans`).  On the host it is a ``record_function``; where
  the work is on a CUDA device it also puts a begin and an end marker on
  the device's current stream, so a CUDA graph captured with spans on
  replays the span on the device timeline;
* :func:`host_seconds`: the host's seconds in each span while spans are
  on, on the program's own clock (no profiler needed);
* :func:`counter` / :func:`count_nonzero` / :func:`read_counters`: counts
  that kernels and their CPU twins add to on the device while spans are on;
* the markers' naming contract: :func:`marker_name`, read back by
  :func:`parse_marker` and :func:`pair_markers`.

A marker is an empty ``extern "C"`` kernel (its device name is its C name)
called :data:`MARKER_PREFIX` + ``begin_`` or ``end_`` + the span's name
with each ``.`` written ``__``: ``gpt_span_begin_ppo__collect``.  Spans
nest by containment on one stream; the n-th span of a name in a trace of
n updates belongs to the n-th update.
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["trace", "annotate", "Timer", "enable_spans", "spans_enabled",
           "host_seconds", "counter", "count_nonzero", "read_counters", "marker_name",
           "parse_marker", "pair_markers", "MARKER_PREFIX", "SPAN_NAMES"]

MARKER_PREFIX = "gpt_span_"
#: the spans that can mark a CUDA device, whose markers are built into one
#: library when first needed
SPAN_NAMES = ("ppo.collect", "env.step", "ant.forward", "ppo.learn")
# a span with device markers: words of letters and digits joined by single
# dots or underscores, so that "__" can only stand for "."
_MARKED_NAME = re.compile(r"[A-Za-z0-9]+(?:[._][A-Za-z0-9]+)*")

_SPANS = False
_OFF = contextlib.nullcontext()
_COUNTERS: Dict[Tuple[str, torch.device], torch.Tensor] = {}
_HOST_S: Dict[str, float] = {}


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


def enable_spans(on: bool) -> None:
    """Turn :func:`annotate`'s spans and the device counters on or off for
    the whole process (off by default).  A CUDA graph keeps the spans and
    counters of the state it was captured in."""
    global _SPANS
    _SPANS = bool(on)


def spans_enabled() -> bool:
    return _SPANS


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region (CPU, and CUDA where there is a card) with spans on,
    and write its Chrome trace to ``log_dir/trace.json``; yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    previous = spans_enabled()
    enable_spans(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        enable_spans(previous)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str, device=None):
    """A span ``name`` around the work of a ``with`` block: with spans off
    one shared do-nothing context; with spans on a host
    ``record_function`` and, where ``device`` is a CUDA device, a begin and
    an end marker on its current stream (``name`` one of
    :data:`SPAN_NAMES`)."""
    if not _SPANS:
        return _OFF
    return _Span(name, device)


def host_seconds() -> Dict[str, float]:
    """Host seconds spent in each span, by name, while spans were on."""
    return dict(_HOST_S)


class _Span:
    def __init__(self, name: str, device):
        self.name = name
        self.host = torch.profiler.record_function(name)
        self.device = None
        if device is not None and torch.device(device).type == "cuda":
            if name not in SPAN_NAMES:
                raise ValueError(f"span {name!r} has no device markers: add it to "
                                 "SPAN_NAMES")
            self.device = torch.device(device)
            self.launch, self.which = _marker_library(), SPAN_NAMES.index(name)

    def _mark(self, end: bool) -> None:
        with torch.cuda.device(self.device):
            err = self.launch(2 * self.which + end,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"span marker launch failed: CUDA error {err}")

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.host.__enter__()
        if self.device is not None:
            self._mark(False)
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            self._mark(True)
        out = self.host.__exit__(*exc)
        _HOST_S[self.name] = _HOST_S.get(self.name, 0.0) + time.perf_counter() - self.t0
        return out


# ---------------------------------------------------------------- markers

def marker_name(span: str, begin: bool) -> str:
    """The device name of ``span``'s begin or end marker."""
    if not _MARKED_NAME.fullmatch(span):
        raise ValueError(f"span name {span!r}: a device span's name is words of "
                         "letters and digits joined by single '.' or '_'")
    return f"{MARKER_PREFIX}{'begin' if begin else 'end'}_{span.replace('.', '__')}"


def parse_marker(kernel: str) -> Optional[Tuple[str, bool]]:
    """``(span, begin)`` of a marker's device name, None for any other
    kernel."""
    if not kernel.startswith(MARKER_PREFIX):
        return None
    kind, _, code = kernel[len(MARKER_PREFIX):].partition("_")
    if kind not in ("begin", "end") or not code:
        return None
    return code.replace("__", "."), kind == "begin"


def pair_markers(events: Iterable[Tuple[str, int, int]]) -> Dict[str, List[Tuple[int, int]]]:
    """Each span's ``(start, end)`` intervals, in order, from markers
    ``(device name, start, duration)`` on one stream: a span runs from its
    begin marker's start to its end marker's end, and the markers of
    nested spans nest.  Raises on a marker left unmatched."""
    spans: Dict[str, List[Tuple[int, int]]] = {}
    open_: List[Tuple[str, int]] = []
    for kernel, start, dur in sorted(events, key=lambda e: e[1]):
        span, begin = parse_marker(kernel)
        if begin:
            open_.append((span, start))
        elif not open_ or open_[-1][0] != span:
            raise ValueError(f"end marker of {span!r} at {start} closes "
                             f"{open_[-1][0] if open_ else 'no span'!r}")
        else:
            spans.setdefault(span, []).append((open_.pop()[1], start + dur))
    if open_:
        raise ValueError(f"begin markers left open: {[s for s, _ in open_]}")
    return spans


def _marker_source(names: Tuple[str, ...]) -> str:
    kernels, cases = [], []
    for i, name in enumerate(names):
        for end in (0, 1):
            kernel = marker_name(name, not end)
            kernels.append(f'extern "C" __global__ void {kernel}() {{}}\n')
            cases.append(f"    case {2 * i + end}: {kernel}<<<1, 1, 0, st>>>(); break;\n")
    return ("// span markers: empty kernels named for their spans\n"
            "#include <cuda_runtime.h>\n" + "".join(kernels)
            + 'extern "C" int gpt_span_mark(int which, void* stream) {\n'
            "  cudaStream_t st = (cudaStream_t)stream;\n  switch (which) {\n"
            + "".join(cases)
            + "    default: return (int)cudaErrorInvalidValue;\n  }\n"
            "  return (int)cudaGetLastError();\n}\n")


@functools.cache
def _marker_library():
    """The markers' launcher, ``gpt_span_mark(2 * span index + end,
    stream)``, built when a marker is first needed."""
    import ctypes

    from ..ops._build import load_source

    lib = load_source("span_markers", _marker_source(SPAN_NAMES))
    lib.gpt_span_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.gpt_span_mark.restype = ctypes.c_int
    return lib.gpt_span_mark


# --------------------------------------------------------------- counters

def counter(name: str, device) -> Optional[torch.Tensor]:
    """The int64 counter ``name`` on ``device`` that work adds to in place
    while spans are on (made at its first use, which must not be under
    CUDA-graph capture); None with spans off."""
    if not _SPANS:
        return None
    device = torch.device(device)
    key = (name, device)
    if key not in _COUNTERS:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"counter {name!r} is first used under CUDA-graph "
                               "capture: turn spans on before the eager call "
                               "that precedes the capture")
        _COUNTERS[key] = torch.zeros((), dtype=torch.int64, device=device)
    return _COUNTERS[key]


def count_nonzero(name: str, flags: torch.Tensor) -> None:
    """Add the nonzero entries of ``flags`` to the counter ``name`` on their
    device, where spans are on (the CPU twins of a kernel that counts)."""
    if _SPANS:
        counter(name, flags.device).add_(torch.count_nonzero(flags))


def read_counters() -> Dict[str, int]:
    """Every counter's value, summed over devices, by name (one sync a
    device)."""
    by_device: Dict[torch.device, List[Tuple[str, torch.Tensor]]] = {}
    for (name, device), c in _COUNTERS.items():
        by_device.setdefault(device, []).append((name, c))
    out: Dict[str, int] = {}
    for items in by_device.values():
        values = torch.stack([c for _, c in items]).tolist()
        for (name, _), v in zip(items, values):
            out[name] = out.get(name, 0) + int(v)
    return out
