"""The harness of the port's benchmark: cells, windows, traces and results.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``).
The traffic file's ``kind`` names the driver (``drivers/<kind>.py``) that
builds the cell's program state from the seed, enqueues one unit of work
at a time and checks what the timed units produced against the plain
reference (``reference/``).  A cell's own limits and check sizes are in
``workloads/<cell>.json``.  Every metric is a reader of its own
(``metrics/<name>.py``, or one that a family of names shares, see
:func:`metric_reader`; ``read(rec) -> value or None``), and every work
floor a function of shapes (``floors/<config>.<kind>.py``).  So a cell, a
configuration, a traffic kind or a metric is added as files and
``BENCHMARK.json`` entries alone.

The window: the driver's units are enqueued back to back for ``seconds``
on the host clock, at most ``IN_FLIGHT`` units ahead of the device (a CUDA
event after each unit), and the window ends when the device has finished
the last.  Rates are all the window's work over all its time.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "portbench"
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_po_tpu")
#: units the host may enqueue ahead of the device in a window
IN_FLIGHT = 4
#: the device op names that a trace's breakdown keeps
BREAKDOWN_TOP = 10
#: what the host does in an idle gap that the profiler itself makes
PROFILER_ACTIVITIES = ("Buffer Flush", "Activity Buffer Request")
#: the longest idle gaps that are named by what the host was doing
NAMED_GAPS = 64


class CellError(RuntimeError):
    """A cell that cannot run here: no card, too few cards, no program."""


# ---------------------------------------------------------------- lookups
def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module from a file, found by name (its file need not be a valid
    identifier, as ``floors/ext_hansen_taxi.ppo.py`` is not)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    """Everything a run of cell ``name`` reads: its entry, configuration,
    traffic, own file, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[cell["config"]]
    spec = {
        "cell": cell,
        "config": load_json(ROOT / conf_entry["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        "own": load_json(BENCH_DIR / "workloads" / f"{name}.json"),
    }
    spec["end_to_end"] = metrics_of(bench["end_to_end"], name)
    spec["per_layer"] = metrics_of(bench["per_layer"], name)
    return spec


def metrics_of(metrics: List[Dict[str, Any]], cell: str) -> List[Dict[str, Any]]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def driver(kind: str):
    return load_module(BENCH_DIR / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def floor_of(config_name: str, kind: str, config, traffic) -> Optional[Dict[str, Any]]:
    """The cell's work floor (``floors/<config>.<kind>.py``), or None."""
    path = BENCH_DIR / "floors" / f"{config_name}.{kind}.py"
    if not path.exists():
        return None
    mod = load_module(path, f"portbench_floor_{config_name}_{kind}".replace(".", "_"))
    return mod.floor(config, traffic)


def peaks(kind: str) -> Optional[Dict[str, Any]]:
    """The published peaks of a card (``peaks.json``), by its name."""
    return load_json(BENCH_DIR / "peaks.json").get(kind)


def metric_reader(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else the one
    of its longest leading part before a dot (``idle_pct.py`` for
    ``idle_pct.ppo.ant``), or of such a part's longest ending after an
    underscore (``steps_per_s.py`` for ``ppo_steps_per_s.taxi``)."""
    dots = name.split(".")
    for head in (".".join(dots[:i]) for i in range(len(dots), 0, -1)):
        parts = head.split("_")
        for stem in ("_".join(parts[i:]) for i in range(len(parts))):
            path = BENCH_DIR / "metrics" / f"{stem}.py"
            if path.exists():
                return path
    raise FileNotFoundError(f"no reader for metric {name!r} in {BENCH_DIR / 'metrics'}")


def read_metric(name: str, rec: Dict[str, Any]):
    path = metric_reader(name)
    mod = load_module(path, "portbench_metric_" + path.stem.replace(".", "_"))
    return mod.read(rec)


# ------------------------------------------------------------- the process
def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


_T_IMPORT = time.monotonic()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_root_ok(module) -> bool:
    """Whether ``module`` was loaded from this checkout."""
    return ROOT in Path(module.__file__).resolve().parents


# ------------------------------------------------------------------ window
def run_window(enqueue: Callable[[], int], seconds: float, torch,
               cuda: bool) -> Dict[str, Any]:
    """Enqueue units back to back for ``seconds`` (host clock), at most
    :data:`IN_FLIGHT` ahead of the device; returns the work done, the
    window's seconds (it ends when the device has finished) and each
    unit's device pacing (ms between the CUDA events after consecutive
    units, the first from an event before it)."""
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    events = []
    work = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if cuda and len(events) >= IN_FLIGHT:
            events[-IN_FLIGHT].synchronize()
        work += enqueue()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            events.append(None)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    unit_ms = []
    if cuda:
        prev = start
        for ev in events:
            unit_ms.append(prev.elapsed_time(ev))
            prev = ev
    return {"work": work, "units": len(events), "window_s": t1 - t0,
            "unit_ms": unit_ms}


# ------------------------------------------------------------------- trace
def traced_stretch(enqueue: Callable[[], int], units: int, torch) -> Dict[str, Any]:
    """``units`` units under torch.profiler (CPU and CUDA), the stretch
    ending in a synchronize; returns the device operations (name, start,
    duration, in ns), the host's spans and ops, and the stretch's bounds
    on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    work = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        enqueue()  # the profiler's own start-up lies outside the stretch
        torch.cuda.synchronize()
        with record_function("portbench.stretch"):
            for _ in range(units):
                with record_function("portbench.unit"):
                    work += enqueue()
            with record_function("portbench.sync"):
                torch.cuda.synchronize()
    dev, host = [], []
    bounds = None
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        dur = _ns(e, "duration")
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a span's shadow on the device's timeline is no device work
            if not (name.startswith("portbench.") or _annotation(e)):
                dev.append((name, start, dur))
        else:
            host.append((name, start, dur))
            if name == "portbench.stretch":
                bounds = (start, start + dur)
    if bounds is None:
        raise RuntimeError("the trace holds no portbench.stretch span")
    dev = [d for d in dev if d[1] + d[2] > bounds[0] and d[1] < bounds[1]]
    return {"device": dev, "host": host, "bounds": bounds, "units": units,
            "work": work}


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(tr: Dict[str, Any]) -> Dict[str, Any]:
    """Busy and window seconds, device time by op name, and the longest
    idle gaps named by what the host was doing then."""
    lo, hi = tr["bounds"]
    spans = [(max(s, lo), min(s + d, hi)) for _, s, d in tr["device"]]
    busy = union_ns(spans)
    by_name: Dict[str, float] = {}
    for name, s, d in tr["device"]:
        by_name[name] = by_name.get(name, 0.0) + d / 1e9
    gaps = []
    prev = lo
    for s, e in sorted(spans):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = {}
    profiler_s = 0.0
    for g0, g1 in gaps[:NAMED_GAPS]:
        key = _host_at(tr["host"], (g0 + g1) // 2)
        named[key] = named.get(key, 0.0) + (g1 - g0) / 1e9
        if key in PROFILER_ACTIVITIES:
            profiler_s += (g1 - g0) / 1e9
    return {
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "profiler_idle_s": profiler_s,
        "ops": len(tr["device"]),
        "op_seconds": by_name,
        "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP],
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP],
        "units": tr["units"],
        "work": tr["work"],
    }


def _host_at(host, t: int) -> str:
    """The innermost host op (or harness span) running at ``t``."""
    best, best_d = "idle host", None
    for name, s, d in host:
        if s <= t < s + d and name != "portbench.stretch":
            if best_d is None or d < best_d:
                best, best_d = name, d
    return best


# ----------------------------------------------------------------- results
def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Any], device: Dict[str, Any],
                checks: List[Dict[str, Any]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The contract's one JSON line; ``checks`` (each compared number
    with its limit) comes last."""
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out, allow_nan=True)


def check_ok(c: Dict[str, Any]) -> bool:
    v = c["value"]
    return v is not None and not (isinstance(v, float) and math.isnan(v)) \
        and v <= c["limit"]


def sub_seed(seed: int, i: int) -> int:
    """A 64-bit seed for unit ``i`` of a run of ``seed`` (splitmix64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return z ^ (z >> 31)


class KernelCell:
    """What the cells of one kernel call a unit share: the call warmed up
    ``WARM_CALLS`` times at set-up, then the window's calls offered to a
    :class:`Sampler`; the check counts the kept calls that failed in
    ``bad_units``."""

    trace_units = 16
    WARM_CALLS = 2

    def warm_up(self, seed: int, device) -> None:
        self.sampler = None
        for _ in range(self.WARM_CALLS):
            self.enqueue()
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        self.sampler = Sampler(seed)

    def offer(self, item) -> None:
        if self.sampler is not None:
            self.sampler.offer(item)

    def close_window(self) -> None:
        self.sampler.open = False

    def failed_units(self, checks) -> int:
        return self.bad_units


def max_gap(got, ref) -> float:
    """The largest absolute gap, infinite where it is not a number."""
    g = float((got.reshape(-1).float() - ref.reshape(-1).float()).abs().max())
    return g if g == g else float("inf")


class Sampler:
    """Which units of a window are kept for the check: the first, the
    last, and one drawn uniformly from all of them (a reservoir of one,
    drawn from the seed)."""

    def __init__(self, seed: int):
        import random

        self.rng = random.Random(seed)
        self.first = self.drawn = self.last = None
        self.n = 0
        self.open = True

    def offer(self, item) -> None:
        if not self.open:
            return
        self.n += 1
        if self.first is None:
            self.first = item
        elif self.rng.random() * (self.n - 1) < 1.0:
            self.drawn = item
        self.last = item

    def kept(self) -> list:
        out = []
        for item in (self.first, self.drawn, self.last):
            if item is not None and all(item is not o for o in out):
                out.append(item)
        return out
