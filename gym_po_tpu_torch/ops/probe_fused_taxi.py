"""Measurement probe of the fused Taxi kernel on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_fused_taxi [section ...]

Sections (all of them when none is named):

- ``sweep``: CUDA-event ms/call and env-steps/s over B and K on
  ``HansenTaxi-v4``, and the other cells (maps, episode stats, greedy-table
  policy) at B = 2^20, K = 256;
- ``profile``: ``torch.profiler`` device time of 4 chained headline calls
  against their wall time, and of the ``step_vec`` rollout at B = 65,536;
- ``variants``: copies of the kernel's sources with one part taken out
  (the input range guard, the Philox rounds) or made a compile-time
  constant (the 5x5 map), built under
  ``build/gym_po_tpu_torch/probe/`` and timed beside the sources as they
  are, to attribute the kernel's time;
- ``spread``: ten repeats of ``chip_smoke.py``'s headline timing, for the
  run-to-run spread inside one process;
- ``acting``: ``entry.forward`` ms/step at B = 4,096 and 65,536, with the
  profiler's busy share and kernel launches per step.

Every line it prints is a measurement of this run; the first line is the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B_HEAD, K_HEAD = 1 << 20, 256
SECTIONS = ("sweep", "profile", "variants", "spread", "acting")


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def event_ms(fn, reps: int = 10, windows: int = 5) -> float:
    """Median over ``windows`` of the CUDA-event ms per call of ``reps``
    chained calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _setup(env_id="HansenTaxi-v4", B=B_HEAD, K=K_HEAD, **kw):
    import gym_po_tpu_torch as gp
    from . import make_fused_taxi_rollout

    dev = torch.device("cuda")
    env = gp.make(env_id, device=dev)
    run = make_fused_taxi_rollout(env, B, K, **kw)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    return env, run, st.s.reshape(-1, 128).contiguous()


def _report(label: str, B: int, K: int, ms: float) -> None:
    print(f"{label} B={B} K={K}: {ms:.4f} ms/call "
          f"{B * K / ms * 1e3:.4e} env-steps/s", flush=True)


def sweep() -> None:
    for B in (1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22):
        _, run, s = _setup(B=B)
        _report("sweep HansenTaxi-v4", B, K_HEAD, event_ms(lambda: run(1, s)))
    for K in (16, 64, 256, 1024):
        _, run, s = _setup(K=K)
        _report("sweep HansenTaxi-v4", B_HEAD, K, event_ms(lambda: run(1, s)))
    for env_id, kw in (("Taxi-v4", {}), ("ExtendedHansenTaxi-v4", {}),
                       ("HansenTaxi-v4", {"episode_stats": True})):
        _, run, s = _setup(env_id, **kw)
        _report(f"cell {env_id} {kw or ''}", B_HEAD, K_HEAD,
                event_ms(lambda: run(1, s)))
    import gym_po_tpu_torch as gp

    ns = gp.make("HansenTaxi-v4").tables.ns
    pol = np.random.default_rng(0).integers(0, 5, ns).astype(np.int32)
    _, run, s = _setup(policy=pol)
    _report("cell HansenTaxi-v4 greedy-table policy", B_HEAD, K_HEAD,
            event_ms(lambda: run(1, s)))


def _device_us(events, match=None) -> float:
    total = 0.0
    for e in events:
        if match is None or match in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
    return total


def profile() -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import gym_po_tpu_torch as gp
    from ..vector import rollout

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _, run, s = _setup()
    run(0, s)
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(4):
            run(i, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms = _device_us(prof.key_averages(), "fused_taxi") / 1e3
    print(f"profile 4 headline calls: wall {wall * 1e3:.3f} ms, "
          f"fused_taxi_kernel device {dev_ms:.3f} ms, busy share "
          f"{dev_ms / (wall * 1e3):.4f}", flush=True)

    env = gp.make("HansenTaxi-v4", device=torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    rollout(env, g, None, 65536, 4)
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rollout(env, g, None, 65536, 16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_ms = _device_us(ka) / 1e3
    n = sum(e.count for e in ka if e.device_type.name == "CUDA")
    print(f"profile step_vec rollout B=65536 16 steps: wall {wall * 1e3:.3f} ms, "
          f"device {dev_ms:.3f} ms, busy share {dev_ms / (wall * 1e3):.4f}, "
          f"{n} kernel launches", flush=True)


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"probe variant: {old!r} not in the kernel source")
    return text.replace(old, new)


@contextlib.contextmanager
def _launcher_from(lib_path):
    """Make ``make_fused_taxi_rollout``'s runs launch ``lib_path``'s entry."""
    from . import fused_taxi as ft

    fn = ctypes.CDLL(str(lib_path)).fused_taxi_launch
    fn.argtypes = ft._launcher().argtypes
    fn.restype = ctypes.c_int
    saved = ft._launcher
    ft._launcher = lambda: fn
    try:
        yield
    finally:
        ft._launcher = saved


def variants() -> None:
    from ._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

    files = {f.name: f.read_text()
             for f in [CSRC / "fused_taxi.cu", *CSRC.glob("*.cuh")]}
    cu, rng_h, step_h = (files[n] for n in (
        "fused_taxi.cu", "kernel_rng.cuh", "taxi_step.cuh"))
    cases = {  # name: the files it edits
        "as-is": {},
        "no-range-guard": {"fused_taxi.cu": _edit(
            cu, "if ((unsigned)s >= (unsigned)(P.nc * pd)) {", "if (false) {")},
        "philox-0-rounds": {"kernel_rng.cuh": _edit(
            rng_h, "for (int i = 0; i < 10; ++i)", "for (int i = 0; i < 0; ++i)")},
        "const-map-5x5": {"taxi_step.cuh": _edit(
            _edit(step_h, "const int nlocs = M.nlocs, cols = M.cols;",
                  "constexpr int nlocs = 4, cols = 5;"),
            "rbits(rng.draw(j++), M.rows)", "rbits(rng.draw(j++), 5)")},
    }
    _, run, s = _setup()  # looks its launcher up at each call
    for name, edits in cases.items():
        d = BUILD_DIR / "probe" / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in {**files, **edits}.items():
            (d / fname).write_text(text)
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"),
                              str(d / "fused_taxi.cu")],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.stderr}")
        regs = re.findall(r"Used (\d+) registers", out.stdout + out.stderr)
        with _launcher_from(d / "lib.so"):
            ms = event_ms(lambda: run(1, s))
        _report(f"variant {name} (registers {','.join(regs)})", B_HEAD, K_HEAD, ms)


def spread() -> None:
    _, run, s0 = _setup()
    state = {"s": s0}

    def call():
        state["s"], _ = run(1000, state["s"])

    call()
    reps = []
    for _ in range(10):
        windows = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                call()
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / 4 * 1e3)
        reps.append(statistics.median(windows))
    q = statistics.quantiles(reps, n=4)
    print(f"spread headline ms/call, 10 repeats of median of 5 windows x 4 "
          f"calls: {' '.join(f'{r:.4f}' for r in reps)}; median "
          f"{statistics.median(reps):.4f} q1 {q[0]:.4f} q3 {q[2]:.4f} "
          f"max/min-1 {max(reps) / min(reps) - 1:.4%}", flush=True)


def acting() -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from ..entry import entry

    dev = torch.device("cuda")
    for B in (4096, 65536):
        forward, (model, gen, obs, est) = entry(device=dev, num_envs=B)
        carry = {"obs": obs, "est": est}

        def step():
            carry["obs"], carry["est"], *_ = forward(model, gen, carry["obs"],
                                                     carry["est"])

        ms = event_ms(step, reps=20)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(20):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        dev_ms = _device_us(ka) / 1e3
        n = sum(e.count for e in ka if e.device_type.name == "CUDA")
        print(f"acting entry.forward B={B}: {ms:.4f} ms/step "
              f"{B / ms * 1e3:.4e} env-steps/s; profiled 20 steps busy share "
              f"{dev_ms / (wall * 1e3):.4f}, {n / 20:.1f} kernels/step",
              flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device; none is available")
    names = argv or list(SECTIONS)
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"unknown section(s) {unknown}; choose from {SECTIONS}")
    print(_nvidia_smi("name,power.limit"), flush=True)
    sections = {"sweep": sweep, "profile": profile, "variants": variants,
                "spread": spread, "acting": acting}
    for name in names:
        sections[name]()
    print("clocks after:", _nvidia_smi(
        "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
