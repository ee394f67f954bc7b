"""Measurement probe of the fused Q trainer kernels on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_fused_qlearning [section ...]

Sections (all of them when none is named):

- ``sweep``: CUDA-event ms/call, us/step and train-steps/s of the one-step
  trainer on ``Taxi-v4`` (duplicates averaged) over K at B = 65,536 and
  over B at K = 256; then each option of the builders at the full width
  (B = 65,536, K = 256), the ROOMS trainers on ``Rooms-v0`` among them
  (one-step Q, Watkins and Peng Q(lambda), the actor-critic); then K = 1 called 256 times in a row, through the
  wrapper and replayed from a CUDA graph: the other design, one launch per
  step, with and without the host's work per launch;
- ``profile``: ``torch.profiler`` device time of 4 chained full-width calls
  against their wall time;
- ``variants``: copies of ``csrc/fused_qlearning.cu`` with one part taken
  out (the two grid barriers of each step, the atomics, the reload of the
  table into shared memory, the Philox rounds), built under
  ``build/gym_po_tpu_torch/probe_q/`` and timed beside the source as it is,
  to attribute the kernel's time, for the Taxi trainers and the ROOMS Q
  trainers.  The edited kernels compute wrong results; only their times
  are read.

Every line it prints is a measurement of this run; the first line is the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time

import torch

from .probe_fused_taxi import _device_us, _edit, _nvidia_smi, event_ms

B_FULL, K_FULL, LR, EPS = 65536, 256, 0.1, 0.1
SECTIONS = ("sweep", "profile", "variants")


def _setup(env_id="Taxi-v4", B=B_FULL, K=K_FULL, double=False, **opts):
    import gym_po_tpu_torch as gp
    from . import make_fused_double_q_trainer, make_fused_q_trainer
    from .fused_qlearning import bank_geometry

    dev = torch.device("cuda")
    env = gp.make(env_id, device=dev)
    if double:
        run = make_fused_double_q_trainer(env, B, K, **opts)
        rows = 2 * bank_geometry(env.tables.ns, 5)[1]
    else:
        opts.setdefault("average_duplicates", True)
        run = make_fused_q_trainer(env, B, K, **opts)
        rows = bank_geometry(int(env.observation_space.n), 5)[1]
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    carry = {"s": st.s.reshape(-1, 128).contiguous(),
             "q": torch.zeros((rows, 128), device=dev), "i": 0}

    def call():
        carry["i"] += 1
        carry["s"], carry["q"], _ = run(carry["i"], LR, EPS, carry["s"],
                                        carry["q"])

    return run, call


def _setup_rooms(kind: str, B=B_FULL, K=K_FULL, **opts):
    """A chained full-width call of a ROOMS trainer on the ``Rooms-v0``
    defaults: ``kind`` is ``q``, ``qlambda`` or ``ac``."""
    import gym_po_tpu_torch as gp
    from . import (
        make_fused_ac_trainer_rooms,
        make_fused_q_trainer_rooms,
        make_fused_qlambda_trainer_rooms,
    )

    dev = torch.device("cuda")
    env = gp.make("Rooms-v0", device=dev)
    build = {"q": make_fused_q_trainer_rooms,
             "qlambda": make_fused_qlambda_trainer_rooms,
             "ac": make_fused_ac_trainer_rooms}[kind]
    if kind != "ac":
        opts.setdefault("average_duplicates", True)
    run = build(env, B, K, **opts)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    a = st.agent_yx.to(torch.int32)
    carry = {"a": (a[:, 0] * env.grid_np.shape[1] + a[:, 1]).reshape(-1, 128)
             .contiguous(), "i": 0,
             "t": [torch.zeros((32, 128), device=dev)
                   for _ in range(2 if kind == "ac" else 1)]}

    def call():
        carry["i"] += 1
        if kind == "ac":
            *carry["t"], carry["a"], _ = run(carry["i"], 0.1, 0.2, *carry["t"],
                                             carry["a"])
        else:
            carry["a"], carry["t"][0], _ = run(carry["i"], LR, EPS, carry["a"],
                                               carry["t"][0])

    return run, call


ROOMS_OPTIONS = (
    ("Rooms-v0 one-step Q", "q", {}),
    ("Rooms-v0 Watkins Q(lambda) L=16", "qlambda", dict(lam=0.9, trace_len=16)),
    ("Rooms-v0 Peng Q(lambda) L=16", "qlambda",
     dict(lam=0.9, trace_len=16, watkins_cut=False)),
)


def _report(label: str, B: int, K: int, ms: float) -> None:
    print(f"{label} B={B} K={K}: {ms:.4f} ms/call {ms / K * 1e3:.3f} us/step "
          f"{B * K / ms * 1e3:.4e} train-steps/s", flush=True)


def sweep() -> None:
    for K in (16, 64, 256, 1024):
        _, call = _setup(K=K)
        _report("sweep K", B_FULL, K, event_ms(call))
    for B in (4096, 16384, 65536, 262144, 1 << 20):
        run, call = _setup(B=B)
        ms = event_ms(call)
        _report(f"sweep B, grid {run.grid} (blocks, envs/thread)", B, K_FULL, ms)
    for label, kw in (
        ("sum", dict(average_duplicates=False)),
        ("average + E-SARSA", dict(expected_sarsa=True)),
        ("HansenTaxi-v4", dict(env_id="HansenTaxi-v4")),
        ("ExtendedTaxi-v4", dict(env_id="ExtendedTaxi-v4")),
        ("Watkins Q(lambda) L=4", dict(lam=0.8, trace_len=4)),
        ("Watkins Q(lambda) L=16", dict(lam=0.9, trace_len=16)),
        ("double Q", dict(double=True)),
    ):
        _, call = _setup(**kw)
        _report(f"option {label}", B_FULL, K_FULL, event_ms(call))
    for label, kind, kw in ROOMS_OPTIONS + (("Rooms-v0 actor-critic", "ac", {}),):
        _, call = _setup_rooms(kind, **kw)
        _report(f"option {label}", B_FULL, K_FULL, event_ms(call))
    _, call = _setup(K=1)
    ms = event_ms(lambda: [call() for _ in range(K_FULL)], reps=2)
    _report("one launch per step: K=1 x 256 calls, per 256 steps", B_FULL,
            K_FULL, ms)
    # the same 256 launches replayed from a CUDA graph: no host work per
    # launch (the wrapper's allocations and zeroing become graph nodes)
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(K_FULL):
                call()
    except RuntimeError as err:  # a measurement we could not take
        print(f"one launch per step, CUDA graph: capture failed ({err})",
              flush=True)
        return
    ms = event_ms(graph.replay)
    _report("one launch per step: K=1 x 256 launches from a CUDA graph, per "
            "256 steps", B_FULL, K_FULL, ms)


def profile() -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    _, call = _setup()
    call()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    kern = _device_us(ka, "fused_q_kernel") / 1e3
    dev_ms = _device_us(ka) / 1e3
    print(f"profile 4 full-width calls: wall {wall * 1e3:.3f} ms, "
          f"fused_q_kernel device {kern:.3f} ms, all device {dev_ms:.3f} ms, "
          f"busy share {dev_ms / (wall * 1e3):.4f}", flush=True)


def variants() -> None:
    from . import fused_qlearning as fq
    from ._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

    sources = {h.name: h.read_text() for h in CSRC.glob("*.cuh")}
    sources["fused_qlearning.cu"] = (CSRC / "fused_qlearning.cu").read_text()

    def edited(name, old, new):
        return {**sources, name: _edit(sources[name], old, new)}

    atomic = ("  atomicAdd(reinterpret_cast<unsigned long long*>(acc + addr),\n"
              "            static_cast<unsigned long long>(fx));")
    no_atomics = edited("tabular.cuh", atomic,
                        "  if (fx == 0x7fffffffffffffffLL) acc[addr] = fx;")
    no_atomics["tabular.cuh"] = _edit(no_atomics["tabular.cuh"],
                                      "if (average) atomicAdd(cnt + addr, 1);",
                                      "(void)cnt;")
    cases = {
        "as-is": sources,
        "no-grid-barriers": {**sources, "fused_qlearning.cu": sources[
            "fused_qlearning.cu"].replace("grid.sync();", "__syncthreads();")},
        "no-atomics": no_atomics,
        "no-table-reload": edited("fused_qlearning.cu",
                                  "s_q[i] = __ldcg(q_out + i);", "(void)0;"),
        "philox-0-rounds": edited("kernel_rng.cuh",
                                  "for (int i = 0; i < 10; ++i)",
                                  "for (int i = 0; i < 0; ++i)"),
    }
    saved = fq._launcher
    for name, files in cases.items():
        d = BUILD_DIR / "probe_q" / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"),
                              str(d / "fused_qlearning.cu")],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.stderr}")
        regs = re.findall(r"Used (\d+) registers", out.stdout + out.stderr)
        lib = ctypes.CDLL(str(d / "lib.so"))

        def launcher(entry, lib=lib):
            fn = getattr(lib, entry)
            fn.argtypes = saved(entry).argtypes
            fn.restype = ctypes.c_int
            return fn

        fq._launcher = launcher
        try:
            for label, kw in (("fused_qlearning", {}),
                              ("fused_double_q", dict(double=True))):
                _, call = _setup(**kw)
                _report(f"variant {name} {label} (registers {','.join(regs)})",
                        B_FULL, K_FULL, event_ms(call))
            for label, kind, kw in ROOMS_OPTIONS:
                _, call = _setup_rooms(kind, **kw)
                _report(f"variant {name} {label}", B_FULL, K_FULL,
                        event_ms(call))
        finally:
            fq._launcher = saved


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device; none is available")
    names = argv or list(SECTIONS)
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"unknown section(s) {unknown}; choose from {SECTIONS}")
    print(_nvidia_smi("name,power.limit"), flush=True)
    sections = {"sweep": sweep, "profile": profile, "variants": variants}
    for name in names:
        sections[name]()
    print("clocks after:", _nvidia_smi(
        "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
