"""Measurement probe of the fused Taxi kernel on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_fused_taxi [section ...] [--parent DIR]

Sections (``sweep profile variants spread acting`` when none is named;
``ab`` needs ``--parent``; ``sass`` and ``rates`` run only when named):

- ``sweep``: CUDA-event ms/call and env-steps/s over B and K on
  ``HansenTaxi-v4``, and the other cells (maps, episode stats, greedy-table
  policy) at B = 2^20, K = 256;
- ``profile``: ``torch.profiler`` device time of 4 chained headline calls
  against their wall time, and of the ``step_vec`` rollout at B = 65,536;
- ``variants``: copies of the Taxi and RockSample rollouts' sources with
  one part taken out (the input range guard, the Philox rounds), made a
  compile-time constant (the 5x5 map) or put back as the parent design had
  it (``runtime-div``: ``gpt::udiv`` divides by its runtime ``n``, so every
  draw's ``u % n`` is a hardware division sequence again), built under
  ``build/gym_po_tpu_torch/probe/`` and timed beside the sources as they
  are (Taxi on ``HansenTaxi-v4``, RockSample at [7,8] and (11,11)), to
  attribute the kernels' time;
- ``spread``: ten repeats of ``chip_smoke.py``'s headline timing, for the
  run-to-run spread inside one process;
- ``acting``: ``entry.forward`` ms/step at B = 4,096 and 65,536, with the
  profiler's busy share and kernel launches per step;
- ``ab``: the Taxi and RockSample rollouts built from ``--parent DIR`` (a
  ``csrc`` directory, e.g. one unpacked by ``git archive <commit>
  gym_po_tpu_torch/csrc``) against the current sources in one process, at
  B = 2^20, K = 256: Taxi on ``HansenTaxi-v4`` (random policy and a greedy
  table) and on ``ExtendedHansenTaxi-v4``, RockSample at [7,8] and
  (11,11); each the median of 5 CUDA-event windows of 4 calls per source,
  the two sources' windows alternating;
- ``sass``: for the Taxi and RockSample rollouts (and, with ``--parent``,
  the parent's), each kernel's registers and spills (ptxas) and its
  ``MUFU.RCP`` and ``I2F.U32.RP`` (the runtime integer division's float
  reciprocal), in all and inside loops (``cuobjdump -sass``; a loop is the
  span of a backward branch); then every ``csrc/*.cu`` built as it is and
  with Philox at 0 rounds, and per kernel the instructions inside loops by
  pipe (FMA: ``IMAD*``, float add/multiply; ALU: ``LOP3``, ``IADD3``,
  ``SHF``, ``ISETP``, ``SEL``, ...) in both builds and their difference:
  the Philox rounds' cost in a step, from which the bounds are counted;
- ``rates``: lanes per SM per clock of ``IMAD.WIDE.U32``, ``IMAD``,
  ``LOP3``, of ``IMAD.WIDE.U32`` interleaved with ``LOP3``, and of a
  Philox half-round (a ``LOP3`` feeding an ``IMAD.WIDE.U32``), each from
  eight independent chains per thread, 2,048 threads per SM, timed by each
  SM's own ``clock64`` (the SASS of each loop printed beside it): the pipe
  rates behind the bounds.

Every line it prints is a measurement of this run; the first line is the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

B_HEAD, K_HEAD = 1 << 20, 256
SECTIONS = ("sweep", "profile", "variants", "spread", "acting", "ab", "sass",
            "rates")
DEFAULT_SECTIONS = ("sweep", "profile", "variants", "spread", "acting")
ROCK_CELLS = (((7, 7), 8), ((11, 11), 11))  # chip_smoke.py's path 4


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


def _setup_rock(map_size, k, B=B_HEAD, K=K_HEAD):
    import gym_po_tpu_torch as gp
    from . import make_fused_rocksample_rollout, rock_bitmask

    dev = torch.device("cuda")
    env = gp.make("RockSample-v0", map_size=map_size, num_rocks=k, device=dev)
    run = make_fused_rocksample_rollout(env, B, K)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    pos = (st.pos_yx[:, 0] * env.cols + st.pos_yx[:, 1]).to(torch.int32)
    return env, run, (pos.reshape(-1, 128).contiguous(),
                      rock_bitmask(st.rock_good).reshape(-1, 128).contiguous())


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
def _launcher_from(module, lib_path, entry):
    """Make ``module``'s wrappers (``fused_taxi`` or ``fused_rocksample``)
    launch ``lib_path``'s ``entry``.  A Taxi library from before the
    invariant divisors takes the argument list without them."""
    fn = getattr(ctypes.CDLL(str(lib_path)), entry)
    fn.restype = ctypes.c_int
    want = module._launcher().argtypes
    launch = fn
    if entry == "fused_taxi_launch" and not _has_symbol(lib_path, "udiv_check_launch"):
        fn.argtypes = want[:-2] + want[-1:]

        def launch(*args):  # the divisors are the next-to-last argument
            return fn(*args[:-2], args[-1])
    else:
        fn.argtypes = want
    saved = module._launcher
    module._launcher = lambda: launch
    try:
        yield
    finally:
        module._launcher = saved


def _has_symbol(lib_path, name: str) -> bool:
    try:
        getattr(ctypes.CDLL(str(lib_path)), name)
    except AttributeError:
        return False
    return True


def _sources(src: Path, name: str) -> dict:
    """``name``.cu and every header of ``src``."""
    return {f.name: f.read_text() for f in [src / f"{name}.cu", *src.glob("*.cuh")]}


def _nvcc_builds(jobs: list) -> list:
    """Writes each job's ``(directory, name, files)`` and builds
    ``name``.cu there, every nvcc at once; returns ``(library, nvcc
    output)`` per job."""
    from ._build import NVCC_FLAGS, _nvcc

    def build(job):
        d, name, files = job
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(d / f"{name}.so"),
                              str(d / f"{name}.cu")], capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed in {d} for {name}:\n{out.stderr}")
        return d / f"{name}.so", out.stdout + out.stderr

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(build, jobs))


# the helper's quotient as the hardware's runtime division: the parent
# design's u % n and u / n in every reduction
RUNTIME_DIV = ("kernel_rng.cuh",
               "return (uint32_t)(((uint64_t)d.mul * u + d.add) >> 32) >> d.sh;",
               "return u / d.n;")
PHILOX_0 = ("kernel_rng.cuh", "for (int i = 0; i < 10; ++i)",
            "for (int i = 0; i < 0; ++i)")
# kernel: {variant: edits (file, old, new)}
VARIANTS = {
    "fused_taxi": {
        "as-is": [],
        "no-range-guard": [("fused_taxi.cu",
                            "if ((unsigned)s >= (unsigned)(P.nc * pd)) {",
                            "if (false) {")],
        "philox-0-rounds": [PHILOX_0],
        "runtime-div": [RUNTIME_DIV],
        # the 5x5 map's divisors and widths as compile-time constants
        "const-map-5x5": [
            ("taxi_step.cuh", "rbits(u, nlocs1)", "rbits(u, 3)"),
            ("taxi_step.cuh", "rbits(u, nlocs)", "rbits(u, 4)"),
            ("taxi_step.cuh", "rbits(u, rows)", "rbits(u, 5)"),
            ("taxi_step.cuh", "rbits(u, cols)", "rbits(u, 5)"),
            ("taxi_step.cuh", "  const int nlocs = M.nlocs;\n  const int moved",
             "  constexpr int nlocs = 4;\n  const int moved"),
            ("taxi_step.cuh", "rc_new = rr * M.cols", "rc_new = rr * 5")],
    },
    "fused_rocksample": {
        "as-is": [],
        "philox-0-rounds": [PHILOX_0],
        "runtime-div": [RUNTIME_DIV],
    },
}


def _edited(files: dict, edits) -> dict:
    files = dict(files)
    for fname, old, new in edits:
        files[fname] = _edit(files[fname], old, new)
    return files


def variants() -> None:
    from . import fused_rocksample, fused_taxi
    from ._build import BUILD_DIR, CSRC

    jobs = [(BUILD_DIR / "probe" / kernel / name, kernel,
             _edited(_sources(CSRC, kernel), edits))
            for kernel, cases in VARIANTS.items()
            for name, edits in cases.items()]
    t0 = time.perf_counter()
    built = _nvcc_builds(jobs)
    print(f"variants: {len(jobs)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    setups = {"fused_taxi": [("HansenTaxi-v4", _setup()[1:])],
              "fused_rocksample": [
                  (f"RockSample{ms + (k,)}", _setup_rock(ms, k)[1:])
                  for ms, k in ROCK_CELLS]}
    modules = {"fused_taxi": fused_taxi, "fused_rocksample": fused_rocksample}
    for (d, kernel, _), (lib, log) in zip(jobs, built):
        regs = ",".join(re.findall(r"Used (\d+) registers", log))
        for cell, (run, state) in setups[kernel]:
            state = state if isinstance(state, tuple) else (state,)
            with _launcher_from(modules[kernel], lib, f"{kernel}_launch"):
                ms = event_ms(lambda: run(1, *state))
            _report(f"variant {kernel} {d.name} {cell} (registers {regs})",
                    B_HEAD, K_HEAD, ms)


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


def ab(parent: str) -> None:
    """The parent's Taxi and RockSample rollouts against the current ones,
    windows alternating in one process."""
    from . import fused_rocksample, fused_taxi
    from ._build import BUILD_DIR, CSRC
    from .probe_fused_qlearning import _window_ms

    modules = {"fused_taxi": fused_taxi, "fused_rocksample": fused_rocksample}
    jobs = [(BUILD_DIR / "probe" / f"ab-{who}" / kernel, kernel,
             _sources(src, kernel))
            for who, src in (("parent", Path(parent)), ("current", CSRC))
            for kernel in modules]
    libs = {(d.parent.name[3:], kernel): lib
            for (d, kernel, _), (lib, _) in zip(jobs, _nvcc_builds(jobs))}
    import numpy as np

    import gym_po_tpu_torch as gp

    pol = np.random.default_rng(0).integers(
        0, 5, gp.make("HansenTaxi-v4", device="cpu").tables.ns).astype(np.int32)
    cases = [("[1] HansenTaxi-v4 random policy", "fused_taxi",
              lambda: _setup()[1:]),
             ("[1] HansenTaxi-v4 greedy-table policy", "fused_taxi",
              lambda: _setup(policy=pol)[1:]),
             ("[1] ExtendedHansenTaxi-v4 random policy", "fused_taxi",
              lambda: _setup("ExtendedHansenTaxi-v4")[1:])]
    cases += [(f"[7] RockSample{ms + (k,)}", "fused_rocksample",
               lambda ms=ms, k=k: _setup_rock(ms, k)[1:]) for ms, k in ROCK_CELLS]
    for label, kernel, setup in cases:
        run, state = setup()
        state = state if isinstance(state, tuple) else (state,)
        times = {"parent": [], "current": []}

        def timed(who, window):
            with _launcher_from(modules[kernel], libs[who, kernel],
                                f"{kernel}_launch"):
                if window:
                    times[who].append(_window_ms(lambda: run(1, *state)))
                else:
                    run(1, *state)

        for who in times:  # warm-up
            timed(who, False)
        for w in range(5):
            for who in (("parent", "current") if w % 2 == 0
                        else ("current", "parent")):
                timed(who, True)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"ab {label} B={B_HEAD} K={K_HEAD}: parent {med['parent']:.4f} "
              f"ms/call, current {med['current']:.4f} ms/call, current/parent "
              f"{med['current'] / med['parent']:.4f} (medians of 5 windows x 4 "
              f"calls; windows parent "
              f"{', '.join(f'{x:.4f}' for x in times['parent'])}; current "
              f"{', '.join(f'{x:.4f}' for x in times['current'])})", flush=True)


# ------------------------------------------------------------------ SASS
_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNCTION = re.compile(r"Function : (\S+)")
DIVISION_OPS = ("MUFU.RCP", "I2F.U32.RP")  # the runtime integer division's
PIPE_OPS = {  # the first word of an opcode, by the pipe that executes it
    "fma": ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "HADD2", "HMUL2"),
    "alu": ("LOP3", "IADD3", "SHF", "ISETP", "SEL", "LEA", "IMNMX", "VIMNMX",
            "FSEL", "FSETP", "FMNMX", "PLOP3", "MOV", "PRMT", "IABS", "BMSK",
            "SGXT", "P2R", "R2P"),
    "xu": ("MUFU", "I2F", "F2I", "F2F", "I2I", "POPC", "FLO", "BREV", "FRND"),
}


def sass_functions(lib_path) -> dict:
    """``{function: [(address, opcode, operands), ...]}`` of a library's
    device code, from ``cuobjdump -sass``."""
    from ._build import _nvcc

    text = subprocess.run(
        [str(Path(_nvcc()).with_name("cuobjdump")), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = out.setdefault(_demangled(m.group(1)), [])
            continue
        m = _SASS.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def _demangled(name: str) -> str:
    filt = shutil.which("c++filt")
    if not filt:
        return name
    return subprocess.run([filt, name], capture_output=True, text=True).stdout.strip()


def in_loops(instrs) -> list:
    """The instructions inside the span of some backward branch."""
    spans = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:  # not the trailing self-branch
            spans.append((int(m.group(1), 16), addr))
    return [i for i in instrs if any(a <= i[0] <= b for a, b in spans)]


def pipe_counts(instrs) -> collections.Counter:
    """Instructions by pipe (``fma``, ``alu``, ``xu``; ``uniform`` for the
    uniform datapath's, ``other`` for memory, control and the rest) and in
    all (``issue``, NOPs left out)."""
    c = collections.Counter()
    for _, op, _ in instrs:
        if op == "NOP":
            continue
        word = op.split(".")[0]
        pipe = next((p for p, ops in PIPE_OPS.items() if word in ops), None)
        c[pipe or ("uniform" if word.startswith("U") else "other")] += 1
        c["issue"] += 1
    return c


def division_counts(lib_path) -> dict:
    """Per kernel function: ``{op: (in all, inside loops)}`` for the
    runtime integer division's ``MUFU.RCP`` and ``I2F.U32.RP``, and
    ``"loops"``: the instructions inside loops (0: no loop was found, and
    the counts inside loops say nothing)."""
    out = {}
    for fn, instrs in sass_functions(lib_path).items():
        loops = in_loops(instrs)
        out[fn] = {op: (sum(i[1].startswith(op) for i in instrs),
                        sum(i[1].startswith(op) for i in loops))
                   for op in DIVISION_OPS}
        out[fn]["loops"] = len(loops)
    return out


def ptxas_report(log: str) -> dict:
    """``{function: 'N registers, S B spill stores, L B spill loads'}``
    from nvcc's ``-Xptxas -v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _demangled(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, {out.get(fn, '')}"
    return out


ALL_SOURCES = ("fused_taxi", "fused_qlearning", "fused_rooms", "fused_ac",
               "fused_msrooms", "fused_rocksample", "fused_crooms",
               "fused_q_crooms", "fused_tag")


def sass(parent=None) -> None:
    from ._build import BUILD_DIR, CSRC

    jobs = [(BUILD_DIR / "probe" / "sass" / tag / kernel, kernel,
             _edited(_sources(CSRC, kernel), edits))
            for tag, edits in (("current", []), ("philox-0-rounds", [PHILOX_0]))
            for kernel in ALL_SOURCES]
    if parent:
        jobs += [(BUILD_DIR / "probe" / "sass" / "parent" / kernel, kernel,
                  _sources(Path(parent), kernel))
                 for kernel in ("fused_taxi", "fused_rocksample")]
    t0 = time.perf_counter()
    built = _nvcc_builds(jobs)
    print(f"sass: {len(jobs)} libraries built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    results = dict(zip([(d.parent.name, k) for d, k, _ in jobs], built))
    for who in ("current", "parent") if parent else ("current",):
        for kernel in ("fused_taxi", "fused_rocksample"):
            lib, log = results[who, kernel]
            regs = ptxas_report(log)
            for fn, counts in division_counts(lib).items():
                if "_kernel" not in fn:
                    continue
                print(f"sass {who} {fn}: " + ", ".join(
                    f"{op} {counts[op][0]} ({counts[op][1]} inside loops)"
                    for op in DIVISION_OPS)
                    + f"; {counts['loops']} instructions inside loops; "
                    + regs.get(fn, "registers not reported"), flush=True)
    keys = ("fma", "alu", "xu", "uniform", "other", "issue")
    for kernel in ALL_SOURCES:
        base = sass_functions(results["current", kernel][0])
        zero = sass_functions(results["philox-0-rounds", kernel][0])
        for fn, instrs in base.items():
            if "_kernel" not in fn or fn not in zero:
                continue
            loop = in_loops(instrs)
            a, b = pipe_counts(loop), pipe_counts(in_loops(zero[fn]))
            wide = sum(1 for _, op, args in loop if op.startswith("IMAD.WIDE")
                       and re.search(PHILOX_IMMEDIATES, args))
            print(f"philox {kernel} {fn}: inside loops as-is "
                  + " ".join(f"{k} {a[k]}" for k in keys) + "; 0 rounds "
                  + " ".join(f"{k} {b[k]}" for k in keys) + "; difference "
                  + " ".join(f"{k} {a[k] - b[k]}" for k in keys)
                  + f"; IMAD.WIDE.U32 by a Philox multiplier inside loops {wide}",
                  flush=True)


# the Philox multipliers as SASS prints an immediate (signed or not)
PHILOX_IMMEDIATES = r"0x2daee0ad|0x326172a9|0xd2511f53|0xcd9e8d57"


# ----------------------------------------------------------------- rates
RATES_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// One instruction kind in eight independent chains per thread, iters
// times; each block records its SM and its clock64 span.  KIND 0:
// IMAD.WIDE.U32 (w = lo(w) * M + w); 1: IMAD (a = a * M + s); 2: LOP3
// (a = (a ^ s) & (a | t)); 3: four chains of 0 and four of 2, interleaved;
// 4: a Philox half-round, w = (lo(w) ^ hi(w) ^ s) * M (one three-input
// XOR, one IMAD.WIDE.U32 with no addend).
template <int KIND>
__global__ void __launch_bounds__(256, 4) rate_kernel(uint32_t s, uint32_t t,
                                                   int iters, uint32_t* sink,
                                                   long long* span) {
  uint32_t a[8];
  uint64_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = s * (threadIdx.x + 1) + i;
    w[i] = ((uint64_t)t << 32) | a[i];
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool wide = KIND == 0 || (KIND == 3 && (i & 1) == 0);
      if (KIND == 4)
        w[i] = (uint64_t)((uint32_t)w[i] ^ (uint32_t)(w[i] >> 32) ^ s) * 0xD2511F53u;
      else if (wide)
        w[i] = (uint64_t)(uint32_t)w[i] * 0xD2511F53u + w[i];
      else if (KIND == 1)
        a[i] = a[i] * 0xCD9E8D57u + s;
      else
        a[i] = (a[i] ^ s) & (a[i] | t);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) x ^= a[i] ^ (uint32_t)w[i] ^ (uint32_t)(w[i] >> 32);
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x;
  if (threadIdx.x == 0) {
    uint32_t sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    span[3 * blockIdx.x] = sm;
    span[3 * blockIdx.x + 1] = t0;
    span[3 * blockIdx.x + 2] = t1;
  }
}

extern "C" int rate_launch(int kind, int blocks, int iters, void* sink,
                           void* span, void* stream) {
  void (*k)(uint32_t, uint32_t, int, uint32_t*, long long*) =
      kind == 0 ? rate_kernel<0> : kind == 1 ? rate_kernel<1>
      : kind == 2 ? rate_kernel<2> : kind == 3 ? rate_kernel<3> : rate_kernel<4>;
  k<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      0x9E3779B9u, 0x7F4A7C15u, iters, (uint32_t*)sink, (long long*)span);
  return (int)cudaGetLastError();
}
"""
RATE_KINDS = ("IMAD.WIDE.U32", "IMAD", "LOP3", "IMAD.WIDE.U32 + LOP3",
              "LOP3 then IMAD.WIDE.U32 (a Philox half-round)")


def rates() -> None:
    from ._build import BUILD_DIR

    [(lib, log)] = _nvcc_builds([(BUILD_DIR / "probe" / "rates", "rates",
                                  {"rates.cu": RATES_SRC})])
    fn = ctypes.CDLL(str(lib)).rate_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096  # 2,048 threads per SM
    sink = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    span = torch.empty(3 * blocks, dtype=torch.int64, device="cuda")
    funcs = sass_functions(lib)
    for kind, label in enumerate(RATE_KINDS):
        for _ in range(2):  # the second launch is the one read
            err = fn(kind, blocks, iters, sink.data_ptr(), span.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rate_launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        sp = span.view(-1, 3).cpu()
        per_sm = []
        for sm in sp[:, 0].unique():
            rows = sp[sp[:, 0] == sm]
            cycles = int(rows[:, 2].max() - rows[:, 1].min())
            per_sm.append(len(rows) * 256 * iters * 8 / cycles)
        loop = next((in_loops(v) for k, v in funcs.items()
                     if f"rate_kernel<{kind}>" in k), [])
        ops = collections.Counter(op for _, op, _ in loop)
        print(f"rates {label}: {statistics.median(per_sm):.2f} lanes/SM/clock "
              f"(median of {len(per_sm)} SMs, min {min(per_sm):.2f}, max "
              f"{max(per_sm):.2f}); loop SASS "
              + ", ".join(f"{k} x{v}" for k, v in ops.most_common(8)), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device; none is available")
    argv = list(argv)
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = argv[i + 1]
        del argv[i:i + 2]
    names = argv or list(DEFAULT_SECTIONS)
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"unknown section(s) {unknown}; choose from {SECTIONS}")
    if "ab" in names and not parent:
        raise SystemExit("ab needs --parent DIR (the parent's csrc directory)")
    print(_nvidia_smi("name,power.limit"), flush=True)
    sections = {"sweep": sweep, "profile": profile, "variants": variants,
                "spread": spread, "acting": acting,
                "ab": lambda: ab(parent), "sass": lambda: sass(parent),
                "rates": rates}
    for name in names:
        sections[name]()
    print("clocks after:", _nvidia_smi(
        "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
