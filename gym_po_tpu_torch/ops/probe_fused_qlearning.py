"""Measurement probe of the fused trainer kernels on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_fused_qlearning [section ...] [--parent DIR|variant:NAME]

Sections (``sweep profile variants floor`` when none is named; ``ab``
needs ``--parent``; ``touched`` runs only when named):

- ``sweep``: CUDA-event ms/call, us/step and train-steps/s of the one-step
  trainer on ``Taxi-v4`` (duplicates averaged) over K at B = 65,536 and
  over B at K = 256; then each option of the builders at the full width
  (B = 65,536, K = 256), the ROOMS trainers on ``Rooms-v0`` among them
  (one-step Q, Watkins and Peng Q(lambda), the actor-critic); then K = 1 called 256 times in a row, through the
  wrapper and replayed from a CUDA graph: the other design, one launch per
  step, with and without the host's work per launch;
- ``profile``: ``torch.profiler`` device time of 4 chained full-width calls
  against their wall time;
- ``variants``: copies of ``csrc/fused_qlearning.cu`` and
  ``csrc/fused_ac.cu`` (with their headers) with one part taken out or
  swapped (:data:`VARIANTS`: the grid barriers, the atomics, the table
  reload, the Philox rounds, the actor-critic's logf/expf, the one-step
  trainers' sums forced off chip, fewer and fatter blocks, ...), built under
  ``build/gym_po_tpu_torch/probe_q/`` and timed beside the source as it is,
  to attribute the time of the Taxi Q and double-Q trainers, the ROOMS Q,
  Watkins and Peng Q(lambda) trainers, the actor-critic and the MSRooms Q
  trainer; the opcodes of
  each build's atomics (``cuobjdump -sass``) are printed beside it.  Most
  edited kernels compute wrong results and only their times are read; the
  variants that swap in another way to the same sums are held to the source
  as it is, exactly.  With ``--parent DIR`` the same variants are built from
  ``DIR``'s sources as well;
- ``ab``: the sources in ``--parent DIR`` (a ``csrc`` directory, e.g. one
  unpacked by ``git archive <commit> gym_po_tpu_torch/csrc``), or with
  ``--parent variant:NAME`` the current sources with one of
  :data:`VARIANTS`' edits, against the current ones in one process:
  Watkins and Peng Q(lambda) and the actor-critic on ROOMS, the one-step
  trainers on ROOMS, MSRooms and Taxi, Watkins Q(lambda) and double Q on
  Taxi at B = 65,536, then ROOMS and Taxi Q (the one-step trainers' slab
  side), double Q and ExtendedTaxi-v4's Q (the global side) at B = 2^20,
  each the median of 5 CUDA-event windows of 4 chained calls per source,
  the two sources' windows alternating;
- ``floor``: K steps of ``grid.sync()`` alone, at the block counts of the
  ROOMS trainers' and the Taxi trainer's launches: the barrier's floor per
  step;
- ``touched``: how much a block's shared-memory slab can aggregate in the
  one-step trainers at full width: per step, the distinct table entries
  that a block's 256 envs update (the global atomics of its flush) against
  its 256 terms, from one twin call of each on the card.

Every line it prints is a measurement of this run; the first line is the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .probe_fused_taxi import _device_us, _edit, _nvidia_smi, event_ms

B_FULL, K_FULL, LR, EPS = 65536, 256, 0.1, 0.1
SECTIONS = ("sweep", "profile", "variants", "ab", "floor", "touched")
DEFAULT_SECTIONS = ("sweep", "profile", "variants", "floor")


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

    call.carry = carry
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

    call.carry = carry
    return run, call


def _setup_msrooms(B=B_FULL, K=K_FULL):
    """A chained full-width call of the one-step Q trainer on
    ``MultistoryFourRooms-v0`` at grid_z = 3, duplicates averaged."""
    import gym_po_tpu_torch as gp
    from . import make_fused_q_trainer_msrooms

    dev = torch.device("cuda")
    env = gp.make("MultistoryFourRooms-v0", grid_z=3, device=dev)
    run = make_fused_q_trainer_msrooms(env, B, K, average_duplicates=True)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    zyx = st.agent_zyx.to(torch.int32)
    _, H, GW = env.grid_np.shape
    carry = {"a": (zyx[:, 0] * H * GW + zyx[:, 1] * GW + zyx[:, 2])
             .reshape(-1, 128).contiguous(),
             "q": torch.zeros((32, 128), device=dev), "i": 0}

    def call():
        carry["i"] += 1
        carry["a"], carry["q"], _ = run(carry["i"], LR, EPS, carry["a"],
                                        carry["q"])

    call.carry = carry
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


def _lit(text: str) -> str:
    return re.escape(text)


# name -> (edits, exact): each edit (file, regex, replacement) is applied
# wherever its text is found, so one variant covers the parent's sources
# and the current ones; a variant none of whose edits applies is not built.
# "exact" variants reach the same sums another way and are held to the
# source as it is.
VARIANTS = {
    "as-is": ([], True),
    "no-grid-barriers": ([
        ("fused_qlearning.cu", _lit("grid.sync();"), "__syncthreads();"),
        ("fused_ac.cu", _lit("grid.sync();"), "__syncthreads();"),
    ], False),
    "no-atomics": ([
        ("tabular.cuh", _lit(
            "  atomicAdd(reinterpret_cast<unsigned long long*>(acc + addr),\n"
            "            static_cast<unsigned long long>(fx));"),
         "  if (fx == 0x7fffffffffffffffLL) acc[addr] = fx;"),
        ("tabular.cuh", _lit("if (average) atomicAdd(cnt + addr, 1);"),
         "(void)cnt;"),
        ("fused_ac.cu", _lit("atomicAdd(cnt + qidx, 1);"), "(void)cnt;"),
        ("tabular.cuh", _lit(
            "const unsigned int carry = atomicAdd(h, lo) + lo < lo;\n"
            "    if (hi + carry) atomicAdd(h + 1, hi + carry);"),
         "if (fx == ~0ull) *h = lo + hi;"),
        ("tabular.cuh", _lit("{ atomicAdd(s_cnt + o, 1); }"), "{ (void)o; }"),
    ], False),
    # the block sums' shared-memory atomics out, their flush kept
    "no-shared-atomics": ([
        ("tabular.cuh", _lit(
            "const unsigned int carry = atomicAdd(h, lo) + lo < lo;\n"
            "    if (hi + carry) atomicAdd(h + 1, hi + carry);"),
         "if (fx == ~0ull) *h = lo + hi;"),
        ("tabular.cuh", _lit("{ atomicAdd(s_cnt + o, 1); }"),
         "{ s_cnt[o] = 1; }"),
    ], False),
    # the block sums' flush as plain read-modify-writes, not atomics
    "no-global-atomics": ([
        ("tabular.cuh", _lit("atomicAdd(gc + o, k);"), "gc[o] += k;"),
        ("tabular.cuh", _lit(
            "atomicAdd(reinterpret_cast<unsigned long long*>(g + j * n + o),\n"
            "                  s_sum[j * n + o]);"),
         "g[j * n + o] += s_sum[j * n + o];"),
    ], False),
    "no-table-reload": ([
        ("fused_qlearning.cu", _lit("s_q[i] = __ldcg(q_out + i);"), "(void)0;"),
        ("fused_ac.cu", _lit("s_th[i] = __ldcg(th_out + i);"), "(void)0;"),
        ("fused_ac.cu", _lit("s_v[i] = __ldcg(v_out + i);"), "(void)0;"),
    ], False),
    "philox-0-rounds": ([
        ("kernel_rng.cuh", _lit("for (int i = 0; i < 10; ++i)"),
         "for (int i = 0; i < 0; ++i)"),
    ], False),
    # the actor-critic's transcendentals out: each Gumbel logf pair becomes
    # the uniform itself (its draw stays live), each expf the constant 1
    "no-libm": ([
        ("fused_ac.cu", _lit("-logf(-logf(u))"), "u"),
        ("fused_ac.cu", _lit("expf(__fsub_rn(lg[a], mx))"), "1.0f"),
    ], False),
    # the block sums' 64-bit add as one 64-bit shared atomic
    "shared-u64-atomics": ([
        ("tabular.cuh", _lit(
            "const unsigned int carry = atomicAdd(h, lo) + lo < lo;\n"
            "    if (hi + carry) atomicAdd(h + 1, hi + carry);"),
         "atomicAdd(s_sum + j * n + o, fx);\n    (void)h, (void)lo, (void)hi;"),
    ], True),
    # the flush as two TMA bulk reductions of the whole slab, one thread
    "bulk-flush": ([
        ("tabular.cuh", r"  __device__ void flush\(int t\) const \{.*?\n  \}\n",
         """  __device__ void flush(int t) const {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned sa = (unsigned)__cvta_generic_to_shared(s_sum);
      const unsigned ca = (unsigned)__cvta_generic_to_shared(s_cnt);
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 "
          "[%0], [%1], %2;" :: "l"(sums(t)), "r"(sa),
          "r"((unsigned)(kPer * n * 8)) : "memory");
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 "
          "[%0], [%1], %2;" :: "l"(counts(t)), "r"(ca),
          "r"((unsigned)(n * 4)) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      asm volatile("fence.proxy.async.global;" ::: "memory");
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kPer * n; i += blockDim.x) s_sum[i] = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_cnt[i] = 0;
  }
"""),
    ], True),
    # the Q(lambda) trace ring always in its global [L, B] buffer, never in
    # shared memory (the first edit finds sources that still have
    # coop_geometry_slots, the second the current ones)
    "global-ring": ([
        ("tabular.cuh", _lit("if (err == cudaSuccess && *envs_per_thread == 1) {"),
         "if (err == cudaSuccess && *envs_per_thread == 1 && false) {"),
        ("fused_qlearning.cu",
         _lit("sizeof(int) * (size_t)P->trace_len * gpt::kTrainerThreads, 1,"),
         "sizeof(int) * (size_t)P->trace_len * gpt::kTrainerThreads, 0,"),
    ], True),
    # the one-step trainers' update sums always straight into the global
    # accumulator, never through the block's slab
    "global-sums": ([
        ("fused_qlearning.cu", _lit("gpt::coop_geometry_room(kern, base, slab, "
                                    "gpt::kMaxEnvsPerThread,"),
         "gpt::coop_geometry_room(kern, base, slab, 0,"),
    ], True),
    # fewer, fatter blocks: at least two envs per thread, so more terms
    # share a slab word (every trainer; the Q(lambda) ring then goes to its
    # global buffer)
    "fat-blocks": ([
        ("tabular.cuh", _lit("const long long need = (num_envs + kTrainerThreads "
                             "- 1) / kTrainerThreads;"),
         "const long long need = (num_envs + 2 * kTrainerThreads - 1) / "
         "(2 * kTrainerThreads);"),
    ], True),
}

# the kernels each variant is timed on: (label, setup)
TIMED = (
    ("Taxi-v4 Q", lambda: _setup()),
    ("Taxi-v4 double Q", lambda: _setup(double=True)),
    *((label, lambda kind=kind, kw=kw: _setup_rooms(kind, **kw))
      for label, kind, kw in ROOMS_OPTIONS),
    ("Rooms-v0 actor-critic", lambda: _setup_rooms("ac")),
    ("MultistoryFourRooms-v0 grid_z=3 Q", _setup_msrooms),
)
EXACT = ROOMS_OPTIONS + (("Rooms-v0 actor-critic", "ac", {}),)


def _sources(src: Path) -> dict:
    files = {h.name: h.read_text() for h in src.glob("*.cuh")}
    for name in ("fused_qlearning.cu", "fused_ac.cu"):
        files[name] = (src / name).read_text()
    return files


def _edited(files: dict, name: str) -> tuple:
    """``files`` with variant ``name``'s edits: ``(files, edits applied)``."""
    text, applied = dict(files), 0
    for f, pattern, new in VARIANTS[name][0]:
        text[f], n = re.subn(pattern, lambda m, new=new: new, text[f],
                             flags=re.S)
        applied += n
    return text, applied


def _build_dirs(jobs: list, strict: bool = True) -> list:
    """Writes each job's ``(directory, files)`` and builds both trainers'
    libraries there, every nvcc at once; returns, per job, ``{name: (CDLL,
    nvcc output)}``, or (``strict=False``) the nvcc error of a job that did
    not build."""
    from ._build import NVCC_FLAGS, _nvcc

    for d, files in jobs:
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)

    def build(job):
        d, name = job
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(d / f"{name}.so"),
                              str(d / f"{name}.cu")], capture_output=True,
                             text=True)
        if out.returncode:
            err = f"nvcc failed in {d} for {name}:\n{out.stderr}"
            if strict:
                raise RuntimeError(err)
            return None, err
        return True, out.stdout + out.stderr

    names = ("fused_qlearning", "fused_ac")
    with ThreadPoolExecutor(8) as pool:
        logs = list(pool.map(build, [(d, n) for d, _ in jobs for n in names]))
    out = []
    for i, (d, _) in enumerate(jobs):
        failed = [log for ok, log in logs[2 * i:2 * i + 2] if not ok]
        out.append("\n".join(failed) if failed else {
            n: (ctypes.CDLL(str(d / f"{n}.so")), logs[2 * i + k][1])
            for k, n in enumerate(names)})
    return out


def _atomics(lib_path: Path) -> str:
    """The atomic opcodes in ``lib_path``'s SASS, with their counts."""
    from ._build import _nvcc

    sass = subprocess.run([str(Path(_nvcc()).with_name("cuobjdump")), "-sass",
                           str(lib_path)], capture_output=True, text=True).stdout
    ops = collections.Counter(re.findall(
        r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", sass))
    return ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())) or "none"


@contextlib.contextmanager
def _launchers(libs: dict):
    """Make the trainer wrappers launch ``libs``' entry points.  A parent's
    actor-critic with separate theta and v accumulators is adapted to the
    current wrapper's scratch (its accumulators are zero where it reads)."""
    from . import fused_ac as fa
    from . import fused_qlearning as fq

    saved_q, saved_ac = fq._launcher, fa._launcher
    new_ac = saved_ac()
    q_lib, (ac_lib, old_ac) = libs["fused_qlearning"], libs["fused_ac"]

    def q_launcher(entry):
        fn = getattr(q_lib, entry)
        fn.argtypes = saved_q(entry).argtypes
        fn.restype = ctypes.c_int
        return fn

    fn = ac_lib.fused_ac_launch
    fn.restype = ctypes.c_int
    if old_ac:
        fn.argtypes = [ctypes.POINTER(fa._ACParams)] + [ctypes.c_void_p] * 17

        def ac_fn(P, *ptrs):  # acc_th, acc_v, cnt: carved out of acc, cnt
            p = P._obj
            acc = ptrs[7]
            return fn(P, *ptrs[:7], acc, acc + 8 * p.n_act * p.nsp, *ptrs[8:])
    else:
        fn.argtypes = new_ac.argtypes
        ac_fn = fn
    fq._launcher, fa._launcher = q_launcher, lambda: ac_fn
    try:
        yield
    finally:
        fq._launcher, fa._launcher = saved_q, saved_ac


def _libs_of(built: dict, src_files: dict) -> dict:
    return {"fused_qlearning": built["fused_qlearning"][0],
            "fused_ac": (built["fused_ac"][0], "acc_v" in src_files["fused_ac.cu"])}


def _outputs(kind: str, kw: dict):
    """One full-width call from a fixed start: its agents and tables."""
    _, call = _setup_rooms(kind, **kw)
    call()
    torch.cuda.synchronize()
    return (call.carry["a"], *call.carry["t"])


def variants(parent=None) -> None:
    from ._build import BUILD_DIR, CSRC

    roots = [("", CSRC)] + ([("parent ", Path(parent))] if parent else [])
    jobs = []  # (tag, name, exact, edited sources, edits applied)
    for tag, src in roots:
        files = _sources(src)
        for name, (edits, exact) in VARIANTS.items():
            text, applied = _edited(files, name)
            if edits and not applied:
                print(f"variant {tag}{name}: no edit applies to these sources",
                      flush=True)
                continue
            jobs.append((tag, name, exact, text, applied))
    dirs = [BUILD_DIR / "probe_q" / (tag.strip() or "current") / name
            for tag, name, *_ in jobs]
    t0 = time.perf_counter()
    builds = _build_dirs([(d, job[3]) for d, job in zip(dirs, jobs)],
                         strict=False)
    print(f"variants: {2 * len(jobs)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reference = None
    for d, (tag, name, exact, text, applied), built in zip(dirs, jobs, builds):
        if isinstance(built, str):
            print(f"variant {tag}{name}: did not build\n{built[-2000:]}",
                  flush=True)
            continue
        regs = {k: ",".join(re.findall(r"Used (\d+) registers", v[1]))
                for k, v in built.items()}
        print(f"variant {tag}{name}: {applied} edits; registers {regs}; "
              f"atomics fused_qlearning [{_atomics(d / 'fused_qlearning.so')}]"
              f", fused_ac [{_atomics(d / 'fused_ac.so')}]", flush=True)
        with _launchers(_libs_of(built, text)):
            if name == "as-is":
                reference = [_outputs(kind, kw) for _, kind, kw in EXACT]
            elif exact:
                for (label, kind, kw), want in zip(EXACT, reference):
                    same = all(torch.equal(g, w) for g, w in
                               zip(_outputs(kind, kw), want))
                    print(f"variant {tag}{name} {label}: "
                          f"{'equals' if same else 'DIFFERS FROM'} the "
                          "source as it is", flush=True)
            for label, setup in TIMED:
                _, call = setup()
                _report(f"variant {tag}{name} {label}", B_FULL, K_FULL,
                        event_ms(call, reps=4))


def _window_ms(call, calls: int = 4) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


# label, B, setup (K = K_FULL); at B = 2^20 the one-step trainers' slab
# stays on chip for ROOMS and Taxi-v4, and double Q and ExtendedTaxi-v4's
# table take the global side
AB_CASES = (
    ("[12] Rooms-v0 Watkins Q(lambda) L=16", B_FULL,
     lambda: _setup_rooms("qlambda", lam=0.9, trace_len=16)),
    ("[12] Rooms-v0 Peng Q(lambda) L=16", B_FULL,
     lambda: _setup_rooms("qlambda", lam=0.9, trace_len=16, watkins_cut=False)),
    ("[13] Rooms-v0 actor-critic", B_FULL, lambda: _setup_rooms("ac")),
    ("[3] Rooms-v0 one-step Q", B_FULL, lambda: _setup_rooms("q")),
    ("[4] MultistoryFourRooms-v0 grid_z=3 Q", B_FULL, _setup_msrooms),
    ("[2] Taxi-v4 Q", B_FULL, lambda: _setup()),
    ("[2] Taxi-v4 Watkins Q(lambda) L=16", B_FULL,
     lambda: _setup(lam=0.9, trace_len=16)),
    ("[11] Taxi-v4 double Q", B_FULL, lambda: _setup(double=True)),
    ("[3] Rooms-v0 one-step Q", 1 << 20, lambda: _setup_rooms("q", B=1 << 20)),
    ("[2] Taxi-v4 Q", 1 << 20, lambda: _setup(B=1 << 20)),
    ("[11] Taxi-v4 double Q", 1 << 20, lambda: _setup(double=True, B=1 << 20)),
    ("[2] ExtendedTaxi-v4 Q", 1 << 20,
     lambda: _setup(env_id="ExtendedTaxi-v4", B=1 << 20)),
)


def ab(parent) -> None:
    """Parent against current sources, windows alternating in one process.
    ``parent`` is a ``csrc`` directory, or ``variant:NAME``: the current
    sources with that variant's edits."""
    from ._build import BUILD_DIR, CSRC

    current = _sources(CSRC)
    if parent.startswith("variant:"):
        base, applied = _edited(current, parent.split(":", 1)[1])
        if not applied:
            raise SystemExit(f"{parent}: no edit applies to the sources")
    else:
        base = _sources(Path(parent))
    srcs = {"parent": base, "current": current}
    built = _build_dirs([(BUILD_DIR / "probe_q" / f"ab-{who}", files)
                         for who, files in srcs.items()])
    libs = {who: _libs_of(b, srcs[who]) for who, b in zip(srcs, built)}
    for label, B, setup in AB_CASES:
        run, call = setup()
        times = {"parent": [], "current": []}
        for who in times:  # warm-up
            with _launchers(libs[who]):
                call()
        for w in range(5):
            for who in (("parent", "current") if w % 2 == 0
                        else ("current", "parent")):
                with _launchers(libs[who]):
                    times[who].append(_window_ms(call))
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"ab {label} B={B} K={K_FULL}, grid {run.grid}: parent "
              f"{med['parent']:.4f} "
              f"ms/call, current {med['current']:.4f} ms/call, current/parent "
              f"{med['current'] / med['parent']:.4f} (medians of 5 windows x 4 "
              f"chained calls; windows parent "
              f"{', '.join(f'{x:.4f}' for x in times['parent'])}; current "
              f"{', '.join(f'{x:.4f}' for x in times['current'])})", flush=True)


FLOOR_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

__global__ void grid_floor(int steps) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int t = 0; t < steps; ++t) grid.sync();
}

extern "C" int floor_launch(int blocks, int threads, int steps, void* stream) {
  void* args[] = {&steps};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)grid_floor, dim3(blocks), dim3(threads), args, 0,
      (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
"""


def floor() -> None:
    """K grid barriers and nothing else, at each trainer's block count."""
    from ._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    d = BUILD_DIR / "probe_q" / "floor"
    d.mkdir(parents=True, exist_ok=True)
    (d / "floor.cu").write_text(FLOOR_SRC)
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(d / "floor.so"),
                          str(d / "floor.cu")], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the barrier floor:\n{out.stderr}")
    fn = ctypes.CDLL(str(d / "floor.so")).floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for label, setup in (("Taxi-v4 Q", lambda: _setup()),
                         *((lbl, (lambda kind=k, kw=kw: _setup_rooms(kind, **kw)))
                           for lbl, k, kw in ROOMS_OPTIONS),
                         ("Rooms-v0 actor-critic", lambda: _setup_rooms("ac"))):
        run, call = setup()
        call()
        blocks = run.grid[0]
        stream = torch.cuda.current_stream().cuda_stream

        def barriers(steps=K_FULL):
            err = fn(blocks, 256, steps, stream)
            if err:
                raise RuntimeError(f"floor launch failed: CUDA error {err}")

        for K in (K_FULL, 4 * K_FULL):
            ms = event_ms(lambda K=K: barriers(K), reps=4)
            print(f"floor grid.sync() x {K} at {label}'s {blocks} blocks of "
                  f"256 threads: {ms:.4f} ms/launch, {ms / K * 1e3:.4f} us "
                  "per barrier", flush=True)


def touched() -> None:
    """Distinct entries per block and step against the block's terms, in
    the one-step trainers at full width: at B = 65,536 each thread owns one
    env, so block b holds envs 256 b to 256 b + 255.  The addresses are
    those the twin applies (its ``apply_update``, wrapped), in one call
    from the setups' start."""
    from . import fused_double_q as fdq
    from . import fused_qlearning as fq

    cases = (
        ("[3] Rooms-v0 one-step Q", lambda: _setup_rooms("q"), "a", "t"),
        ("[4] MultistoryFourRooms-v0 grid_z=3 Q", _setup_msrooms, "a", "q"),
        ("[2] Taxi-v4 Q", lambda: _setup(), "s", "q"),
        ("[11] Taxi-v4 double Q", lambda: _setup(double=True), "s", "q"),
    )
    saved = fq.apply_update
    for label, setup, s_key, q_key in cases:
        run, call = setup()
        carry = call.carry
        q = carry[q_key][0] if q_key == "t" else carry[q_key]
        per_step = []

        def record(q_in, addr, w, live, average):
            blk = torch.arange(addr.numel(), device=addr.device) // 256
            key = (blk * q_in.numel() + addr.long())[live]
            n_blk = addr.numel() // 256
            per_step.append((torch.bincount(torch.unique(key) // q_in.numel(),
                                            minlength=n_blk),
                             torch.bincount(blk[live], minlength=n_blk)))
            return saved(q_in, addr, w, live, average)

        fq.apply_update = fdq.apply_update = record
        try:
            run.twin(1, LR, EPS, carry[s_key], q)
        finally:
            fq.apply_update = fdq.apply_update = saved
        words = torch.stack([d for d, _ in per_step]).double()
        terms = torch.stack([n for _, n in per_step]).double()
        print(f"touched {label} B={B_FULL} K={K_FULL}: distinct entries per "
              f"block per step mean {words.mean().item():.4f} (min "
              f"{words.min().item():.0f}, median {words.median().item():.0f}, "
              f"max {words.max().item():.0f}) of {terms.mean().item():.4f} "
              f"terms: the flush issues {words.sum().item() / terms.sum().item():.6f} "
              f"of the terms' global atomics; per step over the grid "
              f"{words.sum(1).mean().item():.1f} flushed words", flush=True)


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
    if "variants" in names and parent and parent.startswith("variant:"):
        raise SystemExit("variants takes a parent directory, not a variant")
    print(_nvidia_smi("name,power.limit"), flush=True)
    sections = {"sweep": sweep, "profile": profile,
                "variants": lambda: variants(parent), "ab": lambda: ab(parent),
                "floor": floor, "touched": touched}
    for name in names:
        sections[name]()
    print("clocks after:", _nvidia_smi(
        "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
