"""Measurement probe of the fused rollout kernels (Taxi, RockSample, Tag,
HeavenHell, CRooms, ROOMS, MultistoryFourRooms) and the CRooms Q trainer
on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_fused_taxi [section ...] [--parent DIR]

Sections (``sweep profile variants spread acting`` when none is named;
``ab`` needs ``--parent``; ``sass``, ``rates`` and ``shares`` run only when
named):

- ``sweep``: CUDA-event ms/call and env-steps/s over B and K on
  ``HansenTaxi-v4``, and the other cells (maps, episode stats, greedy-table
  policy) at B = 2^20, K = 256;
- ``profile``: ``torch.profiler`` device time of 4 chained headline calls
  against their wall time, and of the ``step_vec`` rollout at B = 65,536;
- ``variants``: copies of the Taxi, RockSample, Tag (with HeavenHell),
  CRooms, ROOMS and MSRooms rollouts' and the CRooms Q trainer's sources
  with one part taken out (the input range guard, the Philox
  rounds), made a compile-time constant (the 5x5 map), built another way
  (CRooms' ``warp-packed`` wall resample, Tag's respawn not inlined, a
  register cap by ``__launch_bounds__``) or put back as the parent design
  had it (``runtime-div``: ``gpt::udiv`` divides by its runtime ``n``, so
  every draw's ``u % n`` is a hardware division sequence again; with
  ``--parent``, each kernel as the parent built it), built under
  ``build/gym_po_tpu_torch/probe/`` and timed beside the sources as they
  are (Taxi on ``HansenTaxi-v4``, RockSample at [7,8] and (11,11), Tag,
  HeavenHell and CRooms at the registry's defaults and at time limit 1,
  ROOMS and MSRooms also with both spawns drawn; ``warp-vote``:
  Tag's respawn and CRooms' resample and spawn under an explicit
  ``__any_sync`` vote, where the sources branch plainly; HeavenHell's
  ``coin-eager`` and ``coin-at-truncation``: its coin's Philox block
  computed at the top of every step, or of the steps the time limit ends,
  where the source computes it only in the reset branch), to attribute the
  kernels' time;
- ``spread``: ten repeats of ``chip_smoke.py``'s headline timing, for the
  run-to-run spread inside one process;
- ``acting``: ``entry.forward`` ms/step at B = 4,096 and 65,536, with the
  profiler's busy share and kernel launches per step;
- ``ab``: the rollouts built from ``--parent DIR`` (a ``csrc`` directory,
  e.g. one unpacked by ``git archive <commit> gym_po_tpu_torch/csrc``)
  against the current sources in one process, at B = 2^20, K = 256: Taxi on
  ``HansenTaxi-v4`` (random policy and a greedy table) and on
  ``ExtendedHansenTaxi-v4``, RockSample at [7,8] and (11,11), Tag and
  HeavenHell at the registry's defaults and at the reset-heavy time limit
  1, the ROOMS and MultistoryFourRooms (grid_z = 3) rollouts there and with
  both spawns drawn, CRooms, and the CRooms Q trainer (at its defaults and
  time limit 1) and the MSRooms Q trainer at B = 65,536; each the median of 5
  CUDA-event windows of 4 calls per source, the two sources' windows
  alternating;
- ``sass``: for the Taxi, RockSample, Tag, CRooms, ROOMS and MSRooms
  rollouts (and, with
  ``--parent``, the parent's), each kernel's registers, stack frame and
  spills (ptxas) and its ``MUFU.RCP`` and ``I2F.U32.RP`` (the runtime
  integer division's float reciprocal), in all and inside loops
  (``cuobjdump -sass``; a loop is the span of a backward branch); with
  ``--parent``, whether each kernel's SASS is the parent's; then every
  ``csrc/*.cu`` built as it is and with Philox at 0 rounds, and per kernel
  the instructions inside loops by pipe (FMA: ``IMAD*``; FP32: float
  add/multiply, on either half of the FMA pipe; ALU: ``LOP3``, ``IADD3``,
  ``SHF``, ``ISETP``, ``SEL``, ...; XU: ``MUFU``, conversions) in both
  builds and their difference: the Philox rounds' cost in a step; last, the
  Box-Muller normal's ``logf``, ``cosf`` and ``sqrtf`` each in a loop of
  its own, the fast path of one pass by pipe and each loop's rate by the
  SM clock (the listing in ``build/gym_po_tpu_torch/probe/libm_sass.txt``):
  from these the bounds are counted;
- ``rates``: lanes per SM per clock of ``IMAD.WIDE.U32``, ``IMAD``,
  ``LOP3``, of ``IMAD.WIDE.U32`` interleaved with ``LOP3``, and of a
  Philox half-round (a ``LOP3`` feeding an ``IMAD.WIDE.U32``), each from
  eight independent chains per thread, 2,048 threads per SM, timed by each
  SM's own ``clock64`` (the SASS of each loop printed beside it): the pipe
  rates behind the bounds;
- ``shares``: counter copies of the Tag, HeavenHell, CRooms, ROOMS and
  MSRooms rollouts and the CRooms Q trainer (each held to its twin first),
  at the cells of ``variants``: resets and wall hits per env-step and per
  warp-step, Tag's candidates per respawn and corner fallbacks, warps with
  more than 16 hits, and the CRooms Q trainer's bound at its shares.

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
B_TRAIN = 1 << 16  # the trainers' width in chip_smoke.py
SECTIONS = ("sweep", "profile", "variants", "spread", "acting", "ab", "sass",
            "rates", "shares")
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


def _setup_state(kind, B=B_HEAD, K=K_HEAD, **kw):
    """``(run, state)`` of the Tag, HeavenHell or CRooms rollout at the
    registry's defaults (``kw`` on top), from ``reset_vec`` with seed 0."""
    import gym_po_tpu_torch as gp
    from . import (
        make_fused_crooms_rollout,
        make_fused_heavenhell_rollout,
        make_fused_tag_rollout,
    )

    env_id, make = {"tag": ("TagContinuous-v0", make_fused_tag_rollout),
                    "heavenhell": ("HeavenHellContinuous-v0",
                                   make_fused_heavenhell_rollout),
                    "crooms": ("CRooms-v0", make_fused_crooms_rollout)}[kind]
    dev = torch.device("cuda")
    env = gp.make(env_id, device=dev, **kw)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    if kind == "crooms":
        cols = (st.agent_yx[:, 0], st.agent_yx[:, 1], st.vel_yx[:, 0],
                st.vel_yx[:, 1], st.goal_yx[:, 0], st.goal_yx[:, 1])
    elif kind == "tag":
        cols = (st.agent_xy[:, 0], st.agent_xy[:, 1], st.target_xy[:, 0],
                st.target_xy[:, 1])
    else:
        cols = (st.agent_xy[:, 0], st.agent_xy[:, 1],
                st.heaven_right.to(torch.int32))
    return make(env, B, K), tuple(c.reshape(-1, 128).contiguous() for c in cols)


def _setup_rooms(kind, B=B_HEAD, K=K_HEAD, twin=False, **kw):
    """One call of the ROOMS (``Rooms-v0``) or MultistoryFourRooms
    (``grid_z = 3``) rollout at the registry's defaults (``kw`` on top of
    either),
    from ``reset_vec`` with seed 0, as chip_smoke.py's heads; with
    ``twin``, ``(call, the twin's call)``."""
    import gym_po_tpu_torch as gp
    from . import make_fused_msrooms_rollout, make_fused_rooms_rollout

    dev = torch.device("cuda")
    if kind == "rooms":
        env = gp.make("Rooms-v0", device=dev, **kw)
        _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
        W = env.grid_np.shape[1]
        cells = [(yx[:, 0].int() * W + yx[:, 1].int()) for yx in (st.agent_yx, st.goal_yx)]
        run = make_fused_rooms_rollout(env, B, K)
    else:
        env = gp.make("MultistoryFourRooms-v0", grid_z=3, device=dev, **kw)
        _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
        _, H, GW = env.grid_np.shape
        cells = [(z[:, 0].int() * H * GW + z[:, 1].int() * GW + z[:, 2].int())
                 for z in (st.agent_zyx, st.goal_zyx)]
        run = make_fused_msrooms_rollout(env, B, K)
    state = tuple(c.reshape(-1, 128).contiguous() for c in cells)
    call = lambda: run(1, *state)  # noqa: E731
    return (call, lambda: run.twin(1, *state)) if twin else call


def _setup_q_crooms(B=B_TRAIN, K=K_HEAD, twin=False, **kw):
    """A call of the CRooms Q trainer at chip_smoke.py's shape (ordinal
    actions, B = 65,536, K = 256, lr = eps = 0.1, averaged, from Q = 0;
    ``kw`` on top of the env's defaults); with ``twin``, ``(call, the
    twin's call)``."""
    import gym_po_tpu_torch as gp
    from . import make_fused_q_trainer_crooms

    dev = torch.device("cuda")
    env = gp.make("CRooms-v0", action_type="ordinal", device=dev, **kw)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(5), B)
    s4 = tuple(c.reshape(-1, 128).contiguous() for c in (
        st.agent_yx[:, 0], st.agent_yx[:, 1], st.vel_yx[:, 0], st.vel_yx[:, 1]))
    run = make_fused_q_trainer_crooms(env, B, K, average_duplicates=True)
    q0 = torch.zeros((32, 128), device=dev)
    call = lambda: run(1, 0.1, 0.1, *s4, q0)  # noqa: E731
    return (call, lambda: run.twin(1, 0.1, 0.1, *s4, q0)) if twin else call


def _setup_q_msrooms(B=B_TRAIN, K=K_HEAD):
    """A call of the MultistoryFourRooms Q trainer [4] at chip_smoke.py's
    shape (grid_z = 3, B = 65,536, K = 256, lr = eps = 0.1, averaged, from
    Q = 0)."""
    import gym_po_tpu_torch as gp
    from . import make_fused_q_trainer_msrooms

    dev = torch.device("cuda")
    env = gp.make("MultistoryFourRooms-v0", grid_z=3, device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(5), B)
    _, H, GW = env.grid_np.shape
    z = st.agent_zyx.int()
    a0 = (z[:, 0] * H * GW + z[:, 1] * GW + z[:, 2]).reshape(-1, 128).contiguous()
    run = make_fused_q_trainer_msrooms(env, B, K, average_duplicates=True)
    q0 = torch.zeros((32, 128), device=dev)
    return lambda: run(1, 0.1, 0.1, a0, q0)


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
    """Make ``module``'s wrappers (``fused_taxi``, ``fused_rocksample``,
    ``fused_q_crooms``, ``fused_qlearning``, ``fused_rooms`` for the ROOMS
    and MSRooms rollouts, or ``state_rollout`` for the Tag, HeavenHell and
    CRooms rollouts) launch ``lib_path``'s ``entry``.  A Taxi library from
    before the invariant divisors takes the argument list without them; a
    parent library whose params struct is the head of the current one (the
    CRooms kernels' before their spawn divisors, [14] before its stride
    divisor, [6] before its draws' divisors, [4] before its floor divisor)
    reads that head.  A [14] from before the one-barrier protocol sized its
    scratch [nq] (the current wrapper's 3 * A * slab_stride(n_obs) words
    cover that at CRooms-v0's 200 observations)."""
    fn = getattr(ctypes.CDLL(str(lib_path)), entry)
    fn.restype = ctypes.c_int
    if module.__name__.endswith("state_rollout"):
        fn.argtypes = [ctypes.c_void_p] * 6
        saved = module._launcher
        module._launcher = lambda source, name: fn
        try:
            yield
        finally:
            module._launcher = saved
        return
    if module.__name__.endswith("fused_qlearning"):  # the trainers' entries
        saved = module._launcher

        def trainer(name):
            fn = getattr(ctypes.CDLL(str(lib_path)), name)
            fn.argtypes = saved(name).argtypes
            fn.restype = ctypes.c_int
            return fn

        module._launcher = trainer
        try:
            yield
        finally:
            module._launcher = saved
        return
    if module.__name__.endswith("fused_rooms"):  # the ROOMS and MSRooms rollouts
        saved = module._launcher

        def patched(kernel, params_cls, n_tables):
            fn.argtypes = saved(kernel, params_cls, n_tables).argtypes
            return fn

        module._launcher = patched
        try:
            yield
        finally:
            module._launcher = saved
        return
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
# the rare branches under an explicit warp vote (__any_sync with the mask of
# the lanes that hold an env, taken before a lane past the batch leaves),
# where the sources have plain branches (SIMT skips a branch that no lane
# of the warp takes)
LIVE_BALLOT = ("  // the warp's votes take the lanes that hold an env\n"
               "  const unsigned live = __ballot_sync(0xffffffffu, e < P.h.num_envs);\n")
EARLY_RETURN = "  if (e >= P.h.num_envs) return;\n"
VOTE_TAG = [("fused_tag.cu", "fused_tag_kernel(TagParams P, TagPtrs p, const int32_t* __restrict__ tape) {\n"
             "  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
             + EARLY_RETURN,
             "fused_tag_kernel(TagParams P, TagPtrs p, const int32_t* __restrict__ tape) {\n"
             "  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
             + LIVE_BALLOT + EARLY_RETURN),
            ("fused_tag.cu", "    if (reset) tag_respawn(",
             "    if (__any_sync(live, reset) && reset) tag_respawn(")]
VOTE_CROOMS = [("fused_crooms.cu", EARLY_RETURN, LIVE_BALLOT + EARLY_RETURN),
               ("fused_crooms.cu", "    if (oob) {", "    if (__any_sync(live, oob) && oob) {"),
               ("fused_crooms.cu", "    if (mv.reset) {",
                "    if (__any_sync(live, mv.reset) && mv.reset) {")]
# the wall-resample normals warp-packed: in each round of up to 16 hitting
# lanes, lane l computes coordinate l % 2 of the round's (l / 2)-th hitting
# lane and a shuffle hands each its two (one normal per lane where each
# hitting lane computes two)
PACKED_RESAMPLE_FN = r"""// The wall-resample normals, nry (sites 6-7) and nrx (sites 8-9), of the
// lanes in hits, the warp's vote on oob; every lane of the warp calls it.
// Warp-packed: in each round of up to 16 hitting lanes, lane l computes
// coordinate l % 2 of the round's (l / 2)-th hitting lane and a shuffle hands
// each hitting lane its two, so a warp-step costs one normal per round where
// each hitting lane would compute two.  Sites 6-7 are words 2-3 of the
// hitting lane's block 1, which it holds; sites 8-9 are words 0-1 of its
// block 2, which the computing lane makes itself (counter (that env, t, 2,
// 0)).  slots is the warp's 32 bytes of shared memory.  A warp with lanes
// past the batch (the wrapper's tiling never makes one) has each hitting
// lane compute its own.
__device__ __forceinline__ void resample_normals(const gpt::LazyRNG& rng,
                                                 unsigned live, unsigned hits,
                                                 bool oob, const gpt::U32x4& b1,
                                                 uint8_t* slots, float& nry,
                                                 float& nrx) {
  if (live != 0xffffffffu) {
    if (oob) {
      const gpt::U32x4 b2 = rng.block(2);
      nry = gpt::rnormal(rng.draw(6, b1), rng.draw(7, b1));
      nrx = gpt::rnormal(rng.draw(8, b2), rng.draw(9, b2));
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int rank = __popc(hits & ((1u << lane) - 1u));  // among the hitting lanes
  if (oob) slots[rank] = (uint8_t)lane;
  __syncwarp();
  const int n = __popc(hits);
  for (int first = 0; first < n; first += 16) {
    const int k = first + (lane >> 1);
    const int src = k < n ? slots[k] : lane;
    const int dl = src - lane;
    const uint32_t w2 = __shfl_sync(live, b1.w[2], src);
    const uint32_t w3 = __shfl_sync(live, b1.w[3], src);
    float z = 0.0f;
    if (k < n) {
      // the env of lane src, env + dl: a warp's 32 envs are consecutive and
      // lie in one 128-lane row of one tape tile
      const auto tape_word = [&](int j) {
        const long long row = ((long long)j * rng.num_steps + rng.step) *
                              rng.rows_per_tile;
        return (uint32_t)__ldg(rng.tape + rng.tape_base + dl + row * 128);
      };
      uint32_t u1 = w2, u2 = w3;  // sites 6 and 7, Philox mode
      if (rng.tape) {
        u1 = tape_word(lane & 1 ? 8 : 6);
        u2 = tape_word(lane & 1 ? 9 : 7);
      } else if (lane & 1) {
        const gpt::U32x4 b2 = gpt::philox4x32_10(rng.env + (uint32_t)dl,
                                                 (uint32_t)rng.step, 2u, 0u,
                                                 rng.key0, rng.key1);
        u1 = b2.w[0];
        u2 = b2.w[1];
      }
      z = gpt::rnormal(u1, u2);
    }
    const int slot = 2 * (rank - first);
    const float zy = __shfl_sync(live, z, slot & 31);
    const float zx = __shfl_sync(live, z, (slot + 1) & 31);
    if (oob && rank >= first && rank < first + 16) {
      nry = zy;
      nrx = zx;
    }
  }
  __syncwarp();  // every lane has read the slots before the next step writes
}

"""
WARP_PACKED = [
    ("fused_crooms.cu", "template <bool kVel, bool kRandGoal, bool kRandAgent>\n__global__",
     PACKED_RESAMPLE_FN + "template <bool kVel, bool kRandGoal, bool kRandAgent>\n__global__"),
    ("fused_crooms.cu", "  extern __shared__ int32_t smem[];\n",
     "  extern __shared__ int32_t smem[];\n"
     "  __shared__ uint8_t s_slots[gpt::kRolloutThreads];\n"),
    ("fused_crooms.cu", "  if (e >= P.h.num_envs) return;\n",
     LIVE_BALLOT + "  if (e >= P.h.num_envs) return;\n"
     "  uint8_t* slots = s_slots + (threadIdx.x & ~31);\n"),
    ("fused_crooms.cu", """    if (oob) {
      // a wall hit: block 2, the resample's two normals and its centre
      const gpt::U32x4 b2 = rng.block(2);
      const float nry = gpt::rnormal(rng.draw(6, b1), rng.draw(7, b1));
      const float nrx = gpt::rnormal(rng.draw(8, b2), rng.draw(9, b2));
      gpt::crooms_resample(M, py, px, nry, nrx, ny, nx);
    }
""", """    const unsigned hits = __ballot_sync(live, oob);
    if (hits) {
      float nry = 0.f, nrx = 0.f;
      resample_normals(rng, live, hits, oob, b1, slots, nry, nrx);
      if (oob) gpt::crooms_resample(M, py, px, nry, nrx, ny, nx);
    }
""")]


# at least n blocks of 256 threads per SM: ptxas caps the registers
def min_blocks(source, n):
    return (source, "__global__ void __launch_bounds__(gpt::kRolloutThreads)",
            f"__global__ void __launch_bounds__(gpt::kRolloutThreads, {n})")


# [14] with every Philox block of the step computed at its start, as the
# parent's KernelRNG<4> did (the normals stay where the sources draw them)
EAGER_RNG_FN = r"""// every block of the step computed at begin_step, as KernelRNG<4> does
struct EagerRNG : gpt::LazyRNG {
  gpt::U32x4 blk[4];
  __device__ EagerRNG(const int32_t* tape_, long long base, uint32_t k0,
                      uint32_t k1, long long e, int K, int R)
      : gpt::LazyRNG(tape_, base, k0, k1, e, K, R) {}
  __device__ __forceinline__ void begin_step(int t) {
    gpt::LazyRNG::begin_step(t);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      blk[b] = gpt::LazyRNG::block(b);
      asm volatile("" ::"r"(blk[b].w[0]), "r"(blk[b].w[1]), "r"(blk[b].w[2]),
                   "r"(blk[b].w[3]));
    }
  }
  __device__ __forceinline__ gpt::U32x4 block(int b) const {
    return b == 0 ? blk[0] : b == 1 ? blk[1] : b == 2 ? blk[2] : blk[3];
  }
};

namespace {
"""
EAGER_RNG = [("fused_q_crooms.cu", "\nnamespace {\n", "\n" + EAGER_RNG_FN),
             ("fused_q_crooms.cu", "      gpt::LazyRNG rng(tape, e,",
              "      EagerRNG rng(tape, e,")]

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
    "fused_tag": {
        "as-is": [],
        "philox-0-rounds": [PHILOX_0],
        # the respawn a call, not inlined, so its registers leave the loop's
        "respawn-noinline": [("fused_tag.cu",
                              "__device__ __forceinline__ void tag_respawn(",
                              "__device__ __noinline__ void tag_respawn(")],
        "min-blocks-6": [min_blocks("fused_tag.cu", 6)],
        "warp-vote": VOTE_TAG,
        # HeavenHell's coin block (block 1) computed at the top of the step
        # where the time limit ends the episode, or every step (the spawn
        # stays under its branch), where the source computes it only in the
        # reset branch
        "coin-at-truncation": [
            ("fused_tag.cu", "    const gpt::U32x4 b0 = rng.block(0);\n    const float px = move(x,",
             "    const gpt::U32x4 b0 = rng.block(0);\n"
             "    const bool trunc = elapsed + 1 >= P.h.time_limit;\n"
             "    gpt::U32x4 b1 = {};\n    if (trunc) b1 = rng.block(1);\n"
             "    const float px = move(x,"),
            ("fused_tag.cu", "rng.draw(4, rng.block(1))", "rng.draw(4, trunc ? b1 : rng.block(1))")],
        "coin-eager": [
            ("fused_tag.cu", "    const gpt::U32x4 b0 = rng.block(0);\n    const float px = move(x,",
             "    const gpt::U32x4 b0 = rng.block(0);\n"
             "    const gpt::U32x4 b1 = rng.block(1);\n"
             "    const float px = move(x,"),
            ("fused_tag.cu", "rng.draw(4, rng.block(1))", "rng.draw(4, b1)")],
    },
    "fused_crooms": {
        "as-is": [],  # each hitting lane its own block 2 and two normals
        "warp-packed": WARP_PACKED,
        "philox-0-rounds": [PHILOX_0],
        "min-blocks-8": [min_blocks("fused_crooms.cu", 8)],
        "warp-vote": VOTE_CROOMS,
    },
    "fused_q_crooms": {
        "as-is": [],
        # the update sums always straight into the global accumulator
        "global-sums": [("fused_q_crooms.cu",
                         "coop_geometry_room(kern, base, slab, gpt::kMaxEnvsPerThread,",
                         "coop_geometry_room(kern, base, slab, 0,")],
        "eager-rng": EAGER_RNG,
        "philox-0-rounds": [PHILOX_0],
    },
    "fused_msrooms": {
        "as-is": [],
        "runtime-div": [RUNTIME_DIV],
        "philox-0-rounds": [PHILOX_0],
    },
    "fused_rooms": {
        "as-is": [],
        "runtime-div": [RUNTIME_DIV],
        "philox-0-rounds": [PHILOX_0],
    },
}
# the continuous kernels' variants are timed on these cells: (label, the
# rollout (``_setup_state``'s kind, whose kernel's entry the source holds),
# the env's kwargs); HeavenHell's kernel is in fused_tag.cu beside Tag's
VARIANT_CELLS = {
    "fused_tag": [("TagContinuous-v0", "tag", {}),
                  ("TagContinuous-v0 time_limit=1", "tag", {"time_limit": 1}),
                  ("HeavenHellContinuous-v0", "heavenhell", {}),
                  ("HeavenHellContinuous-v0 time_limit=1", "heavenhell",
                   {"time_limit": 1})],
    "fused_crooms": [("CRooms-v0", "crooms", {}),
                     ("CRooms-v0 time_limit=1", "crooms", {"time_limit": 1})],
}


def _edited(files: dict, edits) -> dict:
    files = dict(files)
    for fname, old, new in edits:
        files[fname] = _edit(files[fname], old, new)
    return files


def variants(parent=None) -> None:
    from . import fused_q_crooms, fused_rocksample, fused_rooms, fused_taxi, state_rollout
    from ._build import BUILD_DIR, CSRC

    jobs = [(BUILD_DIR / "probe" / kernel / name, kernel,
             _edited(_sources(CSRC, kernel), edits))
            for kernel, cases in VARIANTS.items()
            for name, edits in cases.items()]
    if parent:  # the parent design (eager draws) of each kernel
        jobs += [(BUILD_DIR / "probe" / kernel / "parent", kernel,
                  _sources(Path(parent), kernel)) for kernel in VARIANTS]
    t0 = time.perf_counter()
    built = _nvcc_builds(jobs)
    print(f"variants: {len(jobs)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    def roll(run, state):
        state = state if isinstance(state, tuple) else (state,)
        return lambda: run(1, *state)

    # kernel: [(cell, B, one call[, the launch entry when it is not
    # <kernel>_launch])]
    setups = {"fused_taxi": [("HansenTaxi-v4", B_HEAD, roll(*_setup()[1:]))],
              "fused_rocksample": [
                  (f"RockSample{ms + (k,)}", B_HEAD, roll(*_setup_rock(ms, k)[1:]))
                  for ms, k in ROCK_CELLS],
              "fused_q_crooms": [
                  ("CRooms-v0 ordinal Q", B_TRAIN, _setup_q_crooms()),
                  ("CRooms-v0 ordinal Q time_limit=1", B_TRAIN,
                   _setup_q_crooms(time_limit=1))],
              "fused_msrooms": [
                  ("MultistoryFourRooms-v0 grid_z=3", B_HEAD, _setup_rooms("msrooms")),
                  ("MultistoryFourRooms-v0 grid_z=3 time_limit=1", B_HEAD,
                   _setup_rooms("msrooms", time_limit=1))],
              "fused_rooms": [
                  ("Rooms-v0", B_HEAD, _setup_rooms("rooms")),
                  ("Rooms-v0 random goal and agent", B_HEAD,
                   _setup_rooms("rooms", goal_xy=None)),
                  ("Rooms-v0 time_limit=1", B_HEAD,
                   _setup_rooms("rooms", time_limit=1))]}
    for kernel, cells in VARIANT_CELLS.items():
        setups[kernel] = [(cell, B_HEAD, roll(*_setup_state(kind, **kw)),
                           f"fused_{kind}_launch") for cell, kind, kw in cells]
    modules = {"fused_taxi": fused_taxi, "fused_rocksample": fused_rocksample,
               "fused_tag": state_rollout, "fused_crooms": state_rollout,
               "fused_q_crooms": fused_q_crooms, "fused_msrooms": fused_rooms,
               "fused_rooms": fused_rooms}
    for (d, kernel, _), (lib, log) in zip(jobs, built):
        regs = ",".join(re.findall(r"Used (\d+) registers", log))
        for cell, B, call, *entry in setups[kernel]:
            with _launcher_from(modules[kernel], lib, (entry or [f"{kernel}_launch"])[0]):
                ms = event_ms(call)
            _report(f"variant {kernel} {d.name} {cell} (registers {regs})",
                    B, K_HEAD, ms)


# ``shares``: counter copies of the Tag, HeavenHell, CRooms, ROOMS and
# MSRooms rollouts and the CRooms Q trainer [14].  Each lane counts in registers
# (the trainer per thread, over its envs) and adds its counts to g_counts
# once, at the end:
# [0] env-steps that reset, [1] env-steps whose warp votes to reset (each
# lane of the warp counts it), [2] env-steps that hit a wall, [3] env-steps
# whose warp has a hit, [4] env-steps whose warp has more than 16 hits (two
# rounds of the packed resample), [5] Tag: candidates the respawns examined,
# [6] Tag: respawns that fell back to a corner, [7] env-steps.
COUNTS_DEF = """
__device__ unsigned long long g_counts[8];
extern "C" int probe_counts(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
  const unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));
  return (int)cudaGetLastError();
}
"""
COUNTS_DECL = "  unsigned long long n[8] = {};\n"
COUNTS_FLUSH = ("\n  for (int i = 0; i < 8; ++i) if (n[i]) atomicAdd(&g_counts[i], n[i]);"
                "\n}\n")
SHARES = {
    "fused_tag": [
        ("fused_tag.cu", '#include "state_rollout.cuh"\n',
         '#include "state_rollout.cuh"\n' + COUNTS_DEF),
        ("fused_tag.cu", "    if (dist2(c0, c1, a0, a1) >= kMinSpawnDist2) {",
         "    atomicAdd(&g_counts[5], 1ull);\n"
         "    if (dist2(c0, c1, a0, a1) >= kMinSpawnDist2) {"),
        ("fused_tag.cu", "  const float corner[4][2] = {\n      {-kCage, -kCage}, {-kCage, kCage}, "
         "{kCage, -kCage}, {kCage, kCage}};\n  t0 = corner[0][0];",
         "  atomicAdd(&g_counts[6], 1ull);\n  const float corner[4][2] = {\n"
         "      {-kCage, -kCage}, {-kCage, kCage}, {kCage, -kCage}, {kCage, kCage}};"
         "\n  t0 = corner[0][0];"),
        VOTE_TAG[0],
        ("fused_tag.cu", "  gpt::LazyRNG rng(tape,", COUNTS_DECL + "  gpt::LazyRNG rng(tape,"),
        ("fused_tag.cu", "    if (reset) tag_respawn(",
         "    n[0] += reset; n[1] += __any_sync(live, reset) != 0; n[7] += 1;\n"
         "    if (reset) tag_respawn("),
        ("fused_tag.cu", "  if (P.h.episode_stats) stats.store(p, 5, e);\n}\n",
         "  if (P.h.episode_stats) stats.store(p, 5, e);" + COUNTS_FLUSH),
        # HeavenHell, in the same source (the counts' declaration above
        # went into both kernels)
        ("fused_tag.cu", "fused_heavenhell_kernel(TagParams P, HHPtrs p, const int32_t* __restrict__ tape) {\n"
         "  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
         + EARLY_RETURN,
         "fused_heavenhell_kernel(TagParams P, HHPtrs p, const int32_t* __restrict__ tape) {\n"
         "  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
         + LIVE_BALLOT + EARLY_RETURN),
        ("fused_tag.cu", "    if (reset) {\n      elapsed = 0;\n",
         "    n[0] += reset; n[1] += __any_sync(live, reset) != 0; n[7] += 1;\n"
         "    if (reset) {\n      elapsed = 0;\n"),
        ("fused_tag.cu", "  if (P.h.episode_stats) stats.store(p, 4, e);\n}\n",
         "  if (P.h.episode_stats) stats.store(p, 4, e);" + COUNTS_FLUSH),
    ],
    "fused_crooms": [
        ("fused_crooms.cu", '#include "state_rollout.cuh"\n',
         '#include "state_rollout.cuh"\n' + COUNTS_DEF),
        VOTE_CROOMS[0],
        ("fused_crooms.cu", "  gpt::LazyRNG rng(tape,", COUNTS_DECL + "  gpt::LazyRNG rng(tape,"),
        ("fused_crooms.cu", "    if (oob) {",
         "    const unsigned hits = __ballot_sync(live, oob);\n"
         "    n[2] += oob; n[3] += hits != 0; n[4] += __popc(hits) > 16; n[7] += 1;\n"
         "    if (oob) {"),
        ("fused_crooms.cu", "    if (mv.reset) {",
         "    n[0] += mv.reset; n[1] += __any_sync(live, mv.reset) != 0;\n"
         "    if (mv.reset) {"),
        ("fused_crooms.cu", "  if (P.h.episode_stats) stats.store(p, 7, e);\n}\n",
         "  if (P.h.episode_stats) stats.store(p, 7, e);" + COUNTS_FLUSH),
    ],
    # the trainer's warps are whole (B a multiple of 1024), so a vote takes
    # every lane
    "fused_q_crooms": [
        ("fused_q_crooms.cu", '#include "tabular.cuh"\n',
         '#include "tabular.cuh"\n' + COUNTS_DEF),
        ("fused_q_crooms.cu", "  const int B = P.num_envs;\n",
         COUNTS_DECL + "  const int B = P.num_envs;\n"),
        ("fused_q_crooms.cu", "      if (oob) {\n",
         "      n[2] += oob; n[3] += __any_sync(0xffffffffu, oob) != 0; n[7] += 1;\n"
         "      if (oob) {\n"),
        ("fused_q_crooms.cu", "      if (mv.reset) {\n",
         "      n[0] += mv.reset; n[1] += __any_sync(0xffffffffu, mv.reset) != 0;\n"
         "      if (mv.reset) {\n"),
        ("fused_q_crooms.cu", "    p.out[4][e] = racc_l[i];\n  }\n}\n",
         "    p.out[4][e] = racc_l[i];\n  }" + COUNTS_FLUSH),
    ],
    "fused_msrooms": [
        ("fused_msrooms.cu", '#include "msrooms_step.cuh"\n',
         '#include "msrooms_step.cuh"\n' + COUNTS_DEF),
        ("fused_msrooms.cu", "  gpt::LazyRNG rng(tape,", COUNTS_DECL + "  gpt::LazyRNG rng(tape,"),
        ("fused_msrooms.cu", "    if (mv.reset) {\n",
         "    n[0] += mv.reset; n[1] += __any_sync(0xffffffffu, mv.reset) != 0; n[7] += 1;\n"
         "    if (mv.reset) {\n"),
        ("fused_msrooms.cu", "    ep_cnt_out[e] = ep_cnt;\n  }\n}\n",
         "    ep_cnt_out[e] = ep_cnt;\n  }" + COUNTS_FLUSH),
    ],
    "fused_rooms": [
        ("fused_rooms.cu", '#include "rooms_step.cuh"\n',
         '#include "rooms_step.cuh"\n' + COUNTS_DEF),
        ("fused_rooms.cu", "  gpt::LazyRNG rng(tape,", COUNTS_DECL + "  gpt::LazyRNG rng(tape,"),
        ("fused_rooms.cu", "    if (mv.reset) {\n      // goal first",
         "    n[0] += mv.reset; n[1] += __any_sync(0xffffffffu, mv.reset) != 0; n[7] += 1;\n"
         "    if (mv.reset) {\n      // goal first"),
        ("fused_rooms.cu", "    ep_cnt_out[e] = ep_cnt;\n  }\n}\n",
         "    ep_cnt_out[e] = ep_cnt;\n  }" + COUNTS_FLUSH),
    ],
}
# the counter copies of [14], [6] and [5] are read at these cells: (label,
# setup kwargs)
SHARE_CELLS = {
    "fused_q_crooms": [("CRooms-v0 ordinal Q B=65536", {}),
                       ("CRooms-v0 ordinal Q B=65536 time_limit=1",
                        {"time_limit": 1})],
    "fused_msrooms": [("MultistoryFourRooms-v0 grid_z=3", {}),
                      ("MultistoryFourRooms-v0 grid_z=3 random goal and agent",
                       {"goal_xyz": None}),
                      ("MultistoryFourRooms-v0 grid_z=3 time_limit=1",
                       {"time_limit": 1})],
    "fused_rooms": [("Rooms-v0", {}),
                    ("Rooms-v0 random goal and agent", {"goal_xy": None}),
                    ("Rooms-v0 time_limit=1", {"time_limit": 1})],
}


def _share_line(kernel, cell, B, n) -> str:
    steps = n[7]
    line = (f"shares {kernel} {cell} B={B} K={K_HEAD}: resets per env-step "
            f"{n[0] / steps:.6e}, warp-steps voting to reset {n[1] / steps:.6e}")
    if kernel in ("fused_crooms", "fused_q_crooms"):
        line += (f"; wall hits per env-step {n[2] / steps:.6e}, warp-steps "
                 f"with a hit {n[3] / steps:.6e}")
    if kernel == "fused_crooms":
        line += f", with more than 16 hits {n[4] / steps:.6e}"
    if kernel == "fused_tag":
        line += (f"; candidates per respawn {n[5] / max(n[0], 1):.4f}, "
                 f"corner fallbacks per respawn {n[6] / max(n[0], 1):.4f}")
    return line


def _q_crooms_share_bound(n) -> str:
    """[14]'s bound at the shares ``n`` of one counted call, counted as
    chip_smoke.py counts bounds (its ``bound``, ``philox_ops``,
    ``block_ops``, ``normal_ops``; run from the repository's root): per
    env-step blocks 0-1, the action's 2 normals and one update term, per
    wall hit block 2 and 2 normals more, per reset block 3 (its word 0
    alone); the bytes as chip_smoke.py's."""
    import chip_smoke as cs

    steps, hits, resets = n[7], n[2], n[0]
    ops = cs.add_ops(cs.philox_ops(8, steps, steps), cs.normal_ops(2 * steps),
                     cs.block_ops(hits, resets), cs.normal_ops(2 * hits))
    ms, by, pipe = cs.bound(36 * B_TRAIN + 8 * 32 * 128, ops)
    every = cs.bound(36 * B_TRAIN + 8 * 32 * 128, cs.add_ops(
        cs.philox_ops(8, steps, steps), cs.normal_ops(2 * steps)))
    return (f"; bound at these shares {ms:.4f} ms ({by}, {pipe}), blocks 0-1 "
            f"and 2 normals per env-step alone {every[0]:.4f} ms")


def shares() -> None:
    """The reset and wall-hit shares of [9] and [8] at B = 2^20, K = 256,
    of [14] at B = 65,536, K = 256 from Q = 0 (chip_smoke.py's timing
    shape) and the reset shares of [10], [6] and [5] at B = 2^20, K = 256,
    per lane and per warp, from counter copies of the sources (the draws
    and results are the sources' own: each copy's first call of each kernel
    is held to the twin's on a smaller batch)."""
    from . import fused_q_crooms, fused_rooms, state_rollout
    from ._build import BUILD_DIR, CSRC

    jobs = [(BUILD_DIR / "probe" / "shares" / kernel, kernel,
             _edited(_sources(CSRC, kernel), edits))
            for kernel, edits in SHARES.items()]
    built = dict(zip(SHARES, _nvcc_builds(jobs)))
    out = (ctypes.c_ulonglong * 8)()
    for kernel, cells in VARIANT_CELLS.items():
        lib = built[kernel][0]
        read = ctypes.CDLL(str(lib)).probe_counts
        read.argtypes = [ctypes.c_void_p]
        held = set()
        for cell, kind, kw in cells:
            with _launcher_from(state_rollout, lib, f"fused_{kind}_launch"):
                if kind not in held:
                    run, state = _setup_state(kind, B=1 << 14, K=64, time_limit=40)
                    got, want = run(3, *state), run.twin(3, *state)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"counter copy of fused_{kind} "
                                             "differs from the twin")
                    held.add(kind)
                run, state = _setup_state(kind, **kw)
                torch.cuda.synchronize()
                read(out)  # cleared
                run(1, *state)
                torch.cuda.synchronize()
                read(out)
                print(_share_line(f"fused_{kind}", cell, B_HEAD, list(out)),
                      flush=True)
    # [14], [6] and [5]: each copy held to its twin, then read at its cells
    held = {"fused_q_crooms": (fused_q_crooms, lambda **kw: _setup_q_crooms(
                B=8192, K=32, twin=True, **kw), B_TRAIN,
                lambda **kw: _setup_q_crooms(**kw)),
            "fused_msrooms": (fused_rooms, lambda **kw: _setup_rooms(
                "msrooms", B=1 << 14, K=64, twin=True, time_limit=40, **kw),
                B_HEAD, lambda **kw: _setup_rooms("msrooms", **kw)),
            "fused_rooms": (fused_rooms, lambda **kw: _setup_rooms(
                "rooms", B=1 << 14, K=64, twin=True, time_limit=40, **kw),
                B_HEAD, lambda **kw: _setup_rooms("rooms", **kw))}
    for kernel, (module, small, B, setup) in held.items():
        lib = built[kernel][0]
        read = ctypes.CDLL(str(lib)).probe_counts
        read.argtypes = [ctypes.c_void_p]
        with _launcher_from(module, lib, f"{kernel}_launch"):
            call, twin = small()
            got, want = call(), twin()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"counter copy of {kernel} differs from the twin")
            for cell, kw in SHARE_CELLS[kernel]:
                call = setup(**kw)
                torch.cuda.synchronize()
                read(out)  # cleared
                call()
                torch.cuda.synchronize()
                read(out)
                line = _share_line(kernel, cell, B, list(out))
                if kernel == "fused_q_crooms":
                    line += _q_crooms_share_bound(list(out))
                print(line, flush=True)


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


# ab's cases: (label, source, the wrapper module to patch, its entry, setup
# returning one call); the redesigned kernels at the registry's
# defaults and at the reset-heavy time limit 1 (and [6] and [5] with both
# spawns drawn), and the controls [8] and [4]
def _ab_cases():
    import gym_po_tpu_torch as gp

    from . import (
        fused_q_crooms,
        fused_qlearning,
        fused_rocksample,
        fused_rooms,
        fused_taxi,
        state_rollout,
    )

    def roll(run, state):
        state = state if isinstance(state, tuple) else (state,)
        return lambda: run(1, *state)

    pol = np.random.default_rng(0).integers(
        0, 5, gp.make("HansenTaxi-v4", device="cpu").tables.ns).astype(np.int32)
    taxi = ("fused_taxi", fused_taxi, "fused_taxi_launch")
    rock = ("fused_rocksample", fused_rocksample, "fused_rocksample_launch")
    tag = ("fused_tag", state_rollout, "fused_tag_launch")
    hh = ("fused_tag", state_rollout, "fused_heavenhell_launch")
    crooms = ("fused_crooms", state_rollout, "fused_crooms_launch")
    qcr = ("fused_q_crooms", fused_q_crooms, "fused_q_crooms_launch")
    rooms = ("fused_rooms", fused_rooms, "fused_rooms_launch")
    msrooms = ("fused_msrooms", fused_rooms, "fused_msrooms_launch")
    qms = ("fused_qlearning", fused_qlearning, "fused_q_msrooms_launch")
    cases = [("[1] HansenTaxi-v4 random policy", *taxi,
              lambda: roll(*_setup()[1:])),
             ("[1] HansenTaxi-v4 greedy-table policy", *taxi,
              lambda: roll(*_setup(policy=pol)[1:])),
             ("[1] ExtendedHansenTaxi-v4 random policy", *taxi,
              lambda: roll(*_setup("ExtendedHansenTaxi-v4")[1:]))]
    cases += [(f"[7] RockSample{ms + (k,)}", *rock,
               lambda ms=ms, k=k: roll(*_setup_rock(ms, k)[1:]))
              for ms, k in ROCK_CELLS]
    cases += [("[9] TagContinuous-v0", *tag, lambda: roll(*_setup_state("tag"))),
              ("[9] TagContinuous-v0 time_limit=1", *tag,
               lambda: roll(*_setup_state("tag", time_limit=1))),
              ("[14] CRooms-v0 ordinal Q trainer B=65536", *qcr, _setup_q_crooms),
              ("[14] CRooms-v0 ordinal Q trainer B=65536 time_limit=1", *qcr,
               lambda: _setup_q_crooms(time_limit=1)),
              ("[6] MultistoryFourRooms-v0 grid_z=3", *msrooms,
               lambda: _setup_rooms("msrooms")),
              ("[6] MultistoryFourRooms-v0 grid_z=3 random goal and agent",
               *msrooms, lambda: _setup_rooms("msrooms", goal_xyz=None)),
              ("[6] MultistoryFourRooms-v0 grid_z=3 time_limit=1", *msrooms,
               lambda: _setup_rooms("msrooms", time_limit=1)),
              ("[10] HeavenHellContinuous-v0", *hh,
               lambda: roll(*_setup_state("heavenhell"))),
              ("[10] HeavenHellContinuous-v0 time_limit=1", *hh,
               lambda: roll(*_setup_state("heavenhell", time_limit=1))),
              ("[5] Rooms-v0", *rooms, lambda: _setup_rooms("rooms")),
              ("[5] Rooms-v0 random goal and agent", *rooms,
               lambda: _setup_rooms("rooms", goal_xy=None)),
              ("[5] Rooms-v0 time_limit=1", *rooms,
               lambda: _setup_rooms("rooms", time_limit=1)),
              ("[8] CRooms-v0 (control)", *crooms,
               lambda: roll(*_setup_state("crooms"))),
              ("[4] MultistoryFourRooms-v0 grid_z=3 Q trainer B=65536 (control)",
               *qms, _setup_q_msrooms)]
    return cases


def ab(parent: str) -> None:
    """The parent's rollouts (and the CRooms trainer) against the current
    ones, windows alternating in one process."""
    from ._build import BUILD_DIR, CSRC
    from .probe_fused_qlearning import _window_ms

    cases = _ab_cases()
    sources = sorted({c[1] for c in cases})
    jobs = [(BUILD_DIR / "probe" / f"ab-{who}" / kernel, kernel,
             _sources(src, kernel))
            for who, src in (("parent", Path(parent)), ("current", CSRC))
            for kernel in sources]
    libs = {(d.parent.name[3:], kernel): lib
            for (d, kernel, _), (lib, _) in zip(jobs, _nvcc_builds(jobs))}
    for label, kernel, module, entry, setup in cases:
        call = setup()
        times = {"parent": [], "current": []}

        def timed(who, window):
            with _launcher_from(module, libs[who, kernel], entry):
                if window:
                    times[who].append(_window_ms(call))
                else:
                    call()

        for who in times:  # warm-up
            timed(who, False)
        for w in range(5):
            for who in (("parent", "current") if w % 2 == 0
                        else ("current", "parent")):
                timed(who, True)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"ab {label} K={K_HEAD}: parent {med['parent']:.4f} "
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
    "fma": ("IMAD", "IMUL"),  # the FMA-heavy half only: 64 lanes/SM/clock
    "fp32": ("FFMA", "FMUL", "FADD", "HFMA2", "HADD2", "HMUL2"),  # either half
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


def fast_path(instrs) -> list:
    """One pass of the widest loop, taking every forward branch: the path
    on which the library's rare cases (a subnormal or huge argument) are
    branched over, as nvcc lays out logf, cosf and sqrtf.  A branch that
    skips common code instead would make the count smaller, never larger,
    than the instructions one iteration issues."""
    spans = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    if not spans:
        return []
    head, end = max(spans, key=lambda sp: sp[1] - sp[0])
    at = {a: i for i, (a, _, _) in enumerate(instrs)}
    out, i = [], at[head]
    while i < len(instrs) and instrs[i][0] <= end:
        addr, op, args = instrs[i]
        out.append(instrs[i])
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        target = int(m.group(1), 16) if m else None
        if target is not None and target < addr:
            break  # the loop's own back edge (or an inner loop's)
        i = at[target] if target is not None and target in at else i + 1
    return out


def pipe_counts(instrs) -> collections.Counter:
    """Instructions by pipe (``fma``, ``fp32``, ``alu``, ``xu``; ``uniform`` for the
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
    """``{function: 'N registers, F B stack frame, S B spill stores, L B
    spill loads'}``
    from nvcc's ``-Xptxas -v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _demangled(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = (f"{m.group(1)} B stack frame, {m.group(2)} B spill stores, "
                       f"{m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, {out.get(fn, '')}"
    return out


ALL_SOURCES = ("fused_taxi", "fused_qlearning", "fused_rooms", "fused_ac",
               "fused_msrooms", "fused_rocksample", "fused_crooms",
               "fused_q_crooms", "fused_tag")


ROLLOUTS = ("fused_taxi", "fused_rocksample", "fused_tag", "fused_crooms",
            "fused_rooms", "fused_msrooms")
KEYS = ("fma", "fp32", "alu", "xu", "uniform", "other", "issue")


def sass(parent=None) -> None:
    from ._build import BUILD_DIR, CSRC

    jobs = [(BUILD_DIR / "probe" / "sass" / tag / kernel, kernel,
             _edited(_sources(CSRC, kernel), edits))
            for tag, edits in (("current", []), ("philox-0-rounds", [PHILOX_0]))
            for kernel in ALL_SOURCES]
    if parent:
        jobs += [(BUILD_DIR / "probe" / "sass" / "parent" / kernel, kernel,
                  _sources(Path(parent), kernel)) for kernel in ALL_SOURCES]
    jobs.append((BUILD_DIR / "probe" / "sass" / "libm", "libm",
                 {"libm.cu": LIBM_SRC,
                  "kernel_rng.cuh": (CSRC / "kernel_rng.cuh").read_text()}))
    t0 = time.perf_counter()
    built = _nvcc_builds(jobs)
    print(f"sass: {len(jobs)} libraries built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    results = dict(zip([(d.parent.name, k) for d, k, _ in jobs], built))
    for who in ("current", "parent") if parent else ("current",):
        for kernel in ROLLOUTS:
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
    if parent:  # which kernels the change left as they were
        for kernel in ALL_SOURCES:
            cur = sass_functions(results["current", kernel][0])
            par = sass_functions(results["parent", kernel][0])
            for fn in sorted(set(cur) | set(par)):
                a = [i[1:] for i in cur.get(fn, [])]
                b = [i[1:] for i in par.get(fn, [])]
                print(f"sass parent/current {kernel} {fn}: "
                      + ("identical SASS" if a == b else
                         f"differs ({len(b)} -> {len(a)} instructions, "
                         f"{len(in_loops(par.get(fn, [])))} -> "
                         f"{len(in_loops(cur.get(fn, [])))} inside loops)"),
                      flush=True)
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
                  + " ".join(f"{k} {a[k]}" for k in KEYS) + "; 0 rounds "
                  + " ".join(f"{k} {b[k]}" for k in KEYS) + "; difference "
                  + " ".join(f"{k} {a[k] - b[k]}" for k in KEYS)
                  + f"; IMAD.WIDE.U32 by a Philox multiplier inside loops {wide}",
                  flush=True)
    libm(*results["sass", "libm"])  # built in sass/libm


# The libm sequences of a Box-Muller normal (gpt::rnormal: logf, cosf,
# sqrtf, all correctly rounded library calls, no fast math), each in a loop
# of its own that also draws two uniforms and adds: KIND 0 the uniforms
# alone, 1 rnormal, 2 logf, 3 cosf, 4 sqrtf.  The in-loop instructions of
# KIND k less KIND 0's are the sequence's: its fast path, where the
# library's rare paths (a subnormal or huge argument) lie outside the loop's
# span, as the printed SASS shows.  Each loop is also timed by the SM clock
# (2,048 threads per SM), for its issue rate.
LIBM_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"

template <int KIND>
__global__ void __launch_bounds__(256, 4) libm_kernel(int iters, float* sink,
                                                     long long* span) {
  uint32_t u1 = 0x9E3779B9u * (threadIdx.x + 1), u2 = 0x7F4A7C15u ^ threadIdx.x;
  float acc = 0.0f;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    u1 = u1 * 1664525u + 1013904223u;
    u2 = u2 * 22695477u + 1u;
    const float a = gpt::runiform(u1), b = gpt::runiform(u2);
    float v;
    if (KIND == 0) v = __fadd_rn(a, b);
    else if (KIND == 1) v = gpt::rnormal(u1, u2);
    else if (KIND == 2) v = __fadd_rn(logf(fmaxf(a, 1e-12f)), b);
    else if (KIND == 3) v = __fadd_rn(a, cosf(6.2831854820251465f * b));
    else v = __fadd_rn(sqrtf(a), b);
    acc = __fadd_rn(acc, v);
  }
  __syncthreads();
  const long long t1 = clock64();
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) {
    uint32_t sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    span[3 * blockIdx.x] = sm;
    span[3 * blockIdx.x + 1] = t0;
    span[3 * blockIdx.x + 2] = t1;
  }
}

extern "C" int libm_launch(int kind, int blocks, int iters, void* sink,
                           void* span, void* stream) {
  void (*k)(int, float*, long long*) =
      kind == 0 ? libm_kernel<0> : kind == 1 ? libm_kernel<1>
      : kind == 2 ? libm_kernel<2> : kind == 3 ? libm_kernel<3> : libm_kernel<4>;
  k<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, (float*)sink, (long long*)span);
  return (int)cudaGetLastError();
}
"""
LIBM_KINDS = ("uniforms alone", "rnormal", "logf", "cosf", "sqrtf")


def _sm_rate(fn, kind, blocks, iters, per_iter=1) -> list:
    """Per SM: ``per_iter`` x iterations per clock over its blocks' span."""
    sink = torch.empty(blocks * 256, dtype=torch.float32, device="cuda")
    span = torch.empty(3 * blocks, dtype=torch.int64, device="cuda")
    for _ in range(2):  # the second launch is the one read
        err = fn(kind, blocks, iters, sink.data_ptr(), span.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    sp = span.view(-1, 3).cpu()
    out = []
    for sm in sp[:, 0].unique():
        rows = sp[sp[:, 0] == sm]
        out.append(len(rows) * 256 * iters * per_iter
                   / int(rows[:, 2].max() - rows[:, 1].min()))
    return out


def libm(lib, log) -> None:
    from ._build import BUILD_DIR

    funcs = sass_functions(lib)
    kernels = {k: next(v for f, v in funcs.items() if f"libm_kernel<{k}>" in f)
               for k in range(len(LIBM_KINDS))}
    listing = BUILD_DIR / "probe" / "libm_sass.txt"
    listing.parent.mkdir(parents=True, exist_ok=True)
    with open(listing, "w") as f:
        for k, instrs in kernels.items():
            f.write(f"== libm_kernel<{k}> ({LIBM_KINDS[k]}), inside the loop; "
                    "* on the fast path\n")
            fast = {i[0] for i in fast_path(instrs)}
            f.writelines(f"{'*' if a in fast else ' '} {a:#06x} {op} {args}\n"
                         for a, op, args in in_loops(instrs))
    base = pipe_counts(fast_path(kernels[0]))
    fn = ctypes.CDLL(str(lib)).libm_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, label in enumerate(LIBM_KINDS):
        c = pipe_counts(fast_path(kernels[k]))
        rate = _sm_rate(fn, k, 8 * sms, 2048)
        print(f"libm {label}: one pass of the loop, fast path "
              + " ".join(f"{key} {c[key]}" for key in KEYS) + "; less the "
              "uniforms' loop " + " ".join(f"{key} {c[key] - base[key]}"
                                           for key in KEYS)
              + f"; {len(in_loops(kernels[k]))} instructions inside the loop "
              f"in all; {statistics.median(rate):.3f} iterations/SM/clock "
              f"(median of {len(rate)} SMs); listing in {listing.name}",
              flush=True)
    print("libm registers: " + "; ".join(
        f"{k}: {v}" for k, v in ptxas_report(log).items()), flush=True)


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
    funcs = sass_functions(lib)
    for kind, label in enumerate(RATE_KINDS):
        per_sm = _sm_rate(fn, kind, 8 * sms, 4096, per_iter=8)  # 2,048 threads/SM
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
    sections = {"sweep": sweep, "profile": profile,
                "variants": lambda: variants(parent), "shares": shares,
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
