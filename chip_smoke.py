#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gym_po_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's nine main paths on the card, each through the entry
points a user calls, with the kernels' launch counts zeroed just before the
path and read just after:

1. the fused Taxi rollout kernel at the size ``bench.py`` runs the JAX
   package (``HansenTaxi-v4``, B = 2^20 envs, K = 256 steps), then the
   acting step of ``gym_po_tpu_torch.entry`` (ActorCritic 64x64 over
   ``ExtendedHansenTaxi-v4``, random weights from a seed);
2. tabular Q-learning on Taxi: the fused Q and double-Q trainer kernels at
   full width (``Taxi-v4``, B = 65,536, K = 256, lr = eps = 0.1, duplicates
   averaged), then training runs at B = 4,096, K = 4,096 through the
   kernels (the first 512 steps of each run's first chunk held against its
   twin, exactly) and
   the ``fused_q_learning`` driver, each greedy policy evaluated by
   ``vector.rollout`` and by the fused Taxi kernel against the JAX
   package's hardware-test thresholds, and the ``q_learning`` step_vec
   learner at B = 512 and B = 4,096;
3. the ROOMS workflow (``Rooms-v0``: layout '4', mdp obs, 8 ordinal
   actions, p_fail 0.2): the fused ROOMS rollout at the headline's size
   (B = 2^20, K = 256), the one-step Q, Watkins and Peng Q(lambda) (L = 16)
   and actor-critic trainer kernels at full width (B = 65,536, K = 256),
   then learning at the JAX package's hardware tests' schedules: Q through
   the kernel and the ``fused_q_learning`` entry point, Q(lambda) against
   one-step Q on layout '16', the actor-critic through the kernel and the
   ``fused_actor_critic`` entry point, each greedy policy evaluated by
   ``vector.rollout`` (the first chunk of each run, or its first 512
   steps, held against its twin);
4. MultistoryFourRooms and RockSample: the fused MSRooms rollout
   (``MultistoryFourRooms-v0`` at grid_z = 3) and the fused RockSample
   rollout (RockSample[7,8]) at the headline's size (B = 2^20, K = 256),
   RockSample(11, 11) with 11 rocks for the record, the MSRooms Q trainer
   kernel at full width (B = 65,536, K = 256), then MSRooms learning at the
   JAX package's hardware test's schedule through the kernel and the
   ``fused_q_learning`` entry point, the greedy policy evaluated by
   ``vector.rollout`` over 1,024 envs x 500 steps (> 1.0 goals per env);
5. the continuous envs: the fused CRooms rollout (``CRooms-v0`` defaults:
   layout '4', continuous 'yx' actions, no velocity, fixed goal) and the
   fused point-mass ``TagContinuous-v0`` and ``HeavenHellContinuous-v0``
   rollouts at the headline's size (B = 2^20, K = 256), the CRooms Q
   trainer kernel (ordinal actions) at full width (B = 65,536, K = 256),
   then CRooms learning at the JAX package's hardware test's schedule
   through the kernel and the ``fused_q_learning`` entry point (the last
   chunk's reward/step > 0.02);
6. the PPO update (``gym_po_tpu_torch.agents.ppo``) on
   ``ExtendedHansenTaxi-v4`` at ``PPOConfig``'s defaults (B = 4,096,
   T = 128, 4 epochs of 4 minibatches, hidden (64, 64), 'permute', f32):
   updates through ``init_train_state``, ``make_train_step`` and
   ``train``, each timed with its collect and learn halves split by CUDA
   events; the collect half's CUDA graph held against the eager collect
   bit for bit from one generator state and both timed, at B = 4,096 and
   B = 65,536; ``make_multi_train_step`` (each update one replay of an
   ``UpdateGraph``, the whole update in one CUDA graph) against as many
   ``make_train_step`` calls from one state, bit for bit, both timed, with
   the capture's seconds and one replayed update's device ops; ``train``
   through the multi step; then the JAX package's PPO learning runs
   (DiscreteCarFlag, the feedforward HeavenHell surrogate).  The one kernel
   it reaches is the discrete first layer's backward, ``embed_grad``;
7. recurrent PPO (``gym_po_tpu_torch.agents.ppo_rnn``) on the same env at
   the same defaults with the GRU 128 wide: updates through
   ``init_rnn_state`` and ``make_rnn_train_step``, each timed with its
   halves, one under ``torch.profiler`` (the learn half's device busy
   share), the collect graph held against the eager collect bit for bit
   and both timed, one update at B = 32,768; the PPO learn half in float32
   and bfloat16 side by side and one bfloat16 recurrent update; an update
   resumed from a checkpoint against the same update straight through, bit
   for bit; the JAX package's recurrent learning runs (the GRU HeavenHell
   surrogate, the DiscreteCarFlag and TagContinuous smoke runs) over seeds
   0-7, in eight worker processes (each run launch-bound on its own host
   core).  The one kernel it reaches is ``embed_grad``, the GRU embed's
   backward;
8. data parallelism through ``torch.distributed``
   (``gym_po_tpu_torch.parallel``): over a one-rank NCCL group, the fused
   Taxi Q trainer and the actor-critic (``fused_q_learning`` and
   ``fused_actor_critic`` with a ``mesh``, B = 65,536, K = 256) and the PPO
   update at ``PPOConfig``'s defaults each equal the same without the mesh,
   bit for bit, the PPO update timed both ways (the host time inside the
   mesh's all-reduces counted, one update each under ``torch.profiler``),
   the multi step with the mesh (its all-reduces in the update's CUDA
   graph) equal to it without, bit for bit, and the all-reduce of a Q
   table and of PPO's gradient timed; over two
   ranks sharing the card (gloo: NCCL takes one card per rank), the same
   trainers and a PPO update equal both shards run in one process and
   averaged, bit for bit, and a learn half is broken down (over gloo, each
   all-reduce's wait for the device and its call timed; without the mesh,
   both ranks at once and rank 0 alone; each profiled);
   ``dryrun_multichip(1)``; a Taxi frame from a card state; the gymnasium
   adapter where gymnasium is installed;
9. the articulated ant (``gym_po_tpu_torch.physics``, ``AntTagPhysics-v0``,
   ``AntHeavenHellPhysics-v0``), whose default ``pipeline="scalar"``
   forward runs the three kernels of ``csrc/ant_forward.cu``
   (``ant_smooth``, a warp per env; ``ant_rows``, a thread per (unit,
   env); ``ant_newton``, a warp per env): each kernel against its plain
   twin on the card (f64 to 1e-9 relative, f32 within the step gates) and
   timed at B = 4,096, with each kernel's registers, stack frame and
   shared memory (the previous design beside them:
   ``ops/probe_ant_forward.py ab``); the engine on the card against the CPU
   at f64 (64 contact states, a forward and an RK4 step), one env step of
   each env against the CPU stage by stage at f32; then, counted,
   ``step_vec`` under the sync debug mode (no host sync), 20 steps of
   random actions at B = 4,096 (finite, above the floor, inside the
   walls), env-steps/s at the envs' defaults (B = 4,096, frame_skip 15, 8
   Newton iterations, f32; RK4 and Euler) with device ops per env step,
   the device's busy share and each ant kernel's time in it
   (torch.profiler), and the active rows an env on the untimed steps
   against those ``ant_newton`` keeps resident, PPO updates on the ant at
   B = 4,096 (Euler at T = 8, RK4 at T = 2), the multi step against single
   updates at RK4, T = 2, ``train()`` on the heaven-hell env (Euler, T =
   8, two updates) and one GRU-PPO update on the tag env (Euler, T = 8),
   their metrics finite; then, for the record, the
   same rates and PPO updates with ``pipeline="array"`` (the batched
   engine), both routes of the 14x14 solve timed, ``render_ant`` of 4
   rows of a B = 4,096 card state of each env (equal to its CPU copy's
   frame, ms per frame), and the batch scan: one Euler ``step_vec`` at
   B = 16,384 against four at B = 4,096 (env-steps/s of each, their
   ratio, the peak memory), which shows whether chunking
   (``vector/chunked.py``) could be a speed remedy on the card.  It prints which of triton, mujoco,
   gymnasium and pygame the machine has.

Each phase prints one line; any failure exits non-zero.  There is no CPU
fallback: without a CUDA device the script fails before printing a result.

Phases: device; build of ``gym_po_tpu_torch/csrc`` (into
``build/gym_po_tpu_torch/``, one nvcc per source, in parallel); ``sass``:
no runtime integer division (MUFU.RCP, I2F.U32.RP) inside the Taxi and
RockSample rollouts' loops, no I2F.U32.RP inside the Tag, CRooms, ROOMS
and MSRooms rollouts' or the CRooms Q trainer's (their MUFU.RCP counted),
the other trainers' counts reported; ``divisors``: the
kernels' invariant-divisor helper against the hardware's ``/`` and ``%``
over all 2^32 u; Philox known answers; the Box-Muller normal's logf/cosf
against torch's over every uniform a draw can give (counts reported);
every kernel against its plain twin on the card, exact, in tape mode and
in Philox mode, and the trainers with per-block update sums (Q(lambda),
actor-critic, the one-step Q and double-Q trainers and the CRooms Q
trainer on both sides of their slab's choice) from one start and over
K = 0, 1, 2, 4 (the CRooms Q trainer also from a table holding -0 entries
and at time limit 1); the Tag, HeavenHell, CRooms, ROOMS and MSRooms
rollouts also where every env resets as often as it can, the CRooms ones
at cell sizes 0.5 and 0.75, the ROOMS and MSRooms ones with each of their
four spawn combinations;
distribution check against the step_vec
rollout path (Taxi and ROOMS); kernel vs twin at the headline's shape;
path 1 with the headline timing; path 2 with the trainers' timing and
learning checks; path 3 with the ROOMS timings and learning checks; path 4
with the MSRooms and RockSample timings and the MSRooms learning check;
path 5 with the CRooms, Tag and HeavenHell timings and the CRooms learning
check; the discrete first layer's backward, ``embed_grad``, against its
twin and the float64 sums at the taxi PPO minibatch and timed beside
PyTorch's index backward; path 6, PPO; path 7, recurrent PPO, bf16 and
resume; path 8, data parallelism; path 9, the ant (its kernels' checks
first).
The line before the last is the kernels' JSON record; the last line is the
result.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B_HEAD, K_HEAD = 1 << 20, 256  # headline: bench.py's fused-path defaults
B_CHECK, K_TAPE = 65536, 64
B_SCAN = 65536
B_ACT, ACT_STEPS = 4096, 8
PHILOX_KAT = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)  # Random123
# word 0 of the block countered (0, 0, 2, 0), key (0, 0): site 8 of env 0,
# step 0, seed 0 (the twin's value, itself held to Random123's vectors)
PHILOX_BLOCK2_KAT = 0x0661D677
DIST_ATOL = 0.02

# trainers: full width is the batch at which the JAX package quotes its
# fused-trainer rates; learning runs use its hardware tests' sizes
B_TRAIN, K_TRAIN, LR_TRAIN, EPS_TRAIN = 65536, 256, 0.1, 0.1
B_LEARN, K_LEARN = 4096, 4096
# the learning runs' first chunks are held against their twins over their
# first K_STRETCH steps (the actor-critic's and layout 16's Q(lambda)'s
# whole): in Philox mode a draw's counter is (env, step, block) and
# nothing depends on K, so a K_STRETCH call on the chunk's inputs and seed
# runs exactly the chunk's first K_STRETCH steps
K_STRETCH = 512
SCHED_Q = [(0.05, 0.3)] * 3 + [(0.02, 0.05)] * 3 + [(0.01, 0.01)] * 2
SCHED_QLAMBDA = [(0.3, 0.3)] * 2 + [(0.1, 0.05)] + [(0.05, 0.01)]
SCHED_DOUBLE = [(0.1, 0.3)] * 2 + [(0.05, 0.05)] * 2
# step_vec learner: tests/test_qlearning.py's schedule at its B = 512, and
# examples/solve_taxi.py's at B = 4,096.  The learner sums duplicates, so
# its step grows with B / ns: at B = 4,096 the test's schedule stalls at
# the never-pickup optimum in both packages (tests/_q_learning_at_scale.py)
SCHED_STEP_VEC_TEST = [(0.3, 0.1, 40), (0.05, 0.05, 40)]
SCHED_STEP_VEC = [(0.30, 0.05, 150), (0.05, 0.02, 150), (0.01, 0.01, 100)]

# ROOMS path: the rollout at the Taxi headline's size, the trainers at the
# Taxi trainers' width (Rooms-v0 defaults: layout '4', mdp obs, 8 ordinal
# actions, p_fail 0.2), learning at the JAX package's hardware tests'
# schedules and thresholds (tests/test_fused_qlearning.py:487-516,
# tests/test_fused_qlambda.py:260-300, tests/test_fused_ac.py:140-161)
B_ROOMS_CHECK = 65536
K_ROOMS_TAPE = 64
ALPHA_PI, ALPHA_V = 0.1, 0.2
SCHED_ROOMS_Q = [(0.2, 0.3)] * 2 + [(0.05, 0.05)] * 2
SCHED_ROOMS_AC = [(0.1, 0.2)] * 4
B_QLAMBDA, K_QLAMBDA = 1024, 512
REDESIGN_KS = (0, 1, 2, 4)  # call lengths of the redesign checks

# bounds: H100 SXM memory rate (NVIDIA H100 datasheet).  Operations by
# pipe, in lane-slots per SM per clock: an SM's four partitions each issue
# one warp instruction (32 lanes) per clock (Hopper white paper); the FMA
# pipe (IMAD*) and the ALU pipe (LOP3, IADD3, SHF, ISETP, SEL, ...) take
# 64 lanes per SM per clock each (CUDA C++ Programming Guide, arithmetic
# throughput of compute capability 9.0), and a 32x32->64 multiply
# (IMAD.WIDE.U32) takes two FMA slots: probe_fused_taxi ``rates`` measured,
# on an NVIDIA H100 80GB HBM3 at 700 W, IMAD at 61.92 lanes per SM per clock
# and a LOP3 feeding an IMAD.WIDE.U32 at 28.82, which only two slots per
# product explain.  A bound is the
# largest of bytes over the memory rate, each pipe's slots over its rate
# and all instructions over the issue rate.
# Philox4x32-10 per env and step, as the SASS of the kernels' step loops
# holds it (probe_fused_taxi ``sass``): the counter is (env, step, block,
# 0), so round 1's products and one of round 2's and of round 3's depend
# on the env and the block alone and are hoisted out of the loop (the key
# schedule too); a block whose four words are used is 16 wide products and
# 18 three-input XORs (LOP3), one whose used words are 0 and 1 only needs
# one product and one XOR less in round 10.  Every other operation of a
# step counts as free, so each bound is a lower bound.
HBM_BYTES_PER_S = 3.35e12
# f32 adds, multiplies and FMAs issue to either half of the FMA pipe, 128
# lanes per SM per clock, integer multiplies to one half only; MUFU and
# conversions take 16 (the same table)
PIPE_LANES_PER_SM = {"fma": 64, "fma+fp32": 128, "alu": 64, "xu": 16,
                     "issue": 128}
WIDE_PRODUCT_FMA_SLOTS = 2
# A Box-Muller normal's logf, cosf and sqrtf (gpt::rnormal) by pipe: one
# pass of a loop that draws two uniforms and takes rnormal of them, less
# one of the same loop taking their sum, each on its fast path, every
# forward branch taken over the library's rare cases (a subnormal or huge
# argument; probe_fused_taxi ``sass``, its ``libm`` lines, on an NVIDIA
# H100 80GB HBM3 at 700 W: issue 82 of the loop's 151 instructions, and the
# loop ran at 1.440 normals per SM per clock, 92 % of that issue count's
# rate).  The other pass-through instructions (moves, predicates) count as
# issue only.  A normal the function does not need (a resample where no
# wall is hit) is not counted.
NORMAL_SLOTS = {"fma": 5, "fp32": 33, "alu": 19, "xu": 2, "issue": 69}
# the trainers' applied update term: a fixed-point add (two 32-bit atomics)
# and a count add, three issued instructions on no arithmetic pipe
TERM_ISSUE = 3


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got, want, errs: list) -> None:
    """Exact equality of every output; records the largest difference."""
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g.double() - w.double()).abs().max().item()
        errs.append(diff)
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs (max {diff})")


def check_states(env, s: torch.Tensor) -> None:
    """Every encoded state is a valid Taxi state."""
    t = env.tables
    s = s.reshape(-1).long()
    if not ((s >= 0) & (s < t.ns)).all():
        raise AssertionError("state out of range")
    pd = (t.nlocs + 1) * t.nlocs
    cell, rem = s // pd, s % pd
    p, d = rem // t.nlocs, rem % t.nlocs
    valid = torch.as_tensor((t.tgrid != "|").reshape(-1), device=s.device)
    if not valid[cell].all():
        raise AssertionError("taxi on a wall cell")
    if ((p < t.nlocs) & (p == d)).any():
        raise AssertionError("waiting passenger at its own destination")


def occupancy(env, s: torch.Tensor) -> torch.Tensor:
    t = env.tables
    cell = s.reshape(-1).long() // ((t.nlocs + 1) * t.nlocs)
    return torch.bincount(cell, minlength=t.rows * t.cols).double() / cell.numel()


def tape_checks(dev, errs, B=B_CHECK, K=K_TAPE) -> None:
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_taxi_rollout

    gen = torch.Generator(device=dev).manual_seed(11)
    cases = [
        (env_id, kw, rpt, {})
        for env_id, kw in [("Taxi-v4", {}), ("ExtendedTaxi-v4", {}),
                           ("HansenTaxi-v4", {"num_passengers": 3})]
        for rpt in (128, 1)
    ]
    cases += [("ExtendedTaxi-v4", {}, 128, {"policy": "random-table"}),
              ("Taxi-v4", {}, 128, {"episode_stats": True})]
    for env_id, kw, rpt, opts in cases:
        env = gp.make(env_id, time_limit=25, device=dev, **kw)
        if opts.get("policy"):
            pol = np.random.default_rng(5).integers(0, 5, env.tables.ns)
            opts = {"policy": pol.astype(np.int32)}
        run = make_fused_taxi_rollout(env, B, K, rows_per_tile=rpt,
                                      rng_tape=True, **opts)
        _, st = env.reset_vec(gen, B)
        s0 = st.s.reshape(-1, 128).contiguous()
        tape = torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                             dtype=torch.int32, device=dev)
        got = run(3, s0, tape)
        want = run.twin(3, s0, tape)
        torch.cuda.synchronize()
        name = f"{env_id}{kw or ''} rows_per_tile={rpt} {list(opts) or ''}"
        compare(name, got, want, errs)
        check_states(env, got[0])
        if torch.unique(got[0]).numel() < 2:
            raise AssertionError(f"{name}: tape exercised nothing")
        if opts.get("episode_stats") and got[4].sum().item() == 0:
            raise AssertionError(f"{name}: no episode completed")
        say("tape", f"kernel == twin exactly: {name}, B={B} K={K}, "
            f"mean reward/step {got[1].mean().item() / K:.6f}")


def philox_check(dev, errs, B=B_CHECK, K=K_HEAD) -> None:
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_taxi_rollout

    env = gp.make("HansenTaxi-v4", device=dev)
    run = make_fused_taxi_rollout(env, B, K, episode_stats=True)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(2), B)
    s0 = st.s.reshape(-1, 128).contiguous()
    got = run(12345, s0)
    want = run.twin(12345, s0)
    torch.cuda.synchronize()
    compare("philox", got, want, errs)
    check_states(env, got[0])
    say("philox", f"kernel == twin exactly: HansenTaxi-v4 B={B} K={K}, "
        f"{int(got[4].sum().item())} episodes, mean reward/step "
        f"{got[1].mean().item() / K:.6f}")


def distribution_check(dev, B=B_HEAD, K=K_HEAD) -> None:
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_taxi_rollout
    from gym_po_tpu_torch.vector import rollout

    env = gp.make("HansenTaxi-v4", device=dev)
    run = make_fused_taxi_rollout(env, B, K)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    s, rew = run(7, st.s.reshape(-1, 128).contiguous())
    check_states(env, s)
    fused_mean = rew.double().mean().item() / K
    traj, (_, st_f) = rollout(env, torch.Generator(device=dev).manual_seed(1),
                              None, B, K)
    scan_mean = traj.reward.double().mean().item()
    occ_gap = (occupancy(env, s) - occupancy(env, st_f.s)).abs().max().item()
    say("distribution", f"HansenTaxi-v4 B={B} K={K}: mean reward/step fused "
        f"{fused_mean:.6f} vs step_vec {scan_mean:.6f}; max cell-occupancy "
        f"gap {occ_gap:.6f} (limit {DIST_ATOL})")
    if abs(fused_mean - scan_mean) >= DIST_ATOL or occ_gap >= DIST_ATOL:
        raise AssertionError("fused kernel's distribution differs from step_vec")


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside compare a kernel with its twin and are not
    the main path's: the launch counts are put back after."""
    from gym_po_tpu_torch.ops._build import LAUNCHES

    saved = LAUNCHES.copy()
    try:
        yield
    finally:
        LAUNCHES.clear()
        LAUNCHES.update(saved)


def stretch_check(name, stretch, args, errs, call=None) -> None:
    """A learning run's first chunk, its first K_STRETCH steps: the kernel
    (``stretch``, built at K = K_STRETCH, not counted) == its twin on the
    chunk's inputs and seed.  ``call(fn, *args)`` makes one call."""
    call = call or (lambda fn, *a: fn(*a))
    with uncounted():
        got = call(stretch, *args)
    want = call(stretch.twin, *args)
    torch.cuda.synchronize()
    compare(f"{name}, chunk 1", got, want, errs)
    say("learning-check", f"kernel == twin exactly: {name}, chunk 1's first "
        f"{K_STRETCH} steps, grid {stretch.grid} (blocks, envs/thread)")


def time_windows(fn, windows: int, calls: int) -> float:
    """Median seconds per call over ``windows`` windows of chained calls
    (host clock)."""
    times = []
    for w in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(w * calls + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls)
    return statistics.median(times)


def event_windows(fn, windows: int, calls: int) -> float:
    """Median ms per call over ``windows`` windows of chained calls (CUDA
    events); ``fn(i)`` is the ``i``-th call, which takes a new seed."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for w in range(windows):
        torch.cuda.synchronize()
        a.record()
        for i in range(calls):
            fn(w * calls + i)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


# ------------------------------------------------------------- trainers
def make_trainer(env, B, K, opts, rng_tape=False):
    from gym_po_tpu_torch.ops import (
        make_fused_double_q_trainer,
        make_fused_q_trainer,
    )

    if opts == "double":
        return make_fused_double_q_trainer(env, B, K, rng_tape=rng_tape)
    return make_fused_q_trainer(env, B, K, rng_tape=rng_tape, **opts)


def q_rows(env, opts) -> int:
    """Rows of the trainer's Q banks: one table, or the stacked pair."""
    from gym_po_tpu_torch.ops import bank_geometry

    if opts == "double":
        return 2 * bank_geometry(env.tables.ns, 5)[1]
    return bank_geometry(int(env.observation_space.n), 5)[1]


# env id, what the case covers, lr, builder options ("double": double Q)
TRAINER_TAPE_CASES = [
    ("Taxi-v4", "sum", 0.002, dict(average_duplicates=False)),
    ("Taxi-v4", "average + E-SARSA", 0.1,
     dict(average_duplicates=True, expected_sarsa=True)),
    ("HansenTaxi-v4", "average", 0.1, dict(average_duplicates=True)),
    ("ExtendedTaxi-v4", "average", 0.1, dict(average_duplicates=True)),
    ("Taxi-v4", "Q(lambda) Watkins L=4", 0.1,
     dict(average_duplicates=True, lam=0.8, trace_len=4)),
    ("ExtendedTaxi-v4", "Q(lambda) Peng L=16", 0.1,
     dict(average_duplicates=True, lam=0.9, trace_len=16, watkins_cut=False)),
    ("Taxi-v4", "double Q", 0.1, "double"),
]


def trainer_tape_checks(dev, errs, B=B_CHECK, K=K_TAPE, eps=0.3) -> None:
    """Each trainer kernel == its twin on a random tape from a random Q.
    The sum case takes a small lr: summed duplicates at B = 65,536 diverge
    for lr above about ns / B."""
    import gym_po_tpu_torch as gp

    gen = torch.Generator(device=dev).manual_seed(21)
    eps24 = int(np.float32(eps) * np.float32(1 << 24))
    for env_id, what, lr, opts in TRAINER_TAPE_CASES:
        env = gp.make(env_id, time_limit=25, device=dev)
        run = make_trainer(env, B, K, opts, rng_tape=True)
        _, st = env.reset_vec(gen, B)
        s0 = st.s.reshape(-1, 128).contiguous()
        q0 = 0.1 * torch.randn((q_rows(env, opts), 128), generator=gen,
                               device=dev)
        tape = torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                             dtype=torch.int32, device=dev)
        got = run(3, lr, eps, s0, q0, tape)
        want = run.twin(3, lr, eps, s0, q0, tape)
        torch.cuda.synchronize()
        name = f"{env_id} {what}"
        compare(name, got, want, errs[1 if opts == "double" else 0])
        check_states(env, got[0])
        # site 0 is the exploration draw of every env and step
        u = tape[: K * (B // 128)].long() & 0xFFFFFFFF
        explore = ((u >> 8) < eps24).double().mean().item()
        if not 0 < explore < 1:
            raise AssertionError(f"{name}: tape did not mix exploration "
                                 "and greedy actions")
        moved = got[1] != q0
        halves = moved.chunk(2) if opts == "double" else (moved,)
        if not all(0 < int(h.sum()) < h.numel() for h in halves):
            raise AssertionError(f"{name}: Q moved nowhere or everywhere "
                                 f"({[int(h.sum()) for h in halves]})")
        say("trainer-tape", f"kernel == twin exactly: {name}, B={B} K={K} "
            f"lr={lr} eps={eps}: explore share {explore:.4f}, Q entries "
            f"moved {[int(h.sum()) for h in halves]}, mean reward/step "
            f"{got[2].mean().item() / K:.6f}")


def trainer_philox_checks(dev, errs, plain_ms) -> None:
    """Each trainer kernel == its twin at full width in Philox mode, from a
    zero Q (exact ties among actions everywhere); the twin's ms/call, timed
    the way the kernel is, from the same calls."""
    import gym_po_tpu_torch as gp

    env = gp.make("Taxi-v4", device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(4), B_TRAIN)
    s0 = st.s.reshape(-1, 128).contiguous()
    for key, opts in (("fused_qlearning", dict(average_duplicates=True)),
                      ("fused_double_q", "double")):
        run = make_trainer(env, B_TRAIN, K_TRAIN, opts)
        q0 = torch.zeros((q_rows(env, opts), 128), device=dev)
        outs = []
        plain_ms[key] = event_windows(
            lambda i: outs.append(run.twin(100 + i, LR_TRAIN, EPS_TRAIN, s0,
                                           q0)), windows=1, calls=1)
        got = run(100, LR_TRAIN, EPS_TRAIN, s0, q0)
        torch.cuda.synchronize()
        compare(f"{key} Philox", got, outs[0],
                errs[1 if key == "fused_double_q" else 0])
        check_states(env, got[0])
        say("trainer-philox", f"kernel == twin exactly: {key} Taxi-v4 "
            f"B={B_TRAIN} K={K_TRAIN} lr={LR_TRAIN} eps={EPS_TRAIN} from "
            f"Q = 0, grid {run.grid} (blocks, envs/thread); twin "
            f"{plain_ms[key]:.3f} ms/call; mean reward/step "
            f"{got[2].mean().item() / K_TRAIN:.6f}")
        del outs


def evaluate(dev, env, name: str, q, bad_limit=None) -> None:
    """The greedy policy of ``q`` through ``vector.rollout`` and through the
    fused Taxi kernel, against the JAX hardware tests' thresholds."""
    from gym_po_tpu_torch.agents import greedy_policy
    from gym_po_tpu_torch.ops import make_fused_taxi_rollout, state_policy_table
    from gym_po_tpu_torch.vector import rollout

    traj, _ = rollout(env, torch.Generator(device=dev).manual_seed(9),
                      greedy_policy(q), 1024, 256)
    r = traj.reward
    mean = r.double().mean().item()
    drops = (r > 0.5).sum().item() / 1024
    bad = (r < -0.4).double().mean().item()
    run = make_fused_taxi_rollout(
        env, 1024, 256, policy=state_policy_table(env, greedy_policy(q)),
        episode_stats=True)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(10), 1024)
    _, rsum, _, _, ep_cnt = run(9, st.s.reshape(-1, 128).contiguous())
    f_mean = rsum.double().mean().item() / 256
    f_eps = ep_cnt.double().mean().item()
    say("learning", f"{name}: greedy policy, rollout 1024 envs x 256 steps: "
        f"mean reward/step {mean:.6f} (> 0.02), dropoffs/env {drops:.4f} "
        f"(> 15), bad moves {bad:.6f}"
        + (f" (< {bad_limit})" if bad_limit else "")
        + f"; fused Taxi kernel: mean reward/step {f_mean:.6f} (> 0.02), "
        f"episodes/env {f_eps:.4f} (> 15)")
    if mean <= 0.02 or drops <= 15 or f_mean <= 0.02 or f_eps <= 15:
        raise AssertionError(f"{name}: the greedy policy did not learn Taxi")
    if bad_limit is not None and bad >= bad_limit:
        raise AssertionError(f"{name}: too many bad moves")


def train_chunks(dev, env, run, stretch, sched, errs, name, n_tables=1):
    """The JAX hardware tests' loop: one trainer call per schedule entry,
    chunk ``i`` seeded ``i + 1``; returns the mean of the tables as
    ``[ns, 5]``.  The first chunk's first K_STRETCH steps are held against
    the twin (``stretch``: the same trainer at K = K_STRETCH), exactly: the
    learning runs' shape (B = 4,096, 16 blocks) is checked as well as the
    timed one."""
    from gym_po_tpu_torch.ops import banks_to_q

    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B_LEARN)
    s = st.s.reshape(-1, 128).contiguous()
    qb = torch.zeros((32 * n_tables, 128), device=dev)
    for i, (lr, eps) in enumerate(sched):
        if i == 0:
            stretch_check(name, stretch, (1, lr, eps, s, qb), errs)
        s, qb, rsum = run(i + 1, lr, eps, s, qb)
    qb = qb.cpu().numpy()
    q = sum(banks_to_q(half, 512) for half in np.split(qb, n_tables))
    return torch.as_tensor(q[: env.tables.ns] / n_tables, device=dev)


def learner_path(dev, kern_ms, errs) -> None:
    """Path 2: the trainers at full width (timed), then training runs, the
    first chunk of each held against its twin (``errs``: fused Q, double
    Q)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import (
        QConfig,
        fused_q_learning,
        greedy_policy,
        q_learning,
    )
    from gym_po_tpu_torch.vector import rollout

    env = gp.make("Taxi-v4", device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(5), B_TRAIN)
    for key, opts in (("fused_qlearning", dict(average_duplicates=True)),
                      ("fused_double_q", "double")):
        run = make_trainer(env, B_TRAIN, K_TRAIN, opts)
        carry = {"s": st.s.reshape(-1, 128).contiguous(),
                 "q": torch.zeros((q_rows(env, opts), 128), device=dev)}

        def call(i):
            carry["s"], carry["q"], _ = run(1000 + i, LR_TRAIN, EPS_TRAIN,
                                            carry["s"], carry["q"])

        call(-1)  # warm-up
        kern_ms[key] = event_windows(call, windows=5, calls=4)
        check_states(env, carry["s"])
        if not torch.isfinite(carry["q"]).all():
            raise AssertionError(f"{key}: non-finite Q")
        say("trainer-time", f"{key} Taxi-v4 B={B_TRAIN} K={K_TRAIN} "
            f"lr={LR_TRAIN} eps={EPS_TRAIN} average: {kern_ms[key]:.4f} "
            f"ms/call, {B_TRAIN * K_TRAIN / kern_ms[key] * 1e3:.6e} "
            f"train-steps/s (CUDA events, median of 5 windows x 4 chained "
            f"calls, a new seed each call)")

    t0 = time.perf_counter()
    for name, opts, sched, err, n_tables, bad_limit in (
            ("fused Q, summed duplicates, 8 chunks",
             dict(average_duplicates=False), SCHED_Q, errs[0], 1, None),
            ("fused Watkins Q(lambda=0.9, L=16), 4 chunks",
             dict(average_duplicates=True, lam=0.9, trace_len=16),
             SCHED_QLAMBDA, errs[0], 1, None),
            ("fused double Q, 4 chunks", "double", SCHED_DOUBLE, errs[1], 2,
             0.01)):
        run = make_trainer(env, B_LEARN, K_LEARN, opts)
        stretch = make_trainer(env, B_LEARN, K_STRETCH, opts)
        evaluate(dev, env, name,
                 train_chunks(dev, env, run, stretch, sched, err, name,
                              n_tables=n_tables),
                 bad_limit=bad_limit)
    q, hist = fused_q_learning(
        env, 0, [(lr, eps, K_LEARN) for lr, eps in SCHED_Q],
        num_envs=B_LEARN, chunk_steps=K_LEARN, average_duplicates=False)
    evaluate(dev, env, f"fused_q_learning driver (history "
             f"{', '.join(f'{h:.4f}' for h in hist)})", torch.as_tensor(q))
    say("learning", f"fused runs took {time.perf_counter() - t0:.2f} s")

    for B, sched in ((512, SCHED_STEP_VEC_TEST), (B_LEARN, SCHED_STEP_VEC)):
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        q = None
        for eps, lr, updates in sched:
            cfg = QConfig(num_envs=B, learning_rate=lr, epsilon=eps,
                          steps_per_update=128)
            q, hist = q_learning(env, cfg, gen, num_updates=updates, q_init=q)
        traj, _ = rollout(env, torch.Generator(device=dev).manual_seed(9),
                          greedy_policy(q), 256, 200)
        r = traj.reward
        drops = (r > 0.5).sum().item() / 256
        bad = (r < -0.4).double().mean().item()
        say("learning", f"q_learning (step_vec) B={B}, schedule {sched} "
            f"(eps, lr, updates of 128 steps) in "
            f"{time.perf_counter() - t0:.2f} s, last mean reward/step "
            f"{hist[-1][0]:.6f}: greedy rollout 256 envs x 200 steps, "
            f"dropoffs/env {drops:.4f} (> 2.0), bad moves {bad:.6f} (< 0.05)")
        if drops <= 2.0 or bad >= 0.05:
            raise AssertionError(f"q_learning B={B} did not learn Taxi")


# ---------------------------------------------------------------- ROOMS
def rooms_cells(env, yx: torch.Tensor) -> torch.Tensor:
    """Flat cells ``[B // 128, 128]`` of ``[B, 2]`` Rooms coordinates."""
    yx = yx.to(torch.int32)
    return (yx[:, 0] * env.grid_np.shape[1] + yx[:, 1]).reshape(-1, 128).contiguous()


def check_cells(env, agent: torch.Tensor) -> None:
    """Every agent sits on a walkable cell of the layout."""
    a = agent.reshape(-1).long()
    if not ((a >= 0) & (a < env.grid_np.size)).all():
        raise AssertionError("agent cell out of range")
    walk = torch.as_tensor(env.grid_np.reshape(-1) >= 0, device=a.device)
    if not walk[a].all():
        raise AssertionError("agent on a wall cell")


def rooms_occupancy(env, agent: torch.Tensor) -> torch.Tensor:
    a = agent.reshape(-1).long()
    return torch.bincount(a, minlength=env.grid_np.size).double() / a.numel()


# layout, env kwargs (time limit 40 unless given), rows_per_tile (B =
# 65,536: 4 or 512 tiles), stats; the last four: the four spawn
# combinations at time limit 1 (ROOMS truncates at >, so every env resets
# every second step), the respawns' edge
ROOMS_ROLLOUT_CASES = [
    ("4", {}, 128, False),
    ("16", {"goal_xy": None}, 1, True),
    ("32b", {"action_type": "cardinal"}, 128, True),
    ("4", {"time_limit": 1, "goal_xy": None}, 128, True),
    ("4", {"time_limit": 1}, 1, True),
    ("4", {"time_limit": 1, "goal_xy": None, "agent_xy": (1, 1)}, 128, True),
    ("16", {"time_limit": 1, "agent_xy": (1, 1)}, 128, True),
]


def rooms_rollout_checks(dev, errs, B=B_ROOMS_CHECK, K=K_ROOMS_TAPE) -> None:
    """The ROOMS rollout kernel == its twin, exactly: on a random tape and
    in Philox mode for three layouts (a random goal, episode stats, 4 and
    512 tiles) and the four spawn combinations at time limit 1, and in
    Philox mode over the headline's K."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_rooms_rollout

    gen = torch.Generator(device=dev).manual_seed(31)
    for mode in ("tape", "philox"):
        for layout, kw, rpt, stats in ROOMS_ROLLOUT_CASES:
            env = gp.make("Rooms-v0", layout=layout, device=dev,
                          **{"time_limit": 40, **kw})
            run = make_fused_rooms_rollout(env, B, K, rows_per_tile=rpt,
                                           episode_stats=stats,
                                           rng_tape=mode == "tape")
            _, st = env.reset_vec(gen, B)
            a0, g0 = rooms_cells(env, st.agent_yx), rooms_cells(env, st.goal_yx)
            tape = (torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                                  dtype=torch.int32, device=dev),
                    ) if mode == "tape" else ()
            got = run(3, a0, g0, *tape)
            want = run.twin(3, a0, g0, *tape)
            torch.cuda.synchronize()
            name = f"Rooms-v0 layout {layout} {kw or ''} rows_per_tile={rpt}" + (
                " episode_stats" if stats else "") + f" {mode}"
            compare(name, got, want, errs)
            check_cells(env, got[0])
            if stats and got[5].sum().item() == 0:
                raise AssertionError(f"{name}: no episode completed")
            if env.time_limit == 1 and not (got[5] >= K // 2).all():
                raise AssertionError(f"{name}: an env reset less than every "
                                     "second step")
            say("rooms-check", f"kernel == twin exactly: {name}, B={B} K={K}, "
                f"{run.n_sites} sites" + (
                    f", episodes per env {got[5].mean().item():.4f}" if stats
                    else ""))
    env = gp.make("Rooms-v0", goal_xy=None, time_limit=100, device=dev)
    run = make_fused_rooms_rollout(env, B, K_HEAD, episode_stats=True)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(32), B)
    a0, g0 = rooms_cells(env, st.agent_yx), rooms_cells(env, st.goal_yx)
    got, want = run(12345, a0, g0), run.twin(12345, a0, g0)
    torch.cuda.synchronize()
    compare("rooms philox", got, want, errs)
    check_cells(env, got[0])
    say("rooms-philox", f"kernel == twin exactly: Rooms-v0 random goal B={B} "
        f"K={K_HEAD}, {int(got[5].sum().item())} episodes, mean reward/step "
        f"{got[2].mean().item() / K_HEAD:.6f}")


def rooms_distribution_check(dev, B=1 << 18, K=K_HEAD) -> None:
    """Philox-mode rollout kernel against the step_vec path on the
    ``Rooms-v0`` defaults: mean reward/step and cell occupancy."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_rooms_rollout
    from gym_po_tpu_torch.vector import rollout

    env = gp.make("Rooms-v0", time_limit=50, device=dev)
    run = make_fused_rooms_rollout(env, B, K)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    agent, _, rew = run(7, rooms_cells(env, st.agent_yx),
                        rooms_cells(env, st.goal_yx))
    check_cells(env, agent)
    fused_mean = rew.double().mean().item() / K
    traj, (_, st_f) = rollout(env, torch.Generator(device=dev).manual_seed(1),
                              None, B, K)
    scan_mean = traj.reward.double().mean().item()
    occ_gap = (rooms_occupancy(env, agent) - rooms_occupancy(
        env, rooms_cells(env, st_f.agent_yx))).abs().max().item()
    say("rooms-distribution", f"Rooms-v0 time_limit=50 B={B} K={K}: mean "
        f"reward/step fused {fused_mean:.6f} vs step_vec {scan_mean:.6f}; max "
        f"cell-occupancy gap {occ_gap:.6f} (limit {DIST_ATOL})")
    if abs(fused_mean - scan_mean) >= DIST_ATOL or occ_gap >= DIST_ATOL:
        raise AssertionError("ROOMS kernel's distribution differs from step_vec")


# kernel name, trainer kind, options (Rooms-v0 defaults)
ROOMS_TRAINERS = [
    ("fused_q_rooms", "q", dict(average_duplicates=True)),
    ("fused_qlambda_rooms", "qlambda",
     dict(lam=0.9, trace_len=16, average_duplicates=True)),
    ("fused_qlambda_rooms Peng", "qlambda",
     dict(lam=0.9, trace_len=16, average_duplicates=True, watkins_cut=False)),
    ("fused_ac", "ac", {}),
]


def make_rooms_trainer(env, kind, B, K, opts, rng_tape=False):
    from gym_po_tpu_torch.ops import (
        make_fused_ac_trainer_rooms,
        make_fused_q_trainer_rooms,
        make_fused_qlambda_trainer_rooms,
    )

    build = {"q": make_fused_q_trainer_rooms,
             "qlambda": make_fused_qlambda_trainer_rooms,
             "ac": make_fused_ac_trainer_rooms}[kind]
    return build(env, B, K, rng_tape=rng_tape, **opts)


def rooms_call(fn, kind, seed, a, tables, lr, eps, *tape):
    """One call of a ROOMS trainer or its twin (``fn``: ``run`` or
    ``run.twin``); ``tables`` is ``(q,)`` or ``(theta, v)``.  Returns
    ``(agent', tables', reward_sums)``."""
    if kind == "ac":
        th, v, a, rew = fn(seed, lr, eps, *tables, a, *tape)
        return a, (th, v), rew
    a, q, rew = fn(seed, lr, eps, a, tables[0], *tape)
    return a, (q,), rew


def rooms_step_sizes(kind):
    return (ALPHA_PI, ALPHA_V) if kind == "ac" else (LR_TRAIN, EPS_TRAIN)


def rooms_trainer_checks(dev, errs, plain_ms, terms) -> None:
    """Each ROOMS trainer kernel == its twin: on a random tape from random
    tables (B = 65,536, K = 64), and in Philox mode at full width from zero
    tables (exact ties among actions), the twin's ms/call timed the way the
    kernel is, from the same calls; ``terms`` gets the update terms the
    twin's first full-width call applied, for the bounds."""
    import gym_po_tpu_torch as gp

    gen = torch.Generator(device=dev).manual_seed(41)
    env = gp.make("Rooms-v0", time_limit=60, device=dev)
    for key, kind, opts in ROOMS_TRAINERS:
        run = make_rooms_trainer(env, kind, B_ROOMS_CHECK, K_ROOMS_TAPE, opts,
                                 rng_tape=True)
        _, st = env.reset_vec(gen, B_ROOMS_CHECK)
        a0 = rooms_cells(env, st.agent_yx)
        n = 2 if kind == "ac" else 1
        tables = tuple(0.1 * torch.randn((32, 128), generator=gen, device=dev)
                       for _ in range(n))
        tape = torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                             dtype=torch.int32, device=dev)
        lr, eps = (0.1, 0.2) if kind == "ac" else (0.1, 0.3)
        got = rooms_call(run, kind, 3, a0, tables, lr, eps, tape)
        want = rooms_call(run.twin, kind, 3, a0, tables, lr, eps, tape)
        torch.cuda.synchronize()
        compare(f"{key} tape", flat_out(got), flat_out(want),
                errs[key.split()[0]])
        check_cells(env, got[0])
        moved = int((got[1][0] != tables[0]).sum())
        if not 0 < moved < tables[0].numel():
            raise AssertionError(f"{key}: table moved nowhere or everywhere")
        say("rooms-trainer-tape", f"kernel == twin exactly: {key} Rooms-v0 "
            f"B={B_ROOMS_CHECK} K={K_ROOMS_TAPE} lr={lr} eps={eps}: entries "
            f"moved {moved}, mean reward/step "
            f"{got[2].mean().item() / K_ROOMS_TAPE:.6f}")

    env = gp.make("Rooms-v0", device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(4), B_TRAIN)
    a0 = rooms_cells(env, st.agent_yx)
    for key, kind, opts in ROOMS_TRAINERS:
        run = make_rooms_trainer(env, kind, B_TRAIN, K_TRAIN, opts)
        tables = tuple(torch.zeros((32, 128), device=dev)
                       for _ in range(2 if kind == "ac" else 1))
        lr, eps = rooms_step_sizes(kind)
        outs = []
        plain_ms[key] = event_windows(
            lambda i: outs.append(rooms_call(run.twin, kind, 100 + i, a0,
                                             tables, lr, eps)),
            windows=1, calls=1)
        terms[key] = (int(run.twin.terms.item()) if kind != "ac"
                      else B_TRAIN * K_TRAIN)
        got = rooms_call(run, kind, 100, a0, tables, lr, eps)
        torch.cuda.synchronize()
        compare(f"{key} Philox", flat_out(got), flat_out(outs[0]),
                errs[key.split()[0]])
        check_cells(env, got[0])
        say("rooms-trainer-philox", f"kernel == twin exactly: {key} Rooms-v0 "
            f"B={B_TRAIN} K={K_TRAIN} ({lr}, {eps}) from zero tables, grid "
            f"{run.grid} (blocks, envs/thread); twin {plain_ms[key]:.3f} "
            f"ms/call; {terms[key]} update terms; mean reward/step "
            f"{got[2].mean().item() / K_TRAIN:.6f}")
        del outs


def redesign_checks(dev, errs) -> None:
    """The trainers whose updates are summed per block in shared memory with
    one grid barrier per step (Watkins and Peng Q(lambda), the actor-critic)
    == their twins where that design could go wrong: every env starting on
    one cell next to the goal (the most same-address adds in a block, and
    rewards within a few steps, so the tables move), Philox, K = 16; and
    K = 0, 1, 2, 4 on a tape from random tables (the three rotating
    accumulators before and after their first reuse), at B = 65,536.  At
    K = 0, where the twin draws nothing and refuses, the kernel must hand
    the inputs back with zero reward sums."""
    import gym_po_tpu_torch as gp

    env = gp.make("Rooms-v0", time_limit=30, device=dev)
    shape = env.grid_np.shape
    cell = next_to_goal(env.valid_states,
                        np.ravel_multi_index(env.fixed_goal_yx, shape), shape)
    gen = torch.Generator(device=dev).manual_seed(43)
    for key, kind, opts in ROOMS_TRAINERS[1:]:
        lr, eps = (0.1, 0.2) if kind == "ac" else (0.1, 0.3)
        n = 2 if kind == "ac" else 1
        a0 = torch.full((B_ROOMS_CHECK // 128, 128), cell, dtype=torch.int32,
                        device=dev)
        run = make_rooms_trainer(env, kind, B_ROOMS_CHECK, 16, opts)
        zeros = tuple(torch.zeros((32, 128), device=dev) for _ in range(n))
        got = rooms_call(run, kind, 5, a0, zeros, lr, eps)
        want = rooms_call(run.twin, kind, 5, a0, zeros, lr, eps)
        torch.cuda.synchronize()
        compare(f"{key} one start cell", flat_out(got), flat_out(want),
                errs[key.split()[0]])
        if not (got[1][0] != zeros[0]).any():
            raise AssertionError(f"{key}: one start cell moved no table entry")
        _, st = env.reset_vec(gen, B_ROOMS_CHECK)
        a0 = rooms_cells(env, st.agent_yx)
        tables = tuple(0.1 * torch.randn((32, 128), generator=gen, device=dev)
                       for _ in range(n))
        for K in REDESIGN_KS:
            run_k = make_rooms_trainer(env, kind, B_ROOMS_CHECK, K, opts,
                                       rng_tape=True)
            tape = torch.randint(-2**31, 2**31, run_k.tape_shape, generator=gen,
                                 dtype=torch.int32, device=dev)
            got_k = rooms_call(run_k, kind, 3, a0, tables, lr, eps, tape)
            want_k = (rooms_call(run_k.twin, kind, 3, a0, tables, lr, eps, tape)
                      if K else (a0, tables, torch.zeros(a0.shape, device=dev)))
            torch.cuda.synchronize()
            compare(f"{key} tape K={K}", flat_out(got_k), flat_out(want_k),
                    errs[key.split()[0]])
        say("redesign-check", f"kernel == twin exactly: {key} Rooms-v0 "
            f"B={B_ROOMS_CHECK}: every env from cell {cell}, K=16, Philox, "
            f"grid {run.grid} (blocks, envs/thread[, ring slots on chip]); "
            f"tape K = "
            f"{', '.join(map(str, REDESIGN_KS))} from random tables")


def next_to_goal(cells, goal, shape) -> int:
    """The first of the flat walkable ``cells`` one step from the flat
    ``goal`` cell on its floor, in a grid of ``shape`` (``[H, W]`` or
    ``[Z, H, W]``)."""
    cells = np.asarray(cells)
    at = np.stack(np.unravel_index(cells, shape), -1)
    g = np.asarray(np.unravel_index(goal, shape))
    dist = np.abs(at[:, -2:] - g[-2:]).sum(-1)
    return int(cells[(dist == 1) & (at[:, :-2] == g[:-2]).all(-1)][0])


# The one-step trainers on the redesigned step: kernel key, what, kind
# ("rooms", "msrooms", "taxi", "double"), duplicates averaged, lr (summed
# duplicates take a small one: every env of the one-start check adds to
# the same few entries)
ONE_STEP_REDESIGN = [
    ("fused_q_rooms", "Rooms-v0 summed", "rooms", False, 1e-5),
    ("fused_q_rooms", "Rooms-v0 averaged", "rooms", True, 0.1),
    ("fused_q_msrooms", "MultistoryFourRooms-v0 grid_z=3", "msrooms", True, 0.1),
    ("fused_qlearning", "Taxi-v4", "taxi", True, 0.1),
    ("fused_double_q", "Taxi-v4 double Q", "double", True, 0.1),
]


def one_step_case(dev, kind, avg, B, K, rng_tape=False, env_id="Taxi-v4"):
    """A one-step trainer of ``kind`` and its inputs: ``(run, starts(gen),
    one start tile, rows of its Q banks)``; ``starts(gen)`` draws a reset
    batch's start tile.  ROOMS and MSRooms start next to their fixed goal,
    Taxi from one reset state."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_q_trainer_msrooms

    if kind == "rooms":
        env = gp.make("Rooms-v0", time_limit=30, device=dev)
        run = make_rooms_trainer(env, "q", B, K, dict(average_duplicates=avg),
                                 rng_tape)
        shape = env.grid_np.shape
        one = next_to_goal(env.valid_states,
                           np.ravel_multi_index(env.fixed_goal_yx, shape), shape)

        def starts(gen):
            return rooms_cells(env, env.reset_vec(gen, B)[1].agent_yx)
        rows = 32
    elif kind == "msrooms":
        env = gp.make("MultistoryFourRooms-v0", grid_z=MSROOMS_Z, time_limit=30,
                      device=dev)
        run = make_fused_q_trainer_msrooms(env, B, K, average_duplicates=avg,
                                           rng_tape=rng_tape)
        shape = env.grid_np.shape
        one = next_to_goal(np.flatnonzero(env.grid_np.reshape(-1) > 0),
                           np.ravel_multi_index(env.fixed_goal_zyx, shape), shape)

        def starts(gen):
            return msrooms_cells(env, env.reset_vec(gen, B)[1].agent_zyx)
        rows = 32
    else:
        env = gp.make(env_id, time_limit=25, device=dev)
        opts = "double" if kind == "double" else dict(average_duplicates=avg)
        run = make_trainer(env, B, K, opts, rng_tape)

        def starts(gen):
            return env.reset_vec(gen, B)[1].s.reshape(-1, 128).contiguous()
        one = int(starts(torch.Generator(device=dev).manual_seed(0))[0, 0])
        rows = q_rows(env, opts)
    return run, starts, torch.full((B // 128, 128), one, dtype=torch.int32,
                                   device=dev), rows


def one_step_redesign_checks(dev, errs) -> None:
    """The one-step trainers, ROOMS Q [3] summed and averaged, MSRooms Q
    [4], Taxi Q [2] and double Q [11], on the redesigned step (the updates
    summed per block in a shared-memory slab, or straight into the global
    accumulator where that slab does not fit beside a launch that takes the
    batch; one grid barrier per step) == their twins: at B = 65,536 (the
    slab side) every env from one start (next to the goal on ROOMS and
    MSRooms), Philox, K = 16, and K = 0, 1, 2, 4 on a tape from random
    tables; at B = 2^20, K = 4, the global side (double Q, and Q on
    ExtendedTaxi-v4's 7,168-entry table) and the slab side (ROOMS, Taxi).
    ``errs`` maps each kernel's key to its error list."""
    gen = torch.Generator(device=dev).manual_seed(47)
    for key, what, kind, avg, lr in ONE_STEP_REDESIGN:
        run, starts, one, rows = one_step_case(dev, kind, avg, B_ROOMS_CHECK, 16)
        zeros = torch.zeros((rows, 128), device=dev)
        got = run(5, lr, 0.3, one, zeros)
        want = run.twin(5, lr, 0.3, one, zeros)
        torch.cuda.synchronize()
        compare(f"{key} {what} one start", got, want, errs[key])
        if not (got[1] != zeros).any():
            raise AssertionError(f"{key} {what}: one start moved no Q entry")
        if run.grid[1:] != (1, 1):
            raise AssertionError(f"{key} {what}: grid {run.grid}, not one env "
                                 "per thread with the slab on chip")
        q0 = 0.1 * torch.randn((rows, 128), generator=gen, device=dev)
        s0 = None
        for K in REDESIGN_KS:
            run_k, starts, _, _ = one_step_case(dev, kind, avg, B_ROOMS_CHECK,
                                                K, rng_tape=True)
            s0 = starts(gen) if s0 is None else s0
            tape = torch.randint(-2**31, 2**31, run_k.tape_shape, generator=gen,
                                 dtype=torch.int32, device=dev)
            lr_k = lr if avg else 0.002
            got_k = run_k(3, lr_k, 0.3, s0, q0, tape)
            want_k = (run_k.twin(3, lr_k, 0.3, s0, q0, tape) if K
                      else (s0, q0, torch.zeros(s0.shape, device=dev)))
            torch.cuda.synchronize()
            compare(f"{key} {what} tape K={K}", got_k, want_k, errs[key])
        say("redesign-check", f"kernel == twin exactly: {key} {what} "
            f"B={B_ROOMS_CHECK}: every env from {int(one[0, 0])}, K=16, "
            f"Philox, lr={lr}, grid {run.grid} (blocks, envs/thread, slab on "
            f"chip); tape K = {', '.join(map(str, REDESIGN_KS))} from random "
            f"tables")
    for key, what, kind, env_id, side in (
            ("fused_double_q", "Taxi-v4 double Q", "double", "Taxi-v4", 0),
            ("fused_qlearning", "ExtendedTaxi-v4", "taxi", "ExtendedTaxi-v4", 0),
            ("fused_q_rooms", "Rooms-v0", "rooms", None, 1),
            ("fused_qlearning", "Taxi-v4", "taxi", "Taxi-v4", 1)):
        run, starts, _, rows = one_step_case(dev, kind, True, B_HEAD, 4,
                                             env_id=env_id)
        s0 = starts(gen)
        q0 = 0.1 * torch.randn((rows, 128), generator=gen, device=dev)
        got = run(9, 0.1, 0.3, s0, q0)
        want = run.twin(9, 0.1, 0.3, s0, q0)
        torch.cuda.synchronize()
        compare(f"{key} {what} B={B_HEAD}", got, want, errs[key])
        if run.grid[2] != side:
            raise AssertionError(f"{key} {what} B={B_HEAD}: grid {run.grid}, "
                                 f"expected side {side}")
        say("redesign-check", f"kernel == twin exactly: {key} {what} "
            f"B={B_HEAD} K=4 Philox from random tables, grid {run.grid} "
            f"(blocks, envs/thread, slab on chip: "
            f"{'yes' if side else 'no, the global accumulator'})")


def flat_out(out):
    a, tables, rew = out
    return (a, *tables, rew)


def rooms_greedy_goals(dev, env, q, steps: int) -> float:
    """Goals per env of the greedy policy of ``q`` through ``vector.rollout``
    on ``step_vec``, 1,024 envs."""
    from gym_po_tpu_torch.agents import greedy_policy
    from gym_po_tpu_torch.vector import rollout

    traj, _ = rollout(env, torch.Generator(device=dev).manual_seed(9),
                      greedy_policy(torch.as_tensor(q)), 1024, steps)
    return (traj.reward > 0.5).sum().item() / 1024


def rooms_learn(dev, env, run, kind, sched, B, errs, name, cells=None,
                stretch=None):
    """The JAX hardware tests' loop: one trainer call per schedule entry,
    chunk ``i`` seeded ``i + 1``, from ``reset_vec`` seeded 0 and zero
    tables; the first chunk held against the twin, exactly, whole or (given
    ``stretch``, the trainer at K = K_STRETCH) over its first K_STRETCH
    steps.  ``cells`` maps the reset state to the agent tile (ROOMS' by
    default).  Returns the tables as numpy ``[n_obs, A]`` (and
    ``[n_obs]``)."""
    from gym_po_tpu_torch.ops import banks_to_q

    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    a = cells(st) if cells else rooms_cells(env, st.agent_yx)
    tables = tuple(torch.zeros((32, 128), device=dev)
                   for _ in range(2 if kind == "ac" else 1))
    for i, (lr, eps) in enumerate(sched):
        if i == 0 and stretch is not None:
            stretch_check(name, stretch, (1, a, tables, lr, eps), errs,
                          call=lambda fn, *x: flat_out(rooms_call(fn, kind, *x)))
        want = (rooms_call(run.twin, kind, i + 1, a, tables, lr, eps)
                if i == 0 and stretch is None else None)
        a, tables, rew = rooms_call(run, kind, i + 1, a, tables, lr, eps)
        if want is not None:
            torch.cuda.synchronize()
            compare(f"{name}, chunk 1", flat_out((a, tables, rew)),
                    flat_out(want), errs)
            say("rooms-learning", f"kernel == twin exactly: {name}, chunk 1, "
                f"B={B} lr/eps {lr}/{eps}, grid {run.grid} (blocks, envs/thread)")
            del want
    n_obs, A = int(env.observation_space.n), env.num_actions
    out = [banks_to_q(tables[0].cpu().numpy(), 512, na=A)[:n_obs]]
    if kind == "ac":
        out.append(banks_to_q(tables[1].cpu().numpy(), 512, na=1)[:n_obs, 0])
    return out


def rooms_learning(dev, errs) -> None:
    """Learning on ROOMS through the kernels and the entry points, against the
    JAX package's hardware tests' thresholds."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import fused_actor_critic, fused_q_learning

    t0 = time.perf_counter()
    env = gp.make("Rooms-v0", device=dev)
    opts = dict(average_duplicates=True)
    run = make_rooms_trainer(env, "q", B_LEARN, K_LEARN, opts)
    (q,) = rooms_learn(dev, env, run, "q", SCHED_ROOMS_Q, B_LEARN,
                       errs["fused_q_rooms"], "fused Q on Rooms-v0",
                       stretch=make_rooms_trainer(env, "q", B_LEARN, K_STRETCH,
                                                  opts))
    q2, hist = fused_q_learning(
        env, 0, [(lr, eps, K_LEARN) for lr, eps in SCHED_ROOMS_Q],
        num_envs=B_LEARN, chunk_steps=K_LEARN, average_duplicates=True)
    if not np.array_equal(q, q2):
        raise AssertionError("fused_q_learning differs from the kernel loop")
    goals = rooms_greedy_goals(dev, env, q, 256)
    say("rooms-learning", f"fused Q on Rooms-v0 layout 4, B={B_LEARN}, 4 "
        f"chunks of K={K_LEARN} {SCHED_ROOMS_Q} (lr, eps): reward/step per "
        f"chunk {', '.join(f'{h:.6f}' for h in hist)}; the fused_q_learning "
        f"entry point gives the same table; greedy rollout 1024 envs x 256 steps: "
        f"goals/env {goals:.4f} (> 2.0)")
    if goals <= 2.0:
        raise AssertionError("fused Q did not learn Rooms-v0")

    env16 = gp.make("Rooms-v0", layout="16", device=dev)
    goal_l = {}
    for key, opts in (("fused_qlambda_rooms", dict(lam=0.9, trace_len=16)),
                      ("fused_q_rooms", {})):
        kind = "qlambda" if opts else "q"
        run = make_rooms_trainer(env16, kind, B_QLAMBDA, K_QLAMBDA,
                                 dict(gamma=0.99, average_duplicates=True,
                                      **opts))
        (q,) = rooms_learn(dev, env16, run, kind, [(0.3, 0.3)] * 2,
                           B_QLAMBDA, errs[key], f"{key} on layout 16")
        goal_l[key] = rooms_greedy_goals(dev, env16, q, 512)
    gl, g1 = goal_l["fused_qlambda_rooms"], goal_l["fused_q_rooms"]
    # The JAX test also asks Q(lambda) > 2x one-step (its TPU run quotes
    # 15.3 against 3.3).  Driven by uniform draws, one-step Q learns layout
    # 16 nearly as well as Q(lambda) in the port and in the JAX package's
    # own kernels alike (tests/_rooms_one_step_vs_qlambda.py): the ratio is
    # reported, not held
    say("rooms-learning", f"layout 16, B={B_QLAMBDA}, 2 chunks of "
        f"K={K_QLAMBDA} at (0.3, 0.3): greedy goals/env over 1024 envs x 512 "
        f"steps: Watkins Q(lambda=0.9, L=16) {gl:.4f} (> 8.0), one-step Q "
        f"{g1:.4f} (ratio {gl / max(g1, 1e-9):.4f}, not held)")
    if gl <= 8.0:
        raise AssertionError("Q(lambda) did not learn layout 16")

    # the actor-critic's first chunk is held whole, all K_LEARN steps: a
    # redesigned trainer (per-block sums, one barrier per step) over a
    # learning run's whole chunk (layout 16's Q(lambda) holds its first
    # K_QLAMBDA chunk whole too)
    run = make_rooms_trainer(env, "ac", B_LEARN, K_LEARN, {})
    th, v = rooms_learn(dev, env, run, "ac", SCHED_ROOMS_AC, B_LEARN,
                        errs["fused_ac"], "fused actor-critic")
    th2, v2, hist = fused_actor_critic(
        env, 0, [(ALPHA_PI, ALPHA_V, K_LEARN * len(SCHED_ROOMS_AC))],
        num_envs=B_LEARN, chunk_steps=K_LEARN)
    if not (np.array_equal(th, th2) and np.array_equal(v, v2)):
        raise AssertionError("fused_actor_critic differs from the kernel loop")
    say("rooms-learning", f"fused actor-critic on Rooms-v0, B={B_LEARN}, 4 "
        f"chunks of K={K_LEARN} at ({ALPHA_PI}, {ALPHA_V}): goal rate per "
        f"chunk {', '.join(f'{h:.6f}' for h in hist)} (last > 0.03); the "
        f"fused_actor_critic entry point gives the same tables")
    if hist[-1] <= 0.03:
        raise AssertionError("fused actor-critic did not learn Rooms-v0")
    say("rooms-learning", f"ROOMS learning runs took "
        f"{time.perf_counter() - t0:.2f} s")


def rooms_path(dev, kern_ms, errs) -> None:
    """Path 3 (counted): the ROOMS trainers at full width (timed), then the
    learning runs."""
    import gym_po_tpu_torch as gp

    env = gp.make("Rooms-v0", device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(5), B_TRAIN)
    for key, kind, opts in ROOMS_TRAINERS:
        run = make_rooms_trainer(env, kind, B_TRAIN, K_TRAIN, opts)
        lr, eps = rooms_step_sizes(kind)
        carry = {"a": rooms_cells(env, st.agent_yx),
                 "t": tuple(torch.zeros((32, 128), device=dev)
                            for _ in range(2 if kind == "ac" else 1))}

        def call(i):
            carry["a"], carry["t"], _ = rooms_call(
                run, kind, 1000 + i, carry["a"], carry["t"], lr, eps)

        call(-1)  # warm-up
        kern_ms[key] = event_windows(call, windows=5, calls=4)
        check_cells(env, carry["a"])
        if not all(torch.isfinite(t).all() for t in carry["t"]):
            raise AssertionError(f"{key}: non-finite table")
        say("rooms-trainer-time", f"{key} Rooms-v0 B={B_TRAIN} K={K_TRAIN} "
            f"({lr}, {eps}): {kern_ms[key]:.4f} ms/call, "
            f"{B_TRAIN * K_TRAIN / kern_ms[key] * 1e3:.6e} train-steps/s "
            f"(CUDA events, median of 5 windows x 4 chained calls)")
    rooms_learning(dev, errs)


# ------------------------------------------- MultistoryFourRooms, RockSample
# Path 4: the MSRooms rollout and Q trainer at the ROOMS path's sizes
# (MultistoryFourRooms-v0 at grid_z = 3: three 13x13 floors, 312 walkable
# cells, mdp obs, 4 cardinal actions, p_fail 1/3, fixed top-floor goal, random
# ground-floor agent), learning at the JAX hardware test's schedule and
# threshold (tests/test_fused_qlearning.py:542-570), and the RockSample
# rollout at Smith & Simmons' RockSample[7,8] (the JAX tape test's size).
MSROOMS_Z = 3
SCHED_MSROOMS_Q = SCHED_ROOMS_Q  # one schedule in both JAX hardware tests
MSROOMS_EVAL_STEPS = 500
ROCKSAMPLE_HEAD = ((7, 7), 8)
ROCKSAMPLE_WIDEST = ((11, 11), 11)  # 121 of the kernel's 128 cells
# RockSample's rewards are +-10 and -100 (an illegal sample), a per-step s.d.
# of about 25 under the random policy: the s.d. of an env's mean over 256
# steps is about 1.6, so over 2^18 envs a path's mean reward/step has a
# standard error of about 0.003, and 0.05 is more than ten standard errors of
# the two paths' difference.  The good-rock share is a mean of 2^21 bits
# (s.e. below 0.001 for independent bits), held to 0.01.
ROCKSAMPLE_REW_ATOL, ROCKSAMPLE_BIT_ATOL = 0.05, 0.01


def msrooms_cells(env, zyx: torch.Tensor) -> torch.Tensor:
    """Flat cells ``[B // 128, 128]`` of ``[B, 3]`` MSRooms coordinates."""
    zyx = zyx.to(torch.int32)
    _, H, GW = env.grid_np.shape
    return (zyx[:, 0] * H * GW + zyx[:, 1] * GW + zyx[:, 2]).reshape(
        -1, 128).contiguous()


def check_msrooms_cells(env, agent: torch.Tensor) -> None:
    """Every agent sits on a walkable cell of the stacked floors."""
    a = agent.reshape(-1).long()
    if not ((a >= 0) & (a < env.grid_np.size)).all():
        raise AssertionError("agent cell out of range")
    walk = torch.as_tensor(env.grid_np.reshape(-1) > 0, device=a.device)
    if not walk[a].all():
        raise AssertionError("agent on a wall cell")


def floor_share(env, agent: torch.Tensor) -> torch.Tensor:
    z = agent.reshape(-1).long() // (env.grid_np.shape[1] * env.grid_np.shape[2])
    return torch.bincount(z, minlength=env.grid_np.shape[0]).double() / z.numel()


def rocksample_state(env, st):
    """``(pos, mask)`` tiles of a RockSample state."""
    from gym_po_tpu_torch.ops import rock_bitmask

    pos = st.pos_yx[:, 0] * env.cols + st.pos_yx[:, 1]
    return (pos.to(torch.int32).reshape(-1, 128).contiguous(),
            rock_bitmask(st.rock_good).reshape(-1, 128).contiguous())


def check_rocksample(env, pos: torch.Tensor, mask: torch.Tensor) -> None:
    if not ((pos >= 0) & (pos < env.rows * env.cols)).all():
        raise AssertionError("rover position out of range")
    if not ((mask >= 0) & (mask < (1 << env.k))).all():
        raise AssertionError("rock bitmask out of range")


def good_share(env, mask: torch.Tensor) -> float:
    bits = (mask.reshape(-1, 1) >> torch.arange(env.k, device=mask.device)) & 1
    return bits.double().mean().item()


# env kwargs (time limit 40 unless given), rows_per_tile (B = 65,536: 4 or
# 512 tiles), stats: the four spawn combinations (goal fixed or drawn, agent
# drawn or fixed), and every env resetting every second step
MSROOMS_ROLLOUT_CASES = [
    (dict(grid_z=1), 128, False),
    (dict(grid_z=3), 1, True),
    (dict(grid_z=3, goal_xyz=None), 128, True),
    (dict(grid_z=3, action_type="ordinal", agent_xyz=(1, 1, 0)), 128, False),
    (dict(grid_z=3, goal_xyz=None, agent_xyz=(1, 1, 0)), 128, True),
    (dict(grid_z=3, goal_xyz=None, time_limit=1), 128, True),
]
ROCKSAMPLE_CASES = [((5, 5), 5, 1, True), ((7, 7), 8, 128, False),
                    ((11, 11), 11, 128, True)]


def path4_rollout_checks(dev, errs, B=B_ROOMS_CHECK, K=K_ROOMS_TAPE) -> None:
    """The MSRooms and RockSample rollout kernels == their twins, exactly,
    on a random tape and in Philox mode (B = 65,536, K = 64)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import (
        make_fused_msrooms_rollout,
        make_fused_rocksample_rollout,
    )

    gen = torch.Generator(device=dev).manual_seed(51)
    for mode in ("tape", "philox"):
        for kw, rpt, stats in MSROOMS_ROLLOUT_CASES:
            env = gp.make("MultistoryFourRooms-v0", device=dev,
                          **{"time_limit": 40, **kw})
            run = make_fused_msrooms_rollout(env, B, K, rows_per_tile=rpt,
                                             episode_stats=stats,
                                             rng_tape=mode == "tape")
            _, st = env.reset_vec(gen, B)
            a0, g0 = msrooms_cells(env, st.agent_zyx), msrooms_cells(env, st.goal_zyx)
            tape = (torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                                  dtype=torch.int32, device=dev),) \
                if mode == "tape" else ()
            got, want = run(3, a0, g0, *tape), run.twin(3, a0, g0, *tape)
            torch.cuda.synchronize()
            name = f"MultistoryFourRooms-v0 {kw} rows_per_tile={rpt}" + (
                " episode_stats" if stats else "") + f" {mode}"
            compare(name, got, want, errs["fused_msrooms"])
            check_msrooms_cells(env, got[0])
            if stats and got[5].sum().item() == 0:
                raise AssertionError(f"{name}: no episode completed")
            if kw.get("time_limit") == 1 and not (got[5] >= K // 2).all():
                raise AssertionError(f"{name}: an env did not reset every "
                                     "second step")
            say("msrooms-check", f"kernel == twin exactly: {name}, B={B} K={K}, "
                f"floor shares {[round(x, 4) for x in floor_share(env, got[0]).tolist()]}")
        for map_size, k, rpt, stats in ROCKSAMPLE_CASES:
            env = gp.make("RockSample-v0", map_size=map_size, num_rocks=k,
                          time_limit=25, device=dev)
            run = make_fused_rocksample_rollout(env, B, K, rows_per_tile=rpt,
                                                episode_stats=stats,
                                                rng_tape=mode == "tape")
            p0, m0 = rocksample_state(env, env.reset_vec(gen, B)[1])
            tape = (torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                                  dtype=torch.int32, device=dev),) \
                if mode == "tape" else ()
            got, want = run(3, p0, m0, *tape), run.twin(3, p0, m0, *tape)
            torch.cuda.synchronize()
            name = f"RockSample{map_size + (k,)} rows_per_tile={rpt}" + (
                " episode_stats" if stats else "") + f" {mode}"
            compare(name, got, want, errs["fused_rocksample"])
            check_rocksample(env, got[0], got[1])
            if stats and got[5].sum().item() == 0:
                raise AssertionError(f"{name}: no episode completed")
            say("rocksample-check", f"kernel == twin exactly: {name}, B={B} "
                f"K={K}, mean reward/step {got[2].mean().item() / K:.6f}")


def path4_distribution_checks(dev, B=1 << 18, K=K_HEAD) -> None:
    """Philox-mode rollout kernels against the step_vec path: MSRooms mean
    reward/step and per-floor occupancy within DIST_ATOL; RockSample mean
    reward/step and good-rock share within their stated tolerances."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import (
        make_fused_msrooms_rollout,
        make_fused_rocksample_rollout,
    )
    from gym_po_tpu_torch.vector import rollout

    env = gp.make("MultistoryFourRooms-v0", grid_z=MSROOMS_Z, goal_xyz=None,
                  time_limit=100, device=dev)
    run = make_fused_msrooms_rollout(env, B, K)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    agent, _, rew = run(7, msrooms_cells(env, st.agent_zyx),
                        msrooms_cells(env, st.goal_zyx))
    check_msrooms_cells(env, agent)
    fused_mean = rew.double().mean().item() / K
    traj, (_, st_f) = rollout(env, torch.Generator(device=dev).manual_seed(1),
                              None, B, K)
    scan_mean = traj.reward.double().mean().item()
    fs, ss = floor_share(env, agent), floor_share(env, msrooms_cells(env, st_f.agent_zyx))
    gap = (fs - ss).abs().max().item()
    say("msrooms-distribution", f"MultistoryFourRooms-v0 grid_z={MSROOMS_Z} "
        f"random goal time_limit=100 B={B} K={K}: mean reward/step fused "
        f"{fused_mean:.6f} vs step_vec {scan_mean:.6f}; floor shares fused "
        f"{[round(x, 6) for x in fs.tolist()]} vs step_vec "
        f"{[round(x, 6) for x in ss.tolist()]}, max gap {gap:.6f} (limit {DIST_ATOL})")
    if abs(fused_mean - scan_mean) >= DIST_ATOL or gap >= DIST_ATOL:
        raise AssertionError("MSRooms kernel's distribution differs from step_vec")

    (rows, cols), k = ROCKSAMPLE_HEAD
    env = gp.make("RockSample-v0", map_size=(rows, cols), num_rocks=k, device=dev)
    run = make_fused_rocksample_rollout(env, B, K)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
    pos, mask, rew = run(7, *rocksample_state(env, st))
    check_rocksample(env, pos, mask)
    fused_mean = rew.double().mean().item() / K
    traj, (_, st_f) = rollout(env, torch.Generator(device=dev).manual_seed(1),
                              None, B, K)
    scan_mean = traj.reward.double().mean().item()
    fb, sb = good_share(env, mask), st_f.rock_good.double().mean().item()
    say("rocksample-distribution", f"RockSample{(rows, cols, k)} B={B} K={K}: "
        f"mean reward/step fused {fused_mean:.6f} vs step_vec {scan_mean:.6f} "
        f"(limit {ROCKSAMPLE_REW_ATOL}); good-rock share fused {fb:.6f} vs "
        f"step_vec {sb:.6f} (limit {ROCKSAMPLE_BIT_ATOL})")
    if (abs(fused_mean - scan_mean) >= ROCKSAMPLE_REW_ATOL
            or abs(fb - sb) >= ROCKSAMPLE_BIT_ATOL):
        raise AssertionError("RockSample kernel's distribution differs from step_vec")


def msrooms_trainer_checks(dev, errs, plain_ms, terms) -> None:
    """The MSRooms Q trainer kernel == its twin: on a random tape from a
    random Q (B = 65,536, K = 64; grid_z 1 and 3, summed and averaged,
    ordinal actions with a fixed agent), and in Philox mode at full width
    from a zero Q, the twin's ms/call timed the way the kernel is, from the
    same calls; ``terms`` gets the update terms of the first full-width
    call, for the bound."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_q_trainer_msrooms

    gen = torch.Generator(device=dev).manual_seed(61)
    # summed duplicates take a small lr: at B = 65,536 most envs sit on the
    # ground floor's 104 observations, hundreds of terms per greedy entry
    # per step, and lr = 0.002 diverged to NaN within K = 64
    for kw, avg, lr in ((dict(grid_z=1), True, 0.1),
                        (dict(grid_z=MSROOMS_Z), False, 0.0002),
                        (dict(grid_z=MSROOMS_Z, action_type="ordinal",
                              agent_xyz=(1, 1, 0)), True, 0.1)):
        env = gp.make("MultistoryFourRooms-v0", time_limit=60, device=dev, **kw)
        run = make_fused_q_trainer_msrooms(env, B_ROOMS_CHECK, K_ROOMS_TAPE,
                                           average_duplicates=avg, rng_tape=True)
        _, st = env.reset_vec(gen, B_ROOMS_CHECK)
        a0 = msrooms_cells(env, st.agent_zyx)
        q0 = 0.1 * torch.randn((32, 128), generator=gen, device=dev)
        tape = torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                             dtype=torch.int32, device=dev)
        got = run(3, lr, 0.3, a0, q0, tape)
        want = run.twin(3, lr, 0.3, a0, q0, tape)
        torch.cuda.synchronize()
        name = f"fused_q_msrooms {kw} {'averaged' if avg else 'summed'}"
        compare(f"{name} tape", got, want, errs)
        check_msrooms_cells(env, got[0])
        moved = int((got[1] != q0).sum())
        if not 0 < moved < q0.numel():
            raise AssertionError(f"{name}: Q moved nowhere or everywhere")
        say("msrooms-trainer-tape", f"kernel == twin exactly: {name}, "
            f"B={B_ROOMS_CHECK} K={K_ROOMS_TAPE} lr={lr} eps=0.3: entries "
            f"moved {moved}, mean reward/step "
            f"{got[2].mean().item() / K_ROOMS_TAPE:.6f}")

    env = gp.make("MultistoryFourRooms-v0", grid_z=MSROOMS_Z, device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(4), B_TRAIN)
    a0 = msrooms_cells(env, st.agent_zyx)
    run = make_fused_q_trainer_msrooms(env, B_TRAIN, K_TRAIN,
                                       average_duplicates=True)
    q0 = torch.zeros((32, 128), device=dev)
    outs = []
    plain_ms["fused_q_msrooms"] = event_windows(
        lambda i: outs.append(run.twin(100 + i, LR_TRAIN, EPS_TRAIN, a0, q0)),
        windows=1, calls=1)
    terms["fused_q_msrooms"] = int(run.twin.terms.item())
    got = run(100, LR_TRAIN, EPS_TRAIN, a0, q0)
    torch.cuda.synchronize()
    compare("fused_q_msrooms Philox", got, outs[0], errs)
    check_msrooms_cells(env, got[0])
    say("msrooms-trainer-philox", f"kernel == twin exactly: fused_q_msrooms "
        f"grid_z={MSROOMS_Z} B={B_TRAIN} K={K_TRAIN} lr={LR_TRAIN} "
        f"eps={EPS_TRAIN} averaged, from Q = 0, grid {run.grid} (blocks, "
        f"envs/thread); twin {plain_ms['fused_q_msrooms']:.3f} ms/call; "
        f"{terms['fused_q_msrooms']} update terms")


def path4_headline_checks(dev, errs, plain_ms):
    """The two rollout kernels against their twins at the headline's shape
    (B = 2^20, K = 256; the twins' first timed call), exact, not counted.
    Returns the ``(run, env, state)`` of each, for the counted timings."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import (
        make_fused_msrooms_rollout,
        make_fused_rocksample_rollout,
    )

    menv = gp.make("MultistoryFourRooms-v0", grid_z=MSROOMS_Z, device=dev)
    mrun = make_fused_msrooms_rollout(menv, B_HEAD, K_HEAD)
    _, st = menv.reset_vec(torch.Generator(device=dev).manual_seed(0), B_HEAD)
    mstate = (msrooms_cells(menv, st.agent_zyx), msrooms_cells(menv, st.goal_zyx))
    (rows, cols), k = ROCKSAMPLE_HEAD
    renv = gp.make("RockSample-v0", map_size=(rows, cols), num_rocks=k, device=dev)
    rrun = make_fused_rocksample_rollout(renv, B_HEAD, K_HEAD)
    rstate = rocksample_state(
        renv, renv.reset_vec(torch.Generator(device=dev).manual_seed(0), B_HEAD)[1])
    for key, run, state in (("fused_msrooms", mrun, mstate),
                            ("fused_rocksample", rrun, rstate)):
        twin_out = []
        plain_ms[key] = 1e3 * time_windows(
            lambda i: twin_out.append(run.twin(100 + i, *state)), windows=1,
            calls=1)
        compare(f"{key} headline shape B={B_HEAD} K={K_HEAD}", run(100, *state),
                twin_out[0], errs[key])
        del twin_out
        say("path4-headline-check", f"kernel == twin exactly: {key} B={B_HEAD} "
            f"K={K_HEAD}, Philox mode; twin {plain_ms[key]:.3f} ms/call")
    return (mrun, menv, mstate), (rrun, renv, rstate)


def path4_rollout_times(dev, card, heads, kern_ms) -> None:
    """The counted rollout timings: MSRooms and RockSample[7,8] at B = 2^20,
    K = 256, then RockSample(11, 11) with 11 rocks for the record."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_rocksample_rollout

    (mrun, menv, mstate), (rrun, renv, rstate) = heads
    (wrows, wcols), wk = ROCKSAMPLE_WIDEST
    wenv = gp.make("RockSample-v0", map_size=(wrows, wcols), num_rocks=wk,
                   device=dev)
    wrun = make_fused_rocksample_rollout(wenv, B_HEAD, K_HEAD)
    wstate = rocksample_state(
        wenv, wenv.reset_vec(torch.Generator(device=dev).manual_seed(0), B_HEAD)[1])
    steps = B_HEAD * K_HEAD
    for key, name, run, env, state in (
            ("fused_msrooms", f"MultistoryFourRooms-v0 grid_z={MSROOMS_Z}",
             mrun, menv, mstate),
            ("fused_rocksample", f"RockSample{ROCKSAMPLE_HEAD[0] + (ROCKSAMPLE_HEAD[1],)}",
             rrun, renv, rstate),
            ("rocksample_widest", f"RockSample{(wrows, wcols, wk)}", wrun, wenv,
             wstate)):
        carry = {"s": state}

        def call(i):
            a, b, _ = run(1000 + i, *carry["s"])
            carry["s"] = (a, b)

        call(-1)  # warm-up
        kern_ms[key] = 1e3 * time_windows(call, windows=5, calls=4)
        if key == "fused_msrooms":
            check_msrooms_cells(env, carry["s"][0])
        else:
            check_rocksample(env, *carry["s"])
        say("path4-headline", f"fused rollout {name} B={B_HEAD} K={K_HEAD} on "
            f"{card}: kernel {steps / kern_ms[key] * 1e3:.6e} env-steps/s "
            f"({kern_ms[key]:.4f} ms/call, median of 5 windows x 4 calls)")


def msrooms_path(dev, kern_ms, errs) -> None:
    """Path 4's trainer part (counted): the MSRooms Q trainer at full width
    (timed), then learning at the JAX hardware test's schedule through the
    kernel (the first chunk held against its twin) and through
    ``fused_q_learning``; the greedy policy through ``vector.rollout``."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import fused_q_learning
    from gym_po_tpu_torch.ops import make_fused_q_trainer_msrooms

    env = gp.make("MultistoryFourRooms-v0", grid_z=MSROOMS_Z, device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(5), B_TRAIN)
    run = make_fused_q_trainer_msrooms(env, B_TRAIN, K_TRAIN,
                                       average_duplicates=True)
    carry = {"a": msrooms_cells(env, st.agent_zyx),
             "q": torch.zeros((32, 128), device=dev)}

    def call(i):
        carry["a"], carry["q"], _ = run(1000 + i, LR_TRAIN, EPS_TRAIN,
                                        carry["a"], carry["q"])

    call(-1)  # warm-up
    kern_ms["fused_q_msrooms"] = event_windows(call, windows=5, calls=4)
    check_msrooms_cells(env, carry["a"])
    if not torch.isfinite(carry["q"]).all():
        raise AssertionError("fused_q_msrooms: non-finite Q")
    say("msrooms-trainer-time", f"fused_q_msrooms grid_z={MSROOMS_Z} "
        f"B={B_TRAIN} K={K_TRAIN} ({LR_TRAIN}, {EPS_TRAIN}) averaged: "
        f"{kern_ms['fused_q_msrooms']:.4f} ms/call, "
        f"{B_TRAIN * K_TRAIN / kern_ms['fused_q_msrooms'] * 1e3:.6e} "
        f"train-steps/s (CUDA events, median of 5 windows x 4 chained calls)")

    t0 = time.perf_counter()
    run = make_fused_q_trainer_msrooms(env, B_LEARN, K_LEARN,
                                       average_duplicates=True)
    (q,) = rooms_learn(dev, env, run, "q", SCHED_MSROOMS_Q, B_LEARN, errs,
                       f"fused Q on MultistoryFourRooms-v0 grid_z={MSROOMS_Z}",
                       cells=lambda st: msrooms_cells(env, st.agent_zyx),
                       stretch=make_fused_q_trainer_msrooms(
                           env, B_LEARN, K_STRETCH, average_duplicates=True))
    q2, hist = fused_q_learning(
        env, 0, [(lr, eps, K_LEARN) for lr, eps in SCHED_MSROOMS_Q],
        num_envs=B_LEARN, chunk_steps=K_LEARN, average_duplicates=True)
    if not np.array_equal(q, q2):
        raise AssertionError("fused_q_learning differs from the kernel loop")
    goals = rooms_greedy_goals(dev, env, q, MSROOMS_EVAL_STEPS)
    say("msrooms-learning", f"fused Q on MultistoryFourRooms-v0 grid_z="
        f"{MSROOMS_Z}, B={B_LEARN}, 4 chunks of K={K_LEARN} {SCHED_MSROOMS_Q} "
        f"(lr, eps): reward/step per chunk {', '.join(f'{h:.6f}' for h in hist)}; "
        f"the fused_q_learning entry point gives the same table; greedy rollout "
        f"1024 envs x {MSROOMS_EVAL_STEPS} steps: goals/env {goals:.4f} (> 1.0); "
        f"took {time.perf_counter() - t0:.2f} s")
    if goals <= 1.0:
        raise AssertionError("fused Q did not learn MultistoryFourRooms-v0")


# ---------------------------------------------- continuous envs (path 5)
# Path 5: the CRooms rollout on the CRooms-v0 defaults (layout '4': 17x17
# cells of size 1, 200 walkable; continuous 'yx' actions, s.d. 0.2, power
# 1.0; no velocity; goal fixed at the layout's end; time limit 500), the
# point-mass TagContinuous-v0 and HeavenHellContinuous-v0 rollouts (time
# limit 500) at the headline's size, and the CRooms Q trainer with ordinal
# actions at the trainers' width.  Fused vs step_vec at the JAX hardware
# tests' shapes and tolerances (tests/test_fused_crooms.py:56-68,
# tests/test_fused_tag.py:81-115); learning at the JAX hardware test's
# schedule and threshold (tests/test_fused_q_crooms.py:73-89).
CROOMS_SCAN_KW = dict(goal_xy=None, use_velocity=True, step_reward=-0.01,
                      wall_reward=-0.1)
B_CROOMS_SCAN, K_CROOMS_SCAN, CROOMS_SCAN_ATOL = 4096, 128, 0.003
B_TAG_SCAN, TAG_SCAN_ATOL = 8192, 5e-4
SCHED_CROOMS_Q = SCHED_ROOMS_Q  # one schedule in both JAX hardware tests
CROOMS_LEARN_MIN = 0.02  # last chunk's reward/step


def crooms_tiles(st, vel=None):
    """``(py, px, vy, vx, gy, gx)`` tiles of a CRooms state (``vel`` in
    place of its velocities)."""
    vel = st.vel_yx if vel is None else vel
    cols = (st.agent_yx[:, 0], st.agent_yx[:, 1], vel[:, 0], vel[:, 1],
            st.goal_yx[:, 0], st.goal_yx[:, 1])
    return tuple(c.reshape(-1, 128).contiguous() for c in cols)


def tag_tiles(st):
    return tuple(c.reshape(-1, 128).contiguous() for c in (
        st.agent_xy[:, 0], st.agent_xy[:, 1], st.target_xy[:, 0],
        st.target_xy[:, 1]))


def hh_tiles(st):
    return (st.agent_xy[:, 0].reshape(-1, 128).contiguous(),
            st.agent_xy[:, 1].reshape(-1, 128).contiguous(),
            st.heaven_right.to(torch.int32).reshape(-1, 128))


def random_vel(env, gen, B):
    """Velocities uniform in [-1, 1) when the env integrates them, else
    None (the reset's zeros)."""
    if not env.use_velocity:
        return None
    return torch.rand((B, 2), generator=gen, device=env.device) * 2 - 1


def check_crooms(env, py, px, vy=None, vx=None) -> None:
    """Every agent in [0, pos_hi] on a walkable cell, speeds within 5.  At
    a cell size other than 1 only finiteness is held: the reference's
    spawns place agents at cell centers of size 1 (a quirk the port keeps),
    which may lie past the grid until the first move clips them."""
    if vy is not None and not ((vy.abs() <= 5) & (vx.abs() <= 5)).all():
        raise AssertionError("CRooms velocity past its clip")
    if env.cell_size != 1.0:
        if not (torch.isfinite(py).all() and torch.isfinite(px).all()):
            raise AssertionError("CRooms position not finite")
        return
    hi = env._pos_hi.astype(np.float32)
    if not (((py >= 0) & (py <= float(hi[0])) & (px >= 0)
             & (px <= float(hi[1]))).all()):
        raise AssertionError("CRooms position out of range")
    cy = torch.floor(py / env.cell_size).long().reshape(-1)
    cx = torch.floor(px / env.cell_size).long().reshape(-1)
    grid = torch.as_tensor(env.grid_np, device=py.device)
    if not (grid[cy, cx] >= 0).all():
        raise AssertionError("CRooms agent rests inside a wall")


def check_tag(a0, a1, t0, t1) -> None:
    from gym_po_tpu_torch.envs.tag import CAGE

    if not all((x.abs() <= CAGE).all() for x in (a0, a1, t0, t1)):
        raise AssertionError("Tag agent or target outside the cage")


def check_hh(x, y, h) -> None:
    from gym_po_tpu_torch.envs.tag import BAR, STEM

    stem = (x >= STEM[0]) & (x <= STEM[1]) & (y >= STEM[2]) & (y <= STEM[3])
    bar = (x >= BAR[0]) & (x <= BAR[1]) & (y >= BAR[2]) & (y <= BAR[3])
    if not (stem | bar).all():
        raise AssertionError("HeavenHell agent outside the T-maze")
    if not ((h == 0) | (h == 1)).all():
        raise AssertionError("HeavenHell heaven flag not 0/1")


# env kwargs (time limit 40), rows_per_tile (B = 65,536: 4 or 512 tiles),
# episode stats: fixed and random goal, with and without velocity
CROOMS_ROLLOUT_CASES = [
    ({}, 128, False),
    (dict(use_velocity=True), 1, True),
    (dict(goal_xy=None), 128, True),
    (dict(goal_xy=None, use_velocity=True, layout="16", cell_size=0.5,
          agent_xy=(1, 1), step_reward=-0.01, wall_reward=-0.1), 128, False),
    # the redesign's edges: every env resetting as often as it can (CRooms
    # truncates at >, so every second step), a cell size of 0.5 on layout
    # '4' (the multiply by 1/cs), one that is not a power of two (0.75: the
    # division)
    (dict(time_limit=1, goal_xy=None), 128, True),
    (dict(cell_size=0.5, goal_xy=None, wall_reward=-1.0), 128, True),
    (dict(cell_size=0.75, use_velocity=True), 128, False),
]
# time limit (1: every env resets every step, the respawn's edge),
# rows_per_tile, episode stats (HeavenHell, beside each: the other way
# round, and on at time limit 1)
TAG_ROLLOUT_CASES = [(40, 128, False), (40, 1, True), (1, 128, True)]
# env kwargs (time limit 60), averaged duplicates, lr: summed duplicates take
# a small lr (hundreds of terms per entry per step at B = 65,536)
CROOMS_TRAINER_CASES = [
    (dict(action_type="ordinal"), True, 0.1),
    (dict(action_type="ordinal", use_velocity=True), False, 0.0002),
    (dict(action_type="ordinal", use_velocity=True, agent_xy=(1, 1)), True, 0.1),
    (dict(action_type="cardinal", obs_type="hansen", step_reward=-0.01),
     False, 0.0002),
]


def libm_check(dev) -> None:
    """The Box-Muller normal over every uniform a draw can give
    (u = k 2^-24, k < 2^24, the second uniform a permutation of the first):
    the kernels' logf, cosf and gpt::rnormal (``rnormal_parts_launch`` in
    ``csrc/fused_crooms.cu``) against the twin's ``torch.log``/``torch.cos``
    on the card and its ``rnormal`` formula.  Prints the counts of values
    that differ; the kernel == twin checks are the gate."""
    import ctypes
    import math

    from gym_po_tpu_torch.ops import kernel_rng
    from gym_po_tpu_torch.ops._build import load_library
    from gym_po_tpu_torch.utils.numerics import sqrt_rn

    fn = load_library("fused_crooms").rnormal_parts_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 1 << 24
    k = torch.arange(n, dtype=torch.int64, device=dev)
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(8),
                          device=dev)
    words = k << 8
    w1 = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    w2 = w1[perm].contiguous()
    lg, cs, nrm = (torch.empty(n, device=dev) for _ in range(3))
    err = fn(w1.data_ptr(), w2.data_ptr(), lg.data_ptr(), cs.data_ptr(),
             nrm.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rnormal_parts_launch failed: CUDA error {err}")
    u1 = k.to(torch.float32) * (2.0**-24)
    u2 = u1[perm]
    t_lg = kernel_rng._log(torch.clamp(u1, min=1e-12))
    t_cs = kernel_rng._cos(torch.tensor(2.0 * math.pi, dtype=torch.float32) * u2)
    t_nrm = sqrt_rn(-2.0 * t_lg) * t_cs
    torch.cuda.synchronize()
    counts = [int((a != b).sum()) for a, b in ((lg, t_lg), (cs, t_cs),
                                               (nrm, t_nrm))]
    say("libm", f"over all 2^24 uniforms: logf != torch.log at {counts[0]}, "
        f"cosf(2 pi u) != torch.cos at {counts[1]}, rnormal != twin at "
        f"{counts[2]} (max abs {(nrm - t_nrm).abs().max().item():.3e})")


def divisors_check(dev) -> None:
    """``gpt::udiv`` and ``gpt::umod`` (``csrc/kernel_rng.cuh``, the
    constants of ``UDiv.of``) against the hardware's ``u / n`` and ``u % n``
    over all 2^32 u, on the card, for n = 1 ... 64, each divisor that
    paths 1, 3 and 4 hand the Taxi, ROOMS, RockSample and
    MultistoryFourRooms rollouts, and the ROOMS rollout's on every layout
    (``udiv_check_launch`` in ``csrc/fused_taxi.cu``).  Any mismatch
    fails."""
    import ctypes

    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.maps import LAYOUT_NAMES
    from gym_po_tpu_torch.ops import (
        make_fused_msrooms_rollout,
        make_fused_rocksample_rollout,
        make_fused_rooms_rollout,
        make_fused_taxi_rollout,
    )
    from gym_po_tpu_torch.ops._build import load_library
    from gym_po_tpu_torch.ops.kernel_rng import UDiv

    used = {f"HansenTaxi-v4 {k}": n for k, n in make_fused_taxi_rollout(
        gp.make("HansenTaxi-v4", device=dev), B_HEAD, K_HEAD).divisors.items()}
    for (rows, cols), k in (ROCKSAMPLE_HEAD, ROCKSAMPLE_WIDEST):
        env = gp.make("RockSample-v0", map_size=(rows, cols), num_rocks=k,
                      device=dev)
        for name, n in make_fused_rocksample_rollout(env, B_HEAD, K_HEAD).divisors.items():
            used[f"RockSample{(rows, cols, k)} {name}"] = n
    for layout in LAYOUT_NAMES:
        renv = gp.make("Rooms-v0", layout=layout, device=dev)
        for name, n in make_fused_rooms_rollout(renv, B_HEAD, K_HEAD).divisors.items():
            used[f"Rooms-v0 layout {layout} {name}"] = n
    menv = gp.make("MultistoryFourRooms-v0", grid_z=MSROOMS_Z, device=dev)
    for name, n in make_fused_msrooms_rollout(menv, B_HEAD, K_HEAD).divisors.items():
        used[f"MSRooms grid_z={MSROOMS_Z} {name}"] = n
    ns = sorted(set(range(1, 65)) | set(used.values()))
    host = (UDiv * len(ns))(*map(UDiv.of, ns))
    divs = torch.frombuffer(bytearray(host), dtype=torch.uint8).to(dev)
    bad = torch.zeros(len(ns), dtype=torch.int64, device=dev)
    fn = load_library("fused_taxi").udiv_check_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    t0 = time.perf_counter()
    err = fn(divs.data_ptr(), len(ns), bad.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"udiv_check_launch failed: CUDA error {err}")
    counts = bad.tolist()
    say("divisors", f"gpt::udiv/umod against u / n and u % n over all 2^32 u "
        f"for {len(ns)} divisors (1-64 and {', '.join(f'{k} {n}' for k, n in used.items())}) "
        f"in {time.perf_counter() - t0:.2f} s: {sum(counts)} mismatches")
    if any(counts):
        raise AssertionError("invariant division differs at n = "
                             f"{[n for n, c in zip(ns, counts) if c]}")


def sass_check() -> None:
    """The kernels as built: each one's registers and spills (ptxas), and
    its MUFU.RCP and I2F.U32.RP, the runtime integer division's float
    reciprocal and conversion, in all and inside loops (``cuobjdump
    -sass``).  A kernel in which no loop is found fails.  Inside a loop, an
    I2F.U32.RP fails the Taxi, RockSample, Tag, CRooms, ROOMS and MSRooms
    rollouts and the CRooms Q trainer, and a MUFU.RCP the Taxi and
    RockSample rollouts (Tag's flee rule, CRooms' division by a cell size
    that is not a power of two and the trainers' averaging divide floats
    legitimately: their count is reported).  The other trainers' counts are
    reported only: the runtime divisions left to take out."""
    from gym_po_tpu_torch.ops._build import _library_path, build_log
    from gym_po_tpu_torch.ops.probe_fused_taxi import (
        DIVISION_OPS,
        division_counts,
        ptxas_report,
    )

    checked = ("fused_tag", "fused_crooms", "fused_rooms", "fused_msrooms",
               "fused_q_crooms")
    for name in ("fused_taxi", "fused_rocksample", *checked, "fused_qlearning",
                 "fused_ac"):
        regs = ptxas_report(build_log(name))
        fatal = (DIVISION_OPS if name in ("fused_taxi", "fused_rocksample")
                 else ("I2F.U32.RP",) if name in checked else ())
        for fn, c in division_counts(_library_path(name)).items():
            if "_kernel" not in fn or "udiv_check" in fn or "rnormal_parts" in fn:
                continue
            say("sass", f"{fn}: " + ", ".join(
                f"{op} {c[op][0]} ({c[op][1]} inside loops)" for op in DIVISION_OPS)
                + f"; {c['loops']} instructions inside loops; "
                + regs.get(fn, "registers not reported"))
            if not c["loops"] or any(c[op][1] for op in fatal):
                raise AssertionError(f"{fn}: a runtime division inside its "
                                     "loop, or no loop found")


def path5_checks(dev, errs, B=B_ROOMS_CHECK, K=K_ROOMS_TAPE) -> None:
    """The four path-5 kernels == their twins, exactly, on a random tape and
    in Philox mode (B = 65,536, K = 64; the trainer from a random Q)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import (
        make_fused_crooms_rollout,
        make_fused_heavenhell_rollout,
        make_fused_q_trainer_crooms,
        make_fused_tag_rollout,
    )

    gen = torch.Generator(device=dev).manual_seed(71)

    def tape_for(run, mode):
        if mode != "tape":
            return ()
        return (torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                              dtype=torch.int32, device=dev),)

    for mode in ("tape", "philox"):
        for kw, rpt, stats in CROOMS_ROLLOUT_CASES:
            env = gp.make("CRooms-v0", device=dev, **{"time_limit": 40, **kw})
            run = make_fused_crooms_rollout(env, B, K, rows_per_tile=rpt,
                                            episode_stats=stats,
                                            rng_tape=mode == "tape")
            _, st = env.reset_vec(gen, B)
            s6 = crooms_tiles(st, random_vel(env, gen, B))
            tape = tape_for(run, mode)
            got, want = run(3, *s6, *tape), run.twin(3, *s6, *tape)
            torch.cuda.synchronize()
            name = f"CRooms-v0 {kw} rows_per_tile={rpt}" + (
                " episode_stats" if stats else "") + f" {mode}"
            compare(name, got, want, errs["fused_crooms"])
            check_crooms(env, *got[:4])
            if stats and got[9].sum().item() == 0:
                raise AssertionError(f"{name}: no episode completed")
            hit = (f", zero-speed share {(got[2] == 0).double().mean().item():.4f}"
                   if env.use_velocity else "")
            say("crooms-check", f"kernel == twin exactly: {name}, B={B} K={K}, "
                f"mean reward/step {got[6].mean().item() / K:.6f}{hit}")
        for limit, rpt, stats in TAG_ROLLOUT_CASES:
            env = gp.make("TagContinuous-v0", time_limit=limit, device=dev)
            run = make_fused_tag_rollout(env, B, K, rows_per_tile=rpt,
                                         episode_stats=stats,
                                         rng_tape=mode == "tape")
            s4 = tag_tiles(env.reset_vec(gen, B)[1])
            tape = tape_for(run, mode)
            got, want = run(3, *s4, *tape), run.twin(3, *s4, *tape)
            torch.cuda.synchronize()
            name = f"TagContinuous-v0 time_limit={limit} rows_per_tile={rpt}" + (
                " episode_stats" if stats else "") + f" {mode}"
            compare(name, got, want, errs["fused_tag"])
            check_tag(*got[:4])
            if limit == 1 and not (got[7] == K).all():
                raise AssertionError(f"{name}: not every env reset every step")
            say("tag-check", f"kernel == twin exactly: {name}, B={B} K={K}, "
                f"mean reward/step {got[4].mean().item() / K:.6f}")

            hh_stats = not stats or limit == 1
            env = gp.make("HeavenHellContinuous-v0", time_limit=limit, device=dev)
            run = make_fused_heavenhell_rollout(env, B, K, rows_per_tile=rpt,
                                                episode_stats=hh_stats,
                                                rng_tape=mode == "tape")
            s3 = hh_tiles(env.reset_vec(gen, B)[1])
            tape = tape_for(run, mode)
            got, want = run(3, *s3, *tape), run.twin(3, *s3, *tape)
            torch.cuda.synchronize()
            name = (f"HeavenHellContinuous-v0 time_limit={limit} "
                    f"rows_per_tile={rpt}" + (" episode_stats" if hh_stats
                                              else "") + f" {mode}")
            compare(name, got, want, errs["fused_heavenhell"])
            check_hh(*got[:3])
            if got[2].dtype != torch.int32:
                raise AssertionError(f"{name}: heaven tile is {got[2].dtype}")
            if limit == 1 and not (got[6] == K).all():
                raise AssertionError(f"{name}: not every env reset every step")
            say("heavenhell-check", f"kernel == twin exactly: {name}, B={B} "
                f"K={K}, mean reward/step {got[3].mean().item() / K:.6f}, "
                f"heaven share {got[2].double().mean().item():.4f}")
        for kw, avg, lr in CROOMS_TRAINER_CASES:
            env = gp.make("CRooms-v0", time_limit=60, device=dev, **kw)
            run = make_fused_q_trainer_crooms(env, B, K, average_duplicates=avg,
                                              rng_tape=mode == "tape")
            _, st = env.reset_vec(gen, B)
            s4 = crooms_tiles(st, random_vel(env, gen, B))[:4]
            q0 = 0.1 * torch.randn((32, 128), generator=gen, device=dev)
            tape = tape_for(run, mode)
            got = run(3, lr, 0.3, *s4, q0, *tape)
            want = run.twin(3, lr, 0.3, *s4, q0, *tape)
            torch.cuda.synchronize()
            name = (f"fused_q_crooms {kw} {'averaged' if avg else 'summed'} "
                    f"{mode}")
            compare(name, got, want, errs["fused_q_crooms"])
            check_crooms(env, *got[:4])
            moved = int((got[4] != q0).sum())
            if not 0 < moved < q0.numel():
                raise AssertionError(f"{name}: Q moved nowhere or everywhere")
            say("crooms-trainer-check", f"kernel == twin exactly: {name}, "
                f"B={B} K={K} lr={lr} eps=0.3: entries moved {moved}, mean "
                f"reward/step {got[5].mean().item() / K:.6f}")


def path5_distribution_checks(dev) -> None:
    """Philox-mode rollouts against the step_vec path, at the JAX hardware
    tests' shapes and tolerances: mean reward/step."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import (
        make_fused_crooms_rollout,
        make_fused_heavenhell_rollout,
        make_fused_tag_rollout,
    )
    from gym_po_tpu_torch.vector import rollout

    cases = (
        ("CRooms-v0", CROOMS_SCAN_KW, make_fused_crooms_rollout, crooms_tiles,
         B_CROOMS_SCAN, K_CROOMS_SCAN, CROOMS_SCAN_ATOL),
        ("TagContinuous-v0", {}, make_fused_tag_rollout, tag_tiles,
         B_TAG_SCAN, K_HEAD, TAG_SCAN_ATOL),
        ("HeavenHellContinuous-v0", {}, make_fused_heavenhell_rollout, hh_tiles,
         B_TAG_SCAN, K_HEAD, TAG_SCAN_ATOL))
    for env_id, kw, make, tiles, B, K, atol in cases:
        env = gp.make(env_id, device=dev, **kw)
        run = make(env, B, K, episode_stats=True)
        _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B)
        out = run(5, *tiles(st))
        n = len(tiles(st))
        fused_mean = out[n].double().mean().item() / K
        traj, _ = rollout(env, torch.Generator(device=dev).manual_seed(1), None,
                          B, K)
        scan_mean = traj.reward.double().mean().item()
        say("path5-distribution", f"{env_id} {kw or ''} B={B} K={K}: mean "
            f"reward/step fused {fused_mean:.6f} vs step_vec {scan_mean:.6f} "
            f"(limit {atol}); fused episodes/env "
            f"{out[n + 3].double().mean().item():.4f}")
        if abs(fused_mean - scan_mean) >= atol:
            raise AssertionError(f"{env_id} kernel's distribution differs "
                                 "from step_vec")


def path5_trainer_philox(dev, errs, plain_ms) -> None:
    """The CRooms Q trainer kernel == its twin at full width in Philox mode
    from a zero Q (``CRooms-v0`` with ordinal actions), the twin's ms/call
    timed the way the kernel is, from the same calls."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_q_trainer_crooms

    env = gp.make("CRooms-v0", action_type="ordinal", device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(4), B_TRAIN)
    s4 = crooms_tiles(st)[:4]
    run = make_fused_q_trainer_crooms(env, B_TRAIN, K_TRAIN,
                                      average_duplicates=True)
    q0 = torch.zeros((32, 128), device=dev)
    outs = []
    plain_ms["fused_q_crooms"] = event_windows(
        lambda i: outs.append(run.twin(100 + i, LR_TRAIN, EPS_TRAIN, *s4, q0)),
        windows=1, calls=1)
    got = run(100, LR_TRAIN, EPS_TRAIN, *s4, q0)
    torch.cuda.synchronize()
    compare("fused_q_crooms Philox", got, outs[0], errs)
    check_crooms(env, *got[:4])
    say("crooms-trainer-philox", f"kernel == twin exactly: fused_q_crooms "
        f"CRooms-v0 ordinal B={B_TRAIN} K={K_TRAIN} lr={LR_TRAIN} "
        f"eps={EPS_TRAIN} averaged, from Q = 0, grid {run.grid} (blocks, "
        f"envs/thread); twin {plain_ms['fused_q_crooms']:.3f} ms/call")


def crooms_trainer_redesign_checks(dev, errs) -> None:
    """The CRooms Q trainer [14] on the one-barrier step protocol with lazy
    draws == its twin where that design could go wrong: at B = 65,536 (the
    slab on chip) every env from one position next to the goal (every term
    of a step on the same few entries), Philox, K = 16; K = 0, 1, 2, 4 on a
    tape from a random table a third of whose entries are -0 (the rotating
    accumulators before and after their first reuse; the load's + 0); time
    limit 1 on a tape (every env resets every second step: the respawn's
    block and spawn); at B = 2^20, K = 4, Philox, both sides of the slab's
    choice (CRooms-v0 keeps it on chip, layout '16''s 422 observations send
    the terms straight to the global accumulator)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import make_fused_q_trainer_crooms

    gen = torch.Generator(device=dev).manual_seed(73)

    def case(B, K, tape=False, **kw):
        env = gp.make("CRooms-v0", device=dev, **{
            "action_type": "ordinal", "time_limit": 30, **kw})
        run = make_fused_q_trainer_crooms(env, B, K, average_duplicates=True,
                                          rng_tape=tape)
        _, st = env.reset_vec(gen, B)
        s4 = list(crooms_tiles(st)[:4])
        taped = (torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                               dtype=torch.int32, device=dev),) if tape else ()
        return env, run, s4, taped

    def held(name, run, s4, q, taped, K):
        got = run(5, 0.1, 0.3, *s4, q, *taped)
        want = (run.twin(5, 0.1, 0.3, *s4, q, *taped) if K
                else (*s4, q, torch.zeros_like(s4[0])))
        torch.cuda.synchronize()
        compare(f"fused_q_crooms {name}", got, want, errs)
        return got

    env, run, s4, _ = case(B_ROOMS_CHECK, 16)
    gy, gx = (float(v) for v in env.fixed_goal_coord)
    start = next((gy + dy, gx + dx) for dy, dx in ((-1, 0), (0, -1), (1, 0), (0, 1))
                 if env.grid_np[int(gy + dy), int(gx + dx)] != -1)
    s4[0], s4[1] = torch.full_like(s4[0], start[0]), torch.full_like(s4[1], start[1])
    q0 = torch.zeros((32, 128), device=dev)
    got = held("one start", run, s4, q0, (), 16)
    if run.grid[1:] != (1, 1) or not (got[4] != q0).any():
        raise AssertionError(f"fused_q_crooms one start: grid {run.grid}, "
                             "or no Q entry moved")
    grid_one = run.grid
    q = 0.1 * torch.randn((32, 128), generator=gen, device=dev)
    q[torch.rand(q.shape, generator=gen, device=dev) < 0.33] = -0.0
    for K in REDESIGN_KS:
        _, run, s4, taped = case(B_ROOMS_CHECK, K, tape=True)
        got = held(f"tape K={K} with -0 entries", run, s4, q, taped, K)
        if K and torch.signbit(got[4][got[4] == 0]).any():
            raise AssertionError("fused_q_crooms: a -0 entry came out")
    _, run, s4, taped = case(B_ROOMS_CHECK, 16, tape=True, time_limit=1)
    held("time_limit=1 tape", run, s4, q, taped, 16)
    sides = []
    for side, kw in ((1, {}), (0, {"layout": "16"})):
        _, run, s4, _ = case(B_HEAD, 4, **kw)
        held(f"{kw} B={B_HEAD} K=4", run, s4,
             0.1 * torch.randn((32, 128), generator=gen, device=dev), (), 4)
        if run.grid[2] != side:
            raise AssertionError(f"fused_q_crooms {kw} B={B_HEAD}: grid "
                                 f"{run.grid}, expected side {side}")
        sides.append(f"{kw or 'CRooms-v0'} grid {run.grid}")
    say("crooms-trainer-redesign", f"kernel == twin exactly: fused_q_crooms "
        f"B={B_ROOMS_CHECK}: every env from {start}, K=16, Philox, grid "
        f"{grid_one} (blocks, envs/thread, slab on chip); tape K = "
        f"{', '.join(map(str, REDESIGN_KS))} from a random table with -0 "
        f"entries (all come out +0); time_limit=1; B={B_HEAD} K=4 Philox: "
        f"{'; '.join(sides)}")


def path5_headline_checks(dev, errs, plain_ms):
    """The three rollout kernels against their twins at the headline's
    shape (B = 2^20, K = 256, the registry defaults; the twins' first timed
    call), exact, not counted.  Returns ``{key: (run, env, state)}``."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import (
        make_fused_crooms_rollout,
        make_fused_heavenhell_rollout,
        make_fused_tag_rollout,
    )

    heads = {}
    for key, env_id, make, tiles in (
            ("fused_crooms", "CRooms-v0", make_fused_crooms_rollout,
             crooms_tiles),
            ("fused_tag", "TagContinuous-v0", make_fused_tag_rollout, tag_tiles),
            ("fused_heavenhell", "HeavenHellContinuous-v0",
             make_fused_heavenhell_rollout, hh_tiles)):
        env = gp.make(env_id, device=dev)
        run = make(env, B_HEAD, K_HEAD)
        state = tiles(env.reset_vec(torch.Generator(device=dev).manual_seed(0),
                                    B_HEAD)[1])
        twin_out = []
        plain_ms[key] = 1e3 * time_windows(
            lambda i: twin_out.append(run.twin(100 + i, *state)), windows=1,
            calls=1)
        compare(f"{key} headline shape B={B_HEAD} K={K_HEAD}", run(100, *state),
                twin_out[0], errs[key])
        del twin_out
        heads[key] = (run, env, state)
        say("path5-headline-check", f"kernel == twin exactly: {key} {env_id} "
            f"B={B_HEAD} K={K_HEAD}, Philox mode; twin {plain_ms[key]:.3f} "
            "ms/call")
    return heads


def path5_rollout_times(dev, card, heads, kern_ms) -> dict:
    """The counted rollout timings at B = 2^20, K = 256.  Returns what the
    warm-up call's data needed of the three rollouts: ``{key: {"steps",
    "resets", "hits"}}``.  Tag's and CRooms' rewards are 1 at a reset and 0
    otherwise (the registry's defaults, no truncation at K < 500), so the
    warm-up's reward sums count its resets; an uncounted call of CRooms
    with a reward of 1 on a wall hit (and 0 at the goal), on the same
    inputs and seed, counts its hits (rewards do not feed back into the
    state; a hit on a step that reaches the goal is not counted).
    HeavenHell's +1 and -1 cancel in the sums: an uncounted call with
    episode stats, on the same inputs and seed, counts its resets
    (``ep_cnt``)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import (
        make_fused_crooms_rollout,
        make_fused_heavenhell_rollout,
    )

    checks = {"fused_crooms": lambda env, s: check_crooms(env, *s[:4]),
              "fused_tag": lambda env, s: check_tag(*s),
              "fused_heavenhell": lambda env, s: check_hh(*s)}
    steps = B_HEAD * K_HEAD
    needs = {}
    for key, (run, env, state) in heads.items():
        carry = {"s": state}

        def call(i):
            out = run(1000 + i, *carry["s"])
            carry["s"] = out[:len(state)]
            return out

        warm = call(-1)
        kern_ms[key] = 1e3 * time_windows(call, windows=5, calls=4)
        checks[key](env, carry["s"])
        if key != "fused_heavenhell":
            needs[key] = {"steps": steps, "resets": warm[len(state)].sum().item()}
        else:
            with uncounted():
                ep_cnt = make_fused_heavenhell_rollout(
                    env, B_HEAD, K_HEAD, episode_stats=True)(999, *state)[6]
            needs[key] = {"steps": steps, "resets": ep_cnt.sum().item()}
        if key == "fused_crooms":
            hit_env = gp.make("CRooms-v0", device=dev, wall_reward=1.0,
                              goal_reward=0.0)
            with uncounted():
                hits = make_fused_crooms_rollout(hit_env, B_HEAD, K_HEAD)(
                    999, *state)[len(state)]
            needs[key]["hits"] = hits.sum().item()
        share = "".join(f", {k} per env-step {v / steps:.6e}"
                        for k, v in needs.get(key, {}).items() if k != "steps")
        say("path5-headline", f"fused rollout {key} {type(env).__name__} "
            f"B={B_HEAD} K={K_HEAD} "
            f"on {card}: kernel {steps / kern_ms[key] * 1e3:.6e} env-steps/s "
            f"({kern_ms[key]:.4f} ms/call, median of 5 windows x 4 calls)"
            + (f"; the warm-up call's{share[1:]}" if share else ""))
    return needs


def crooms_trainer_path(dev, kern_ms, errs) -> None:
    """Path 5's trainer part (counted): the CRooms Q trainer at full width
    (timed), then learning at the JAX hardware test's schedule through the
    kernel (the first chunk held against its twin) and through
    ``fused_q_learning``; the last chunk's reward/step > 0.02."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import fused_q_learning
    from gym_po_tpu_torch.ops import banks_to_q, make_fused_q_trainer_crooms

    env = gp.make("CRooms-v0", action_type="ordinal", device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(5), B_TRAIN)
    run = make_fused_q_trainer_crooms(env, B_TRAIN, K_TRAIN,
                                      average_duplicates=True)
    carry = {"s": crooms_tiles(st)[:4], "q": torch.zeros((32, 128), device=dev)}

    def call(i):
        *s, carry["q"], _ = run(1000 + i, LR_TRAIN, EPS_TRAIN, *carry["s"],
                                carry["q"])
        carry["s"] = s

    call(-1)  # warm-up
    kern_ms["fused_q_crooms"] = event_windows(call, windows=5, calls=4)
    check_crooms(env, *carry["s"])
    if not torch.isfinite(carry["q"]).all():
        raise AssertionError("fused_q_crooms: non-finite Q")
    say("crooms-trainer-time", f"fused_q_crooms CRooms-v0 ordinal B={B_TRAIN} "
        f"K={K_TRAIN} ({LR_TRAIN}, {EPS_TRAIN}) averaged: "
        f"{kern_ms['fused_q_crooms']:.4f} ms/call, "
        f"{B_TRAIN * K_TRAIN / kern_ms['fused_q_crooms'] * 1e3:.6e} "
        f"train-steps/s (CUDA events, median of 5 windows x 4 chained calls)")

    # the JAX hardware test's loop: reset positions, zero velocities, zero Q
    t0 = time.perf_counter()
    run = make_fused_q_trainer_crooms(env, B_LEARN, K_LEARN,
                                      average_duplicates=True)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B_LEARN)
    s = list(crooms_tiles(st)[:4])
    s[2], s[3] = torch.zeros_like(s[2]), torch.zeros_like(s[3])
    qb = torch.zeros((32, 128), device=dev)
    rates = []
    for i, (lr, eps) in enumerate(SCHED_CROOMS_Q):
        if i == 0:
            stretch_check("fused Q on CRooms-v0 ordinal", make_fused_q_trainer_crooms(
                env, B_LEARN, K_STRETCH, average_duplicates=True),
                (1, lr, eps, *s, qb), errs)
        *s, qb, rew = run(i + 1, lr, eps, *s, qb)
        rates.append(rew.double().mean().item() / K_LEARN)
    check_crooms(env, *s)
    n_obs, A = int(env.observation_space.n), env.num_actions
    q = banks_to_q(qb.cpu().numpy(), 512, na=A)[:n_obs]
    q2, hist = fused_q_learning(
        env, 0, [(lr, eps, K_LEARN) for lr, eps in SCHED_CROOMS_Q],
        num_envs=B_LEARN, chunk_steps=K_LEARN, average_duplicates=True)
    if not np.array_equal(q, q2):
        raise AssertionError("fused_q_learning differs from the kernel loop")
    say("crooms-learning", f"fused Q on CRooms-v0 ordinal, B={B_LEARN}, 4 "
        f"chunks of K={K_LEARN} {SCHED_CROOMS_Q} (lr, eps): reward/step per "
        f"chunk {', '.join(f'{r:.6f}' for r in rates)} (last > "
        f"{CROOMS_LEARN_MIN}); fused_q_learning: the same table, "
        f"{', '.join(f'{h:.6f}' for h in hist)}; took "
        f"{time.perf_counter() - t0:.2f} s")
    if rates[-1] <= CROOMS_LEARN_MIN or hist[-1] <= CROOMS_LEARN_MIN:
        raise AssertionError("fused Q did not learn CRooms-v0")


# --------------------------------------------------------- PPO (path 6)
# the env __graft_entry__.dryrun_multichip trains on; PPOConfig's defaults
# (B = 4,096, T = 128, E = M = 4, hidden (64, 64), 'permute', f32)
PPO_ENV = "ExtendedHansenTaxi-v4"
PPO_UPDATES = 4
B_PPO_WIDE = 65536  # the size README's step_vec rates are quoted at
# learning: the JAX package's smoke tests' configs (tests/test_agents.py,
# tests/test_memory_learning.py).  The CarFlag run goes on to 200 updates,
# where the mean reward of the last 100 beat the first 20's by 1.5e-3 or
# more in all eight CPU runs of seeds 0-7 (at 30 updates the test's own
# criterion failed in 4 of 16)
PPO_CARFLAG_UPDATES = 200
PPO_HH_UPDATES = 50
# the multi step (one UpdateGraph replayed PPO_MULTI_UPDATES times) against
# as many make_train_step calls; PPO_MULTI_WINDOWS rounds of the windows
# multi, single, single, multi
PPO_MULTI_UPDATES = 4
PPO_MULTI_WINDOWS = 2


def ppo_metrics_line(m: dict) -> str:
    vals = {k: float(v) for k, v in m.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"PPO: non-finite metrics {bad}")
    return ", ".join(f"{k} {v:.6f}" for k, v in vals.items())


def device_ops(fn, top: int = 0) -> tuple:
    """(kernels and other device operations, their summed device ms) of one
    call of ``fn``, from torch.profiler, and with ``top`` the ``top`` most
    costly by name as (name, count, ms); zeros if the trace holds no device
    events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = [getattr(e, "self_device_time_total", 0) for e in events]
    out = (sum(e.count for e in events), sum(us) / 1e3)
    if top:
        ranked = sorted(zip(us, events), key=lambda p: -p[0])[:top]
        out += ([(e.key[:60], e.count, u / 1e3) for u, e in ranked],)
    return out


def train_state_diffs(a, b) -> list:
    """The fields in which two PPO train states differ (parameters, Adam
    state, observations, env state, generator state, update count)."""
    pairs = {"params": (a.params, b.params),
             "count": (a.opt_state.count, b.opt_state.count),
             "mu": (a.opt_state.mu, b.opt_state.mu),
             "nu": (a.opt_state.nu, b.opt_state.nu),
             "env_obs": (a.env_obs, b.env_obs),
             "generator": (a.generator.get_state(), b.generator.get_state())}
    pairs.update({f"env_state.{f.name}": (getattr(a.env_state, f.name),
                                          getattr(b.env_state, f.name))
                  for f in dataclasses.fields(a.env_state)})
    diffs = [k for k, (x, y) in pairs.items()
             if x.dtype != y.dtype or not torch.equal(x, y)]
    return diffs + (["update_idx"] if a.update_idx != b.update_idx else [])


def ppo_multi_check(dev, card, env, cfg, label, phase="ppo-multi",
                    seed=5) -> dict:
    """``make_multi_train_step(N)`` against N calls of ``make_train_step``'s
    step from one state, bit for bit (parameters, Adam state, observations,
    env state, generator state, each metric row); the UpdateGraph's capture
    (its eager warm-up included) on the host clock; ms an update both ways
    in one process (host clock around a sync, windows multi, single,
    single, multi, PPO_MULTI_WINDOWS times); the device ops and busy time
    of one replayed update (torch.profiler); the kernel launches of one
    replay."""
    from gym_po_tpu_torch.agents import ppo

    n = PPO_MULTI_UPDATES
    (model_m, ts_m), (model_s, ts_s) = (
        ppo.init_train_state(env, cfg, torch.Generator(device=dev).manual_seed(seed))
        for _ in range(2))
    multi = ppo.make_multi_train_step(env, model_m, cfg, n)
    step = ppo.make_train_step(env, model_s, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi.graph = ppo.UpdateGraph(env, model_m, cfg, ts_m)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    ts_m, got = multi(ts_m)
    rows = []
    for _ in range(n):
        ts_s, m = step(ts_s)
        rows.append(m)
    torch.cuda.synchronize()
    diffs = train_state_diffs(ts_m, ts_s) + [
        f"{k}[{i}]" for i, m in enumerate(rows) for k in ppo.METRIC_NAMES
        if not torch.equal(got[k][i], m[k])]
    if diffs:
        raise AssertionError(f"{label}: the multi step differs from {n} single "
                             f"updates in {diffs}")
    state = {"m": ts_m, "s": ts_s}

    def run_multi():
        state["m"], _ = multi(state["m"])

    def run_single():
        for _ in range(n):
            state["s"], _ = step(state["s"])

    t_multi, t_single = [], []
    for _ in range(PPO_MULTI_WINDOWS):
        for fn, out in ((run_multi, t_multi), (run_single, t_single),
                        (run_single, t_single), (run_multi, t_multi)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3 / n)
    n_ops, busy = device_ops(multi.graph.replay)
    launches = collections.Counter()
    for (_, name), k in multi.graph.launches.items():
        launches[name] += k
    out = {"capture_s": capture_s, "multi_ms": statistics.median(t_multi),
           "single_ms": statistics.median(t_single), "ops": n_ops,
           "busy_ms": busy, "launches": dict(launches)}
    say(phase, f"{label} on {card}: make_multi_train_step({n}) == {n} "
        f"make_train_step calls bit for bit (parameters, Adam state, obs, env "
        f"state, generator, {len(ppo.METRIC_NAMES)} metrics a row); "
        f"UpdateGraph capture {capture_s:.3f} s; {out['multi_ms']:.3f} ms an "
        f"update as replays, {out['single_ms']:.3f} ms as single steps "
        f"(ratio {out['multi_ms'] / out['single_ms']:.4f}; windows "
        f"{', '.join(f'{x:.3f}' for x in t_multi)} / "
        f"{', '.join(f'{x:.3f}' for x in t_single)}), "
        f"{cfg.num_envs * cfg.rollout_steps / out['multi_ms'] * 1e3:.6e} PPO "
        f"env-steps/s replayed; "
        + (f"one replayed update {n_ops} device ops, busy {busy:.3f} ms = "
           f"{busy / out['multi_ms']:.4f} of its time" if n_ops else
           "device ops: not measured (no device events in the trace)")
        + "; kernel launches a replay: "
        + (", ".join(f"{k} {v}" for k, v in launches.items()) or "none"))
    return out


def collect_outputs(out) -> list:
    """Every tensor of a collect's outputs, in order (tuples, named tuples
    and env-state dataclasses)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        return [t for f in dataclasses.fields(out)
                for t in collect_outputs(getattr(out, f.name))]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in collect_outputs(x)]
    return []


def collect_checks(dev, label, generator, eager, replay, T, B,
                   phase="ppo-collect") -> dict:
    """A collect graph's replay against the eager collect from one
    generator state, bit for bit (every output: batch or sequences,
    rollout, final obs and state, and the recurrent collect's final hidden
    state and reset flags); then both timed in one process (CUDA events,
    eager, graph, graph, eager windows) and their device operations
    counted.  ``eager(gen)`` collects from ``gen``, ``replay()`` replays
    the graph, which draws from ``generator``; its state is put back."""
    start = generator.get_state()
    eager_gen = torch.Generator(device=dev)
    eager_gen.set_state(start)
    want = collect_outputs(eager(eager_gen))
    got = collect_outputs(replay())
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{label}: the replay gives {len(got)} outputs, "
                             f"the eager collect {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{label}: graph replay differs from the eager "
                                 f"collect at output {i}")
    n_out = len(want)
    del got, want
    t_eager, t_graph = [], []
    for fn, out in (((lambda i: eager(eager_gen)), t_eager),
                    ((lambda i: replay()), t_graph),
                    ((lambda i: replay()), t_graph),
                    ((lambda i: eager(eager_gen)), t_eager)):
        out.append(event_windows(fn, windows=2, calls=2))
    n_eager, dev_eager = device_ops(lambda: eager(eager_gen))
    n_graph, dev_graph = device_ops(replay)
    generator.set_state(start)
    out = {"eager_ms": statistics.median(t_eager),
           "graph_ms": statistics.median(t_graph),
           "ops_eager": n_eager, "ops_graph": n_graph,
           "dev_eager_ms": dev_eager, "dev_graph_ms": dev_graph}
    ops = (f"{n_eager / T:.2f} device ops per step eager ({n_eager} in all, "
           f"device busy {dev_eager:.3f} ms = "
           f"{dev_eager / out['eager_ms']:.4f} of the eager time), "
           f"{n_graph / T:.2f} replayed (busy {dev_graph:.3f} ms = "
           f"{dev_graph / out['graph_ms']:.4f})") if n_eager else \
        "device ops: not measured (the profiler's trace held no device events)"
    say(phase, f"{label}: graph replay == eager collect exactly "
        f"({n_out} outputs; T={T} B={B}); eager "
        f"{out['eager_ms']:.3f} ms, graph {out['graph_ms']:.3f} ms "
        f"(ratio {out['graph_ms'] / out['eager_ms']:.4f}; windows "
        f"{', '.join(f'{x:.3f}' for x in t_eager)} / "
        f"{', '.join(f'{x:.3f}' for x in t_graph)}); "
        f"{B * T / out['graph_ms'] * 1e3:.6e} env-steps/s replayed; {ops}")
    return out


def ppo_collect_checks(dev, ppo, env, cfg, model, ts, graph, label) -> None:
    """:func:`collect_checks` of PPO's collect graph."""
    collect_checks(
        dev, label, ts.generator,
        lambda gen: ppo.collect(env, model, cfg, ts.env_obs, ts.env_state, gen),
        lambda: graph(ts.env_obs, ts.env_state, ts.generator),
        cfg.rollout_steps, cfg.num_envs)


def ppo_learning(dev, ppo, gp) -> None:
    """The JAX package's two PPO learning smoke runs, on the card."""
    t0 = time.perf_counter()
    env = gp.make("DiscreteCarFlag-v0", num_actions=3, time_limit=60, device=dev)
    cfg = ppo.PPOConfig(num_envs=64, rollout_steps=32, epochs=4, minibatches=4,
                        hidden=(32, 32), learning_rate=1e-3, entropy_coef=0.003)
    model, ts = ppo.init_train_state(env, cfg,
                                     torch.Generator(device=dev).manual_seed(1))
    step = ppo.make_train_step(env, model, cfg)
    rewards = []
    for _ in range(PPO_CARFLAG_UPDATES):
        ts, m = step(ts)
        rewards.append(m["mean_reward"])
    r = torch.stack(rewards).cpu().numpy()
    smoke = r[25:30].mean() > r[:5].mean() - 1e-4
    say("ppo-learning", f"DiscreteCarFlag-v0 (3 actions, time limit 60), the "
        f"smoke test's config, {PPO_CARFLAG_UPDATES} updates: mean reward per "
        f"20 updates {', '.join(f'{x:.6f}' for x in r.reshape(-1, 20).mean(1))}; "
        f"last 100 {r[-100:].mean():.6f} > first 20 {r[:20].mean():.6f}; the "
        f"30-update smoke criterion (last 5 > first 5 - 1e-4) {smoke}")
    if not r[-100:].mean() > r[:20].mean():
        raise AssertionError("PPO did not learn DiscreteCarFlag-v0")

    env = gp.make("HeavenHellContinuous-v0", agent_speed=0.75, time_limit=150,
                  device=dev)
    cfg = ppo.PPOConfig(num_envs=128, rollout_steps=32, epochs=4, minibatches=4,
                        learning_rate=1e-3, entropy_coef=0.01)
    model, ts = ppo.init_train_state(env, cfg,
                                     torch.Generator(device=dev).manual_seed(1))
    step = ppo.make_train_step(env, model, cfg)
    pos, neg = [], []
    for _ in range(PPO_HH_UPDATES):
        ts, m = step(ts)
        ppo_metrics_line(m)
        pos.append(float(m["pos_reward_rate"]))
        neg.append(float(m["neg_reward_rate"]))
    p, n = np.mean(pos[-10:]), np.mean(neg[-10:])
    say("ppo-learning", f"HeavenHellContinuous-v0 surrogate (speed 0.75, time "
        f"limit 150), feedforward, {PPO_HH_UPDATES} updates: last 10 pos rate "
        f"{p:.6f}, neg {n:.6f}, heaven share {p / max(p + n, 1e-12):.4f}; "
        f"peak pos {max(pos):.6f}, neg {max(neg):.6f} (p < 1e-3, the JAX "
        f"test's, holds by seed in both packages: reported, not required); "
        f"both runs {time.perf_counter() - t0:.2f} s")
    if max(pos) + max(neg) <= 0:
        raise AssertionError("PPO on HeavenHell reached no terminal")


def ppo_path(dev, card) -> None:
    """Path 6: the PPO update on ExtendedHansenTaxi-v4 at PPOConfig's
    defaults, through init_train_state, make_train_step,
    make_multi_train_step and train; the collect half's graph held against
    the eager collect; the multi step against single updates; the collect
    at B = 65,536; the learning runs."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo

    t_path = time.perf_counter()
    env = gp.make(PPO_ENV, device=dev)
    cfg = ppo.PPOConfig()
    B, T = cfg.num_envs, cfg.rollout_steps
    model, ts = ppo.init_train_state(env, cfg,
                                     torch.Generator(device=dev).manual_seed(0))
    step = ppo.make_train_step(env, model, cfg)
    t0 = time.perf_counter()
    ts, m = step(ts)
    torch.cuda.synchronize()
    say("ppo", f"{PPO_ENV} B={B} T={T} E={cfg.epochs} M={cfg.minibatches} "
        f"hidden {cfg.hidden} shuffle {cfg.shuffle}: first update, graph "
        f"capture included, {time.perf_counter() - t0:.3f} s; "
        f"{ppo_metrics_line(m)}")
    n_obs = env.observation_space.n
    for _ in range(PPO_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts)
        collect_ms, learn_ms = ppo.halves_ms(step)
        wall = time.perf_counter() - t0
        if not ((ts.env_obs >= 0) & (ts.env_obs < n_obs)).all():
            raise AssertionError("PPO: obs out of range")
        say("ppo-update", f"update {ts.update_idx} on {card}: {wall * 1e3:.3f} "
            f"ms (CUDA events: collect {collect_ms:.3f} ms, learn "
            f"{learn_ms:.3f} ms), {B * T / wall:.6e} PPO env-steps/s; "
            f"{ppo_metrics_line(m)}")
    kept = {}

    def profiled_update():
        kept["ts"], kept["m"] = step(ts)

    n_ops, busy, top = device_ops(profiled_update, top=6)
    ts = kept["ts"]
    collect_ms, learn_ms = ppo.halves_ms(step)
    say("ppo-profile", f"update {ts.update_idx} under torch.profiler: {n_ops} "
        f"device ops, device busy {busy:.3f} ms of collect {collect_ms:.3f} + "
        f"learn {learn_ms:.3f} ms (events); most costly: " + "; ".join(
            f"{name} x{count} {ms:.3f} ms" for name, count, ms in top)
        if n_ops else "update under torch.profiler: not measured (no device "
        "events in the trace)")
    ppo_collect_checks(dev, ppo, env, cfg, model, ts, step.graph,
                       f"{PPO_ENV} after {ts.update_idx} updates")
    del step
    ppo_multi_check(dev, card, env, cfg, f"{PPO_ENV} B={B} T={T}")

    t0 = time.perf_counter()
    _, ts_train, history = ppo.train(env, cfg, seed=1, num_updates=3,
                                     log_every=2)
    if ts_train.update_idx != 3 or len(history) != 2:
        raise AssertionError("PPO train: wrong history")
    say("ppo-train", f"train(seed=1, num_updates=3, log_every=2), through "
        f"make_multi_train_step(2, bounded=True): 2 history rows, loss "
        f"{history[-1]['loss']:.6f}, {time.perf_counter() - t0:.3f} s")

    wide = cfg._replace(num_envs=B_PPO_WIDE)
    model_w, ts_w = ppo.init_train_state(
        env, wide, torch.Generator(device=dev).manual_seed(2))
    graph_w = ppo.CollectGraph(env, model_w, wide, ts_w.env_obs, ts_w.env_state,
                               ts_w.generator)
    ppo_collect_checks(dev, ppo, env, wide, model_w, ts_w, graph_w,
                       f"{PPO_ENV} B={B_PPO_WIDE}, for the record")
    del graph_w, model_w, ts_w
    ppo_learning(dev, ppo, gp)
    say("ppo", f"path 6 took {time.perf_counter() - t_path:.2f} s")


# ---------------------------------------------- recurrent PPO (path 7)
# path 6's env (benchmarks/learner.py's default) at PPOConfig's defaults
# (B = 4,096, T = 128, E = M = 4, f32), the GRU at init_rnn_state's width
RNN_UPDATES = 3
B_RNN_WIDE = 32768  # benchmarks/learner.py's default batch
# learning at the JAX tests' configs (tests/test_memory_learning.py,
# tests/test_ppo_rnn.py), each over the seeds both packages were swept on
# (0-7): on the CPU (tests/_rnn_seed_sweep.py) the GRU HeavenHell
# criterion (p > 0.02, heaven share > 0.9) held for JAX seeds 1, 3 and no
# port seed, and every run reached terminals; the DiscreteCarFlag one (last
# 5 updates' mean reward > the first 5's - 1e-4) for JAX 8 and port 7
# seeds, the TagContinuous one (> + 0.003) for 6 and 6, the Tag reward
# rising on every seed of both.  What held on every seed is required, the
# rates are printed
RNN_SEEDS = tuple(range(8))
RNN_HH_UPDATES = 50
RNN_SMOKES = (
    ("DiscreteCarFlag-v0", dict(num_actions=3, time_limit=60), 25, -1e-4,
     "finite metrics"),
    ("TagContinuous-v0", dict(time_limit=100, agent_speed=0.75), 30, 0.003,
     "gain > 0"),
)
# the learning runs are launch-bound (about 0.4 s an update, one host core
# each): one worker process per core of the card's host
RNN_LEARNING_WORKERS = 8
CHECKPOINT_DIR = "build/chip_smoke_checkpoint"


def rnn_update(ppo, step, ts, card, label, B, T) -> tuple:
    """One timed update; returns the new state and the line's numbers."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, m = step(ts)
    collect_ms, learn_ms = ppo.halves_ms(step)
    wall = time.perf_counter() - t0
    if not torch.isfinite(ts.hidden).all():
        raise AssertionError(f"{label}: non-finite hidden state")
    say("rnn-update", f"{label} update {ts.update_idx} on {card}: "
        f"{wall * 1e3:.3f} ms (CUDA events: collect {collect_ms:.3f} ms, learn "
        f"{learn_ms:.3f} ms), {B * T / wall:.6e} recurrent PPO env-steps/s; "
        f"{ppo_metrics_line(m)}")
    return ts, m, wall, collect_ms, learn_ms


def rnn_main(dev, card, gp, ppo, ppo_rnn):
    """Recurrent PPO at the defaults: updates timed, one profiled, the
    collect graph held against the eager collect; then B = 32,768."""
    env = gp.make(PPO_ENV, device=dev)
    cfg = ppo.PPOConfig()
    B, T = cfg.num_envs, cfg.rollout_steps
    model, ts = ppo_rnn.init_rnn_state(env, cfg,
                                       torch.Generator(device=dev).manual_seed(0))
    step = ppo_rnn.make_rnn_train_step(env, model, cfg)
    t0 = time.perf_counter()
    ts, m = step(ts)
    torch.cuda.synchronize()
    say("rnn", f"{PPO_ENV} B={B} T={T} E={cfg.epochs} M={cfg.minibatches} GRU "
        f"{model.hidden} f32 on {card}: first update, graph capture included, "
        f"{time.perf_counter() - t0:.3f} s; {ppo_metrics_line(m)}")
    n_obs = env.observation_space.n
    for _ in range(RNN_UPDATES):
        ts, *_ = rnn_update(ppo, step, ts, card, PPO_ENV, B, T)
        if not ((ts.env_obs >= 0) & (ts.env_obs < n_obs)).all():
            raise AssertionError("recurrent PPO: obs out of range")
    kept = {}

    def profiled_update():
        kept["ts"], kept["m"] = step(ts)

    n_ops, busy, top = device_ops(profiled_update, top=6)
    ts = kept["ts"]
    collect_ms, learn_ms = ppo.halves_ms(step)
    c = collect_checks(
        dev, f"{PPO_ENV} GRU after {ts.update_idx} updates", ts.generator,
        lambda gen: ppo_rnn.collect_rnn(env, model, cfg, ts.env_obs, ts.env_state,
                                        gen, ts.hidden, ts.prev_reset),
        lambda: step.graph(ts.env_obs, ts.env_state, ts.generator, ts.hidden,
                           ts.prev_reset),
        T, B, phase="rnn-collect")
    if n_ops:
        learn_busy = busy - c["dev_graph_ms"]
        say("rnn-profile", f"update {ts.update_idx} under torch.profiler on "
            f"{card}: {n_ops} device ops, device busy {busy:.3f} ms of collect "
            f"{collect_ms:.3f} + learn {learn_ms:.3f} ms (events); learn half "
            f"busy {learn_busy:.3f} ms (the update's less a replay's "
            f"{c['dev_graph_ms']:.3f}), {learn_busy / learn_ms:.4f} of it: the "
            f"host's launches bound the rest ({1 - learn_busy / learn_ms:.4f}); "
            f"{(n_ops - c['ops_graph']) / (cfg.epochs * cfg.minibatches * T):.1f}"
            " device ops per "
            "replayed cell step of the learn half; most costly: " + "; ".join(
                f"{name} x{count} {ms:.3f} ms" for name, count, ms in top))
    else:
        say("rnn-profile", "update under torch.profiler: not measured (no "
            "device events in the trace)")

    wide = cfg._replace(num_envs=B_RNN_WIDE)
    model_w, ts_w = ppo_rnn.init_rnn_state(
        env, wide, torch.Generator(device=dev).manual_seed(2))
    step_w = ppo_rnn.make_rnn_train_step(env, model_w, wide)
    t0 = time.perf_counter()
    ts_w, _ = step_w(ts_w)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ts_w, *_ = rnn_update(ppo, step_w, ts_w, card,
                          f"B={B_RNN_WIDE}, for the record (first update with "
                          f"the capture {first:.3f} s)", B_RNN_WIDE, T)
    say("rnn-wide", f"B={B_RNN_WIDE}: peak device memory of the update "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {card}")
    del step_w, model_w, ts_w
    return env, cfg


def bf16_checks(dev, card, gp, ppo, ppo_rnn, env, cfg) -> None:
    """Path 6's ActorCritic in float32 and bfloat16 in one process (learn
    halves side by side, windows f32, bf16, bf16, f32), then one bfloat16
    recurrent update."""
    halves = {}
    runs = {}
    for dt in (torch.float32, torch.bfloat16):
        c = cfg._replace(compute_dtype=dt)
        model, ts = ppo.init_train_state(env, c,
                                         torch.Generator(device=dev).manual_seed(0))
        step = ppo.make_train_step(env, model, c)
        ts, _ = step(ts)  # the capture
        runs[dt] = [step, ts]
        halves[dt] = []
    for dt in (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32):
        step, ts = runs[dt]
        for _ in range(2):
            ts, m = step(ts)
            ppo_metrics_line(m)
            halves[dt].append(ppo.halves_ms(step))
        runs[dt][1] = ts
    learn = {dt: statistics.median(l for _, l in v) for dt, v in halves.items()}
    coll = {dt: statistics.median(c for c, _ in v) for dt, v in halves.items()}
    say("bf16", f"PPO ActorCritic {cfg.hidden} on {PPO_ENV} B={cfg.num_envs} "
        f"T={cfg.rollout_steps} on {card}: learn half f32 {learn[torch.float32]:.3f} "
        f"ms, bf16 {learn[torch.bfloat16]:.3f} ms (ratio "
        f"{learn[torch.bfloat16] / learn[torch.float32]:.4f}; medians of 4 "
        f"updates each: f32 {', '.join(f'{l:.3f}' for _, l in halves[torch.float32])}"
        f"; bf16 {', '.join(f'{l:.3f}' for _, l in halves[torch.bfloat16])}); "
        f"collect f32 {coll[torch.float32]:.3f} ms, bf16 "
        f"{coll[torch.bfloat16]:.3f} ms")
    del runs
    c = cfg._replace(compute_dtype=torch.bfloat16)
    model, ts = ppo_rnn.init_rnn_state(env, c,
                                       torch.Generator(device=dev).manual_seed(3))
    step = ppo_rnn.make_rnn_train_step(env, model, c)
    ts, _ = step(ts)
    if ts.hidden.dtype != torch.bfloat16:
        raise AssertionError("bf16 recurrent PPO: the hidden state is not bf16")
    rnn_update(ppo, step, ts, card, f"{PPO_ENV} GRU bf16", c.num_envs,
               c.rollout_steps)


def rnn_resume_check(dev, card, ppo, ppo_rnn, env, cfg) -> None:
    """Save after one update; the next update straight through, and again
    from the checkpoint restored into a fresh state (its own step and
    graph): equal bit for bit."""
    from gym_po_tpu_torch.utils import restore_checkpoint, save_checkpoint

    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             CHECKPOINT_DIR)
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.perf_counter()
    model, ts = ppo_rnn.init_rnn_state(env, cfg,
                                       torch.Generator(device=dev).manual_seed(4))
    step = ppo_rnn.make_rnn_train_step(env, model, cfg)
    ts, _ = step(ts)
    save_checkpoint(directory, 1, ts)
    ts_a, m_a = step(ts)
    model_b, ts_b = ppo_rnn.init_rnn_state(
        env, cfg, torch.Generator(device=dev).manual_seed(5))
    ts_b = restore_checkpoint(directory, ts_b)
    ts_b, m_b = ppo_rnn.make_rnn_train_step(env, model_b, cfg)(ts_b)
    got = collect_outputs((ts_b.params, ts_b.opt_state, ts_b.env_obs,
                           ts_b.env_state, ts_b.hidden, ts_b.prev_reset,
                           ts_b.generator.get_state(), *m_b.values()))
    want = collect_outputs((ts_a.params, ts_a.opt_state, ts_a.env_obs,
                            ts_a.env_state, ts_a.hidden, ts_a.prev_reset,
                            ts_a.generator.get_state(), *m_a.values()))
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"resume: tensor {i} of the resumed update "
                                 f"differs (max {(g.double() - w.double()).abs().max()})")
    shutil.rmtree(directory)
    say("rnn-resume", f"{PPO_ENV} GRU B={cfg.num_envs} on {card}: an update from "
        f"the checkpoint restored into a fresh state == the update straight "
        f"through, bit for bit ({len(got)} tensors: params, Adam, envs, hidden, "
        f"resets, generator, metrics); {time.perf_counter() - t0:.2f} s")


def rnn_learning_run(job: tuple) -> dict:
    """One recurrent learning run (a worker process's job): ``job`` is
    (device, env id, env kwargs, PPOConfig kwargs, updates, seed); returns
    each update's mean reward and terminal rates.  GRU 32 wide."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo, ppo_rnn

    device, env_id, kw, cfg_kw, updates, seed = job
    dev = torch.device(device)
    env = gp.make(env_id, device=dev, **kw)
    cfg = ppo.PPOConfig(**cfg_kw)
    model, ts = ppo_rnn.init_rnn_state(
        env, cfg, torch.Generator(device=dev).manual_seed(seed), hidden=32)
    step = ppo_rnn.make_rnn_train_step(env, model, cfg)
    metrics = []
    for _ in range(updates):
        ts, m = step(ts)
        metrics.append(m)
    ppo_metrics_line(metrics[-1])  # raises on a non-finite metric
    return {k: torch.stack([m[k] for m in metrics]).cpu().numpy()
            for k in ("mean_reward", "pos_reward_rate", "neg_reward_rate")}


def rnn_learning(dev, card) -> None:
    """The JAX package's recurrent learning runs on the card, each over
    seeds 0-7.  The runs are launch-bound, so they go to
    ``RNN_LEARNING_WORKERS`` processes, each launching its own; every run
    draws from its own generator, as alone."""
    import multiprocessing

    hh = ("HeavenHellContinuous-v0", dict(agent_speed=0.75, time_limit=150),
          dict(num_envs=128, rollout_steps=32, epochs=4, minibatches=4,
               learning_rate=1e-3, entropy_coef=0.01, shuffle="none"),
          RNN_HH_UPDATES)
    smoke = dict(num_envs=64, rollout_steps=32, epochs=4, minibatches=4,
                 learning_rate=1e-3, entropy_coef=0.003)
    runs = [hh] + [(env_id, kw, smoke, updates)
                   for env_id, kw, updates, _, _ in RNN_SMOKES]
    jobs = [(dev.type, *run, seed) for run in runs for seed in RNN_SEEDS]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(RNN_LEARNING_WORKERS) as pool:
        results = pool.map(rnn_learning_run, jobs, chunksize=1)
    say("rnn-learning", f"{len(jobs)} runs ({sum(j[-2] for j in jobs)} updates) "
        f"in {RNN_LEARNING_WORKERS} processes on {card}: "
        f"{time.perf_counter() - t0:.2f} s")
    results = iter(results)

    held = []
    for seed in RNN_SEEDS:
        r = next(results)
        p, n = r["pos_reward_rate"][-10:].mean(), r["neg_reward_rate"][-10:].mean()
        share = p / max(p + n, 1e-12)
        held.append(bool(p > 0.02 and share > 0.9))
        peak_p, peak_n = r["pos_reward_rate"].max(), r["neg_reward_rate"].max()
        say("rnn-learning", f"HeavenHellContinuous-v0 surrogate (speed 0.75, "
            f"time limit 150), GRU 32, seed {seed}, {RNN_HH_UPDATES} updates on "
            f"{card}: last 10 pos rate {p:.6f}, neg {n:.6f}, heaven share "
            f"{share:.4f}; peak pos {peak_p:.6f}, neg {peak_n:.6f}; criterion "
            f"(p > 0.02, share > 0.9) {held[-1]}")
        if peak_p + peak_n <= 0:
            raise AssertionError(f"GRU HeavenHell seed {seed}: no terminal reached")
    say("rnn-learning", f"GRU HeavenHell criterion held for {sum(held)} of "
        f"{len(held)} seeds (seeds {[s for s, h in zip(RNN_SEEDS, held) if h]}); "
        "every seed reached terminals")
    for env_id, kw, updates, margin, required in RNN_SMOKES:
        gains = []
        for seed in RNN_SEEDS:
            r = next(results)["mean_reward"]
            gains.append(r[-5:].mean() - r[:5].mean())
        held = [g > margin for g in gains]
        say("rnn-learning", f"{env_id} smoke, GRU 32, {updates} updates, seeds "
            f"{RNN_SEEDS[0]}-{RNN_SEEDS[-1]} on {card}: mean reward "
            f"last 5 - first 5 {', '.join(f'{g:.6f}' for g in gains)}; the "
            f"test's criterion (> {margin:g}) held for {sum(held)} of "
            f"{len(held)}; required on every seed: {required}")
        if required == "gain > 0" and min(gains) <= 0:
            raise AssertionError(f"recurrent PPO on {env_id}: a seed's reward "
                                 "did not rise")


def rnn_path(dev, card) -> None:
    """Path 7: recurrent PPO on ExtendedHansenTaxi-v4 at PPOConfig's
    defaults through init_rnn_state and make_rnn_train_step; its collect
    graph held against the eager collect; B = 32,768; the bf16 learn
    halves; resume from a checkpoint; the learning runs."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo, ppo_rnn

    t_path = time.perf_counter()
    env, cfg = rnn_main(dev, card, gp, ppo, ppo_rnn)
    bf16_checks(dev, card, gp, ppo, ppo_rnn, env, cfg)
    rnn_resume_check(dev, card, ppo, ppo_rnn, env, cfg)
    rnn_learning(dev, card)
    say("rnn", f"path 7 took {time.perf_counter() - t_path:.2f} s")


# ---------------------------------------------- data parallel (path 8)
# the trainers at their full width (B_TRAIN, K_TRAIN) over four chunks;
# the PPO update at PPOConfig's defaults (path 6's)
SCHED_MESH_Q = [(LR_TRAIN, EPS_TRAIN, 4 * K_TRAIN)]
SCHED_MESH_AC = [(ALPHA_PI, ALPHA_V, 4 * K_TRAIN)]
MESH_ROUNDS = 10  # PPO updates with and without the mesh, in turns
MESH_MULTI_UPDATES = 2  # the multi step's updates with and without the mesh
ALLREDUCE_ITERS = 50


def allreduce_ms(mesh, numel: int) -> float:
    """Host ms per ``all_mean_`` of a ``numel``-word f32 tensor on the
    mesh's device (every rank calls it), after 5 warm-up calls."""
    x = torch.ones(numel, device=mesh.device)
    for _ in range(5):
        mesh.all_mean_(x)
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_ITERS):
        mesh.all_mean_(x)
    torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t0) / ALLREDUCE_ITERS * 1e3


MESH_TIMES: collections.Counter = collections.Counter()


def timed_mesh(mesh, drain: bool):
    """``mesh`` with each ``all_mean_`` timed on the host clock into
    ``MESH_TIMES``: the all-reduce and its division ("reduce"), with
    ``drain`` after a wait for the device's queued work ("drain"), which a
    gloo all-reduce of a CUDA tensor makes anyway."""
    base = type(mesh)

    class TimedMesh(base):
        def all_mean_(self, x):
            t0 = time.perf_counter()
            if drain:
                torch.cuda.synchronize(x.device)
            t1 = time.perf_counter()
            base.all_mean_(self, x)
            MESH_TIMES["reduce"] += time.perf_counter() - t1
            MESH_TIMES["drain"] += t1 - t0
            MESH_TIMES["calls"] += 1
            return x

    return TimedMesh(*(getattr(mesh, f.name) for f in dataclasses.fields(mesh)))


def comm_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler, host and device: its device
    ops and busy ms, the device ms of kernels named ``nccl``, and the host
    ms of each collective's op (count, inclusive ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    us = {e.key: getattr(e, "self_device_time_total", 0) for e in dev}
    return {"ops": sum(e.count for e in dev), "busy_ms": sum(us.values()) / 1e3,
            "nccl_ms": sum(u for k, u in us.items() if "nccl" in k.lower()) / 1e3,
            "host": {e.key: (e.count, e.cpu_time_total / 1e3) for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and ("allreduce" in e.key.lower() or "all_reduce" in e.key.lower())}}


def comm_line(p: dict) -> str:
    host = ", ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in p["host"].items())
    return (f"{p['ops']} device ops, busy {p['busy_ms']:.3f} ms (nccl kernels "
            f"{p['nccl_ms']:.3f}); host in the collectives' ops: {host or 'none'}")


def q_banks_words(env) -> int:
    from gym_po_tpu_torch.ops import bank_geometry

    return bank_geometry(int(env.observation_space.n), int(env.action_space.n))[1] * 128


def mesh_rank_trainers(devices, seed: int) -> dict:
    """A rank of path 8's gloo group: Taxi Q and the actor-critic through
    the mesh, then the all-reduce of a Q table and of PPO's gradient timed;
    returns the tables, histories and the rank's kernel launches."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import PPOConfig, fused_actor_critic, fused_q_learning
    from gym_po_tpu_torch.agents.networks import flatten_parameters, make_actor_critic
    from gym_po_tpu_torch.ops._build import LAUNCHES
    from gym_po_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=devices)
    taxi = gp.make("Taxi-v4", device=mesh.device)
    LAUNCHES.clear()
    q, q_hist = fused_q_learning(taxi, seed, SCHED_MESH_Q, num_envs=B_TRAIN,
                                 chunk_steps=K_TRAIN, mesh=mesh)
    th, v, ac_hist = fused_actor_critic(gp.make("Rooms-v0", device=mesh.device),
                                        seed, SCHED_MESH_AC, num_envs=B_TRAIN,
                                        chunk_steps=K_TRAIN, mesh=mesh)
    torch.cuda.synchronize(mesh.device)
    launches = dict(LAUNCHES)
    env = gp.make(PPO_ENV, device=mesh.device)
    n_grad = flatten_parameters(make_actor_critic(env, PPOConfig().hidden)).numel()
    return {"q": q, "q_hist": q_hist, "th": th, "v": v, "ac_hist": ac_hist,
            "launches": launches,
            "q_ms": allreduce_ms(mesh, q_banks_words(taxi)),
            "grad_ms": allreduce_ms(mesh, n_grad)}


def mesh_rank_ppo(devices, seed: int) -> dict:
    """A rank of path 8's gloo group: one data-parallel PPO update at
    PPOConfig's defaults from the global state of ``seed``."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo
    from gym_po_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=devices)
    env = gp.make(PPO_ENV, device=mesh.device)
    cfg = ppo.PPOConfig()
    model, ts = ppo.init_train_state(env, cfg,
                                     torch.Generator(device=mesh.device).manual_seed(seed))
    ts = ppo.shard_train_state(ts, mesh)
    step = ppo.make_train_step(env, model, cfg, mesh)
    ts, m = step(ts)
    collect_ms, learn_ms = ppo.halves_ms(step)
    out = {"params": ts.params.cpu(), "metrics": {k: float(x) for k, x in m.items()},
           "collect_ms": collect_ms, "learn_ms": learn_ms}
    out["learn"] = learn_breakdown(env, model, cfg, ts, mesh)
    return out


def learn_breakdown(env, model, cfg, ts, mesh) -> dict:
    """Where a learn half's time goes on ranks that share a card: one batch
    of this rank's, learned from the same parameters (a) over the mesh,
    each all-reduce timed on the host after draining the device, (b)
    without the mesh, every rank at once, (c) without the mesh, rank 0
    alone; each timed on the host clock, then once more under
    torch.profiler (device busy).  Returns ``{case: {"ms", "ops",
    "busy_ms", ...}}`` (rank 0 alone holds (c))."""
    import torch.distributed as dist

    from gym_po_tpu_torch.agents import ppo

    batch, _, _, _ = ppo.collect(env, model, cfg, ts.env_obs, ts.env_state,
                                 ts.generator)
    orders = ppo.row_orders(cfg, batch.obs.shape[0], ts.generator)
    state = (ts.params, ts.opt_state.count, ts.opt_state.mu, ts.opt_state.nu)
    saved = [t.clone() for t in state]
    out = {}
    for case, m in (("mesh", timed_mesh(mesh, drain=True)), ("apart", None),
                    ("alone", None)):
        for profiled in (False, True):
            for t, v in zip(state, saved):
                t.copy_(v)
            torch.cuda.synchronize()
            dist.barrier(group=mesh.group)
            if case != "alone" or mesh.rank == 0:
                MESH_TIMES.clear()

                def learn():
                    ppo.learn(model, ts.params, ts.opt_state, cfg, batch, orders, m)

                if profiled:
                    out[case]["ops"], out[case]["busy_ms"] = device_ops(learn)
                else:
                    t0 = time.perf_counter()
                    learn()
                    torch.cuda.synchronize()
                    out[case] = {"ms": (time.perf_counter() - t0) * 1e3,
                                 **{k: v * 1e3 if k != "calls" else v
                                    for k, v in MESH_TIMES.items()}}
            dist.barrier(group=mesh.group)
    for t, v in zip(state, saved):
        t.copy_(v)
    return out


def emulated_q(gp, dev, env_id, seed, sched, B, K, n, trainer):
    """What an n-rank mesh gives, in one process: the global reset from
    ``seed``, each shard's chunk through the kernel with its chunk seed,
    the tables averaged after each chunk as (a + b) / 2 (n = 2).  Returns
    the final banks (one tuple per averaged output) and the histories."""
    from gym_po_tpu_torch.agents.qlearning import _flat_agents
    from gym_po_tpu_torch.ops import make_fused_ac_trainer_rooms, make_fused_q_trainer, q_to_banks
    from gym_po_tpu_torch.parallel import chunk_seeds, shard_rows

    env = gp.make(env_id, device=dev)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(seed), B)
    if trainer == "q":
        run = make_fused_q_trainer(env, B // n, K, 0.99, average_duplicates=True)
        s = [shard_rows(st.s.reshape(-1, 128), r, n) for r in range(n)]
        tables = [torch.as_tensor(q_to_banks(np.zeros((512, 5), np.float32)), device=dev)]
    else:
        run = make_fused_ac_trainer_rooms(env, B // n, K, 0.99)
        s = [shard_rows(_flat_agents(env, st), r, n) for r in range(n)]
        A = int(env.num_actions)
        tables = [torch.as_tensor(q_to_banks(np.zeros((512, k), np.float32)), device=dev)
                  for k in (A, 1)]
    hist = []
    for i in range(int(sched[0][2]) // K):
        seeds = chunk_seeds(seed, i + 1, n)
        outs = []
        for r in range(n):
            if trainer == "q":
                s_r, q_r, rew = run(int(seeds[r]), sched[0][0], sched[0][1], s[r], tables[0])
                outs.append(((q_r,), s_r, rew))
            else:
                th, v, s_r, rew = run(int(seeds[r]), sched[0][0], sched[0][1],
                                      tables[0], tables[1], s[r])
                outs.append(((th, v), s_r, rew))
        s = [o[1] for o in outs]
        tables = [(outs[0][0][j] + outs[1][0][j]) / 2 for j in range(len(tables))]
        hist.append((outs[0][2].mean() + outs[1][2].mean()) / 2)
    return tables, [h / K for h in torch.stack(hist).tolist()]


def emulated_ppo(dev, seed: int, n: int):
    """What an n-rank PPO update gives, in one process: the global state
    of ``seed``, each shard's eager collect from its generator, then the
    learn half with each minibatch's gradients averaged as (a + b) / 2.
    Returns the parameters and the learn half's ms (both shards' work, one
    after the other, in one process)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo
    from gym_po_tpu_torch.agents.networks import parameter_list
    from gym_po_tpu_torch.parallel import shard_rows, split_generator

    env = gp.make(PPO_ENV, device=dev)
    cfg = ppo.PPOConfig()
    model, ts = ppo.init_train_state(env, cfg,
                                     torch.Generator(device=dev).manual_seed(seed))
    gens = split_generator(ts.generator, n, dev)
    batches, orders = [], []
    for r in range(n):
        obs, st = shard_rows((ts.env_obs, ts.env_state), r, n)
        batch, _, _, _ = ppo.collect(env, model, cfg, obs, st, gens[r])
        batches.append(batch)
        orders.append(ppo.row_orders(cfg, batch.obs.shape[0], gens[r]))
    plist = parameter_list(model)
    mb = batches[0].obs.shape[0] // cfg.minibatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in range(cfg.epochs):
        rows = [ppo.Batch(*(x[orders[r][e]] for x in batches[r])) for r in range(n)]
        for m in range(cfg.minibatches):
            flats = []
            for r in range(n):
                part = ppo.Batch(*(x[m * mb:(m + 1) * mb] for x in rows[r]))
                loss, _ = ppo._loss_fn(model, part, cfg)
                grads = torch.autograd.grad(loss, plist)
                flats.append(torch.cat([g.reshape(-1) for g in grads]))
            ppo.adam_step(ts.params, ts.opt_state, (flats[0] + flats[1]) / 2, cfg)
    torch.cuda.synchronize()
    return ts.params.cpu(), (time.perf_counter() - t0) * 1e3


def mesh_path(dev, card) -> dict:
    """Path 8, data parallelism through torch.distributed: a one-rank NCCL
    mesh against no mesh (Taxi Q [2], the actor-critic [13], the PPO update
    at PPOConfig's defaults, bit for bit; the PPO update timed both ways,
    with the host time in the mesh's all-reduces and a profile of each;
    the all-reduce of a Q table and of PPO's gradient timed), two ranks on
    the card over gloo against both shards run in one process and averaged
    (Taxi Q, the actor-critic, the PPO update; a learn half broken down,
    :func:`learn_breakdown`), ``dryrun_multichip(1)``, a
    Taxi frame from a card state, the gymnasium adapter where gymnasium is
    installed.  Returns the kernels' launches in the ranks' processes."""
    import importlib.util
    import tempfile

    import torch.distributed as dist

    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import fused_actor_critic, fused_q_learning, ppo
    from gym_po_tpu_torch.entry import dryrun_multichip
    from gym_po_tpu_torch.ops import banks_to_q
    from gym_po_tpu_torch.parallel import Ranks, make_mesh

    t_path = time.perf_counter()
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("gymnasium", "pygame", "mujoco")}
    say("mesh", "on this machine: " + ", ".join(
        f"{m} {'found' if ok else 'not found'}" for m, ok in found.items()))
    taxi, rooms = gp.make("Taxi-v4", device=dev), gp.make("Rooms-v0", device=dev)
    seed = 7
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(devices=[dev])
            kw = dict(num_envs=B_TRAIN, chunk_steps=K_TRAIN)
            for name, fn, env, sched in (
                    ("Taxi Q [2]", fused_q_learning, taxi, SCHED_MESH_Q),
                    ("actor-critic [13]", fused_actor_critic, rooms, SCHED_MESH_AC)):
                plain = fn(env, seed, sched, **kw)
                meshed = fn(env, seed, sched, mesh=mesh, **kw)
                for a, b in zip(plain, meshed):
                    if not np.array_equal(np.asarray(a), np.asarray(b)):
                        raise AssertionError(f"{name}: a one-rank NCCL mesh "
                                             "differs from no mesh")
                say("mesh", f"{name} on {env.name} B={B_TRAIN} K={K_TRAIN}, "
                    f"{len(plain[-1])} chunks: one-rank NCCL mesh == no mesh "
                    f"bit for bit (last chunk's reward/step {plain[-1][-1]:.6f})")
            # the PPO update: one state each from one seed, updates in
            # turns (no mesh first in even rounds); round 0 captures the
            # collect graphs and is not timed
            cfg = ppo.PPOConfig()
            env = gp.make(PPO_ENV, device=dev)
            runs = []
            for m in (None, timed_mesh(mesh, drain=False)):
                model, ts = ppo.init_train_state(
                    env, cfg, torch.Generator(device=dev).manual_seed(seed))
                runs.append([ts, ppo.make_train_step(env, model, cfg, m), []])
            for i in range(MESH_ROUNDS + 1):
                for run in (runs if i % 2 == 0 else runs[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run[0], _ = run[1](run[0])
                    torch.cuda.synchronize()
                    if i:
                        run[2].append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    MESH_TIMES.clear()
            host_ar = dict(MESH_TIMES)
            prof = []
            for run in runs:
                def one(run=run):
                    run[0], _ = run[1](run[0])
                prof.append(comm_profile(one))
            if not torch.equal(runs[0][0].params, runs[1][0].params):
                raise AssertionError("PPO: a one-rank NCCL mesh differs from no mesh")
            plain_ms = statistics.median(runs[0][2])
            mesh_ms = statistics.median(runs[1][2])
            say("mesh-ppo", f"{PPO_ENV} at PPOConfig's defaults, "
                f"{runs[0][0].update_idx} updates each: one-rank NCCL mesh == "
                f"no mesh bit for bit; update {plain_ms:.3f} ms without the "
                f"mesh, {mesh_ms:.3f} ms with it (medians of "
                f"{len(runs[0][2])}, in turns, on {card}): ratio "
                f"{mesh_ms / plain_ms:.4f}")
            say("mesh-ppo", f"where the mesh's time goes: {host_ar['calls']} "
                f"all_mean_ calls in {MESH_ROUNDS} updates, "
                f"{host_ar['reduce'] * 1e3 / MESH_ROUNDS:.4f} ms of host time an "
                f"update inside them ({host_ar['reduce'] * 1e3 / host_ar['calls']:.4f}"
                f" a call); one more update each under torch.profiler: no mesh "
                f"{comm_line(prof[0])}; mesh {comm_line(prof[1])}")
            n_grad = runs[0][0].params.numel()
            nccl_q = allreduce_ms(mesh, q_banks_words(taxi))
            nccl_grad = allreduce_ms(mesh, n_grad)
            say("mesh-allreduce", f"NCCL, one rank: Q banks ({q_banks_words(taxi)} "
                f"f32) {nccl_q:.4f} ms per chunk, PPO gradient ({n_grad} f32) "
                f"{nccl_grad:.4f} ms per minibatch (host clock, mean of "
                f"{ALLREDUCE_ITERS})")
            del runs
            # the multi step: each update one replay of an UpdateGraph, the
            # mesh's all-reduces captured in it
            multi_runs = []
            for m in (None, mesh):
                model, ts = ppo.init_train_state(
                    env, cfg, torch.Generator(device=dev).manual_seed(seed))
                multi = ppo.make_multi_train_step(env, model, cfg,
                                                  MESH_MULTI_UPDATES, m)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ts, met = multi(ts)
                torch.cuda.synchronize()
                if multi.graph is None:
                    raise AssertionError("PPO multi step: no update graph on the card")
                multi_runs.append((ts, met, time.perf_counter() - t0))
            (ta, ma, sa), (tb, mb, sb) = multi_runs
            diffs = train_state_diffs(ta, tb) + [k for k in ma
                                                 if not torch.equal(ma[k], mb[k])]
            if diffs:
                raise AssertionError("PPO multi step: a one-rank NCCL mesh "
                                     f"differs from no mesh in {diffs}")
            say("mesh-ppo-multi", f"make_multi_train_step({MESH_MULTI_UPDATES}) "
                f"at PPOConfig's defaults: one-rank NCCL mesh (its all-reduces "
                f"in the update's CUDA graph) == no mesh bit for bit; first "
                f"call, capture included, {sa:.3f} s without the mesh, "
                f"{sb:.3f} s with it")
            del multi_runs, multi
        finally:
            dist.destroy_process_group()

    # two ranks on the one card, over gloo
    t0 = time.perf_counter()
    with Ranks(2, "gloo", timeout=300) as ranks:
        tr = ranks.run(mesh_rank_trainers, [str(dev)] * 2, seed)
        pp = ranks.run(mesh_rank_ppo, [str(dev)] * 2, seed)
    say("mesh-gloo", f"two ranks on {card} over gloo: started, ran and "
        f"stopped in {time.perf_counter() - t0:.2f} s")
    with uncounted():
        (eq,), eq_hist = emulated_q(gp, dev, "Taxi-v4", seed, SCHED_MESH_Q,
                                    B_TRAIN, K_TRAIN, 2, "q")
        (eth, ev), eac_hist = emulated_q(gp, dev, "Rooms-v0", seed, SCHED_MESH_AC,
                                         B_TRAIN, K_TRAIN, 2, "ac")
    n_obs, A = int(rooms.observation_space.n), int(rooms.num_actions)
    want_q = banks_to_q(eq.cpu().numpy(), 512, 5)[:500]
    want_th = banks_to_q(eth.cpu().numpy(), 512, na=A)[:n_obs]
    want_v = banks_to_q(ev.cpu().numpy(), 512, na=1)[:n_obs, 0]
    for r, out in enumerate(tr):
        for name, got, want in (("Taxi Q", out["q"], want_q),
                                ("actor-critic logits", out["th"], want_th),
                                ("actor-critic values", out["v"], want_v)):
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}, rank {r}: two gloo ranks differ "
                                     "from the two shards averaged in one process")
        if not (np.allclose(out["q_hist"], eq_hist, rtol=1e-6)
                and np.allclose(out["ac_hist"], eac_hist, rtol=1e-6)):
            raise AssertionError(f"rank {r}: histories differ from the emulation")
    say("mesh-gloo", f"Taxi Q [2] and the actor-critic [13], B={B_TRAIN} "
        f"(two shards of {B_TRAIN // 2}) K={K_TRAIN}: both ranks == both shards "
        "run in one process, tables averaged as (a + b) / 2, bit for bit")
    want_p, emulated_ms = emulated_ppo(dev, seed, 2)
    for r, out in enumerate(pp):
        if not torch.equal(out["params"], want_p):
            raise AssertionError(f"PPO, rank {r}: two gloo ranks differ from the "
                                 "two shards' gradients averaged in one process")
    if pp[0]["metrics"] != pp[1]["metrics"]:
        raise AssertionError("PPO: the two ranks' metrics differ")
    say("mesh-gloo", f"PPO update at PPOConfig's defaults (two shards of "
        f"{ppo.PPOConfig().num_envs // 2} envs): both ranks == the two shards' "
        f"gradients averaged in one process, bit for bit; the ranks' halves of "
        f"this first update in a fresh process (one-time start-up included): "
        + ", ".join(f"collect {p['collect_ms']:.3f} ms, learn {p['learn_ms']:.3f} "
                    "ms" for p in pp)
        + f" (CUDA events; both processes on the one card, the gloo all-reduce "
        f"through the host); the emulation's learn half, both shards in one "
        f"process, {emulated_ms:.3f} ms (host clock); "
        f"{ppo_metrics_line(pp[0]['metrics'])}")
    for r, out in enumerate(pp):
        lb = out["learn"]
        cfg = ppo.PPOConfig()
        say("mesh-gloo-learn", f"rank {r}: one batch's learn half ({cfg.num_envs // 2} "
            f"envs, {cfg.epochs * cfg.minibatches} minibatch steps) over gloo {lb['mesh']['ms']:.3f} ms (host "
            f"clock), of it {lb['mesh']['drain']:.3f} ms draining the device "
            f"before the {lb['mesh']['calls']} all-reduces and "
            f"{lb['mesh']['reduce']:.3f} ms in them, busy {lb['mesh']['busy_ms']:.3f} "
            f"ms ({lb['mesh']['ops']} device ops); without the mesh, both ranks "
            f"at once {lb['apart']['ms']:.3f} ms, busy {lb['apart']['busy_ms']:.3f}"
            + (f"; rank 0 alone {lb['alone']['ms']:.3f} ms, busy "
               f"{lb['alone']['busy_ms']:.3f}" if r == 0 else ""))
    say("mesh-allreduce", f"gloo, two ranks on one card: Q banks "
        f"{tr[0]['q_ms']:.4f} ms per chunk, PPO gradient {tr[0]['grad_ms']:.4f} "
        f"ms per minibatch (rank 0, host clock, mean of {ALLREDUCE_ITERS})")

    t0 = time.perf_counter()
    dry = dryrun_multichip(1)
    say("mesh-dryrun", f"dryrun_multichip(1) on {card}: Taxi Q and one PPO "
        f"update over a one-rank NCCL group, loss {dry[0]['loss']:.6f}, "
        f"{time.perf_counter() - t0:.2f} s")

    from gym_po_tpu_torch.render import render

    _, st = taxi.reset_vec(torch.Generator(device=dev).manual_seed(1), 16)
    frame = render(taxi, st, range(16))
    cpu_st = gp.core.map_tensors(lambda t: t.cpu(), st)
    if not np.array_equal(frame, render(gp.make("Taxi-v4", device="cpu"), cpu_st,
                                        range(16))):
        raise AssertionError("render: a card state's frame differs from its CPU copy's")
    say("render", f"Taxi-v4 frame of 16 envs {frame.shape} from a card state "
        "== from its copy on the CPU")
    if found["gymnasium"]:
        from gym_po_tpu_torch.compat import TaxiVecEnv

        venv = TaxiVecEnv(num_envs=8, hansen_obs=True, device=dev)
        obs, _ = venv.reset(seed=0)
        for _ in range(4):
            obs, rew, done, trunc, _ = venv.step(np.zeros(8, np.int64))
        if not venv.single_observation_space.contains(int(obs[0])):
            raise AssertionError("gymnasium adapter: obs outside its space")
        say("adapter", "TaxiVecEnv(hansen_obs=True) on the card: reset and 4 "
            f"steps, NumPy out {obs.dtype} {obs.shape}")
    else:
        say("adapter", "gymnasium is not installed here: the adapter "
            "(gym_po_tpu_torch.compat, not on the main path) was not driven")
    launches = collections.Counter()
    for out in tr + dry:
        launches.update(out["launches"])
    say("mesh", f"path 8 took {time.perf_counter() - t_path:.2f} s")
    return launches


# ------------------------------------------- the articulated ant (path 9)
# the envs' defaults (frame_skip 15, 8 Newton iterations, 10 line-search
# bisections, f32) at the batch the JAX package's docs/PHYSICS.md measures
ANT_IDS = ("AntTagPhysics-v0", "AntHeavenHellPhysics-v0")
B_ANT = 4096
# the card's env step against the CPU's, stage by stage, at frame_skip 3
# (the CPU's RK4 step at the default 15 took 12-19 s of the path)
B_ANT_STAGES = 64
ANT_STAGES_FRAME_SKIP = 3
HH_SITES_XY = ((-6.25, 6.0), (6.25, 6.0), (0.0, 6.0))  # hell/heaven, priest
ANT_ENGINE_STATES = 64
ANT_ENGINE_TOL = 1e-9  # f64, card vs CPU: |a - b| <= tol * max(1, |b|)
ANT_STAGE_ATOL = 1e-6  # f32 task stages fed identical inputs
# f32 physics stage (3 RK4 substeps of 8 Newton iterations), card vs CPU
# from one state: qpos and qvel to the CPU test's atol 1e-4 (the card read
# 2.4e-7 and 2.5e-6 on an NVIDIA H100 80GB HBM3 at 700 W); the warm start,
# the last Newton iterate of qacc (|qacc| up to about 80), which rounding
# moves more than the state, to 2e-3 relative to max(1, |x|) (a warm start
# dropped or misplaced is off by order 1)
ANT_PHYSICS_TOL = {"qpos": 1e-4, "qvel": 1e-4, "warm": 2e-3}
ANT_STEPS = 20
# the walls' inner faces around the torso's xy (envs/mjcf.py's arenas)
ANT_ARENA = {"AntTagPhysics-v0": ((-5.0, 5.0), (-5.0, 5.0)),
             "AntHeavenHellPhysics-v0": ((-8.0, 8.0), (-1.5, 8.0))}
ANT_TIMED = 3
# the PPO update at T = 8 on Euler and at T = 2 on RK4, the envs' default
# (the capture of the collect graph grows with T, four forwards an RK4
# substep against Euler's one: the ant-ppo lines print it)
ANT_PPO = (("euler", 8), ("rk4", 2))
# train() on the heaven-hell env (integrator, T, updates) and one GRU-PPO
# update on the tag env (integrator, T), B = B_ANT, E = M = 4
ANT_TRAIN_HH = ("euler", 8, 2)
ANT_RNN = ("euler", 8)
# the renderer's rows of a B = 4,096 card state; the card's f64 fk against
# the renderer's NumPy FK (one tree walk, rounding only)
ANT_RENDER_ROWS = (0, 1, 2047, 4095)
ANT_RENDER_FK_TOL = 1e-12
# the batch scan that shows whether chunking (vector/chunked.py) is a speed
# remedy on the card: one step at B_ANT_SCAN against the same batch as
# ANT_SCAN_CHUNKS chunked steps of B_ANT each; the single step reaching
# ANT_NO_CLIFF of the chunks' rate is no cliff
B_ANT_SCAN = 16384
ANT_SCAN_CHUNKS = 4
ANT_NO_CLIFF = 0.9
# the ant kernels against their twins on the same inputs, relative to
# max(1, |x|).  f64 (ant_scalar_check, B_ANT contact states per arena): M,
# qacc_smooth, the kinematics, the densified rows, aref, r, qacc and warm
# within ANT_KERNEL_TOL, the active flags equal.  f32 at the timed shape
# (ant_kernel_times: the timed launches' outputs, B_ANT): each kernel
# within ANT_F32_TOL (about 3x the readings on an NVIDIA H100 80GB HBM3 at
# 700 W: 3.7e-6, 7.2e-4 (aref: the contact stiffness times f32 distances),
# 3.6e-5; PERF.md), and the active flags equal but on rows whose candidate
# lies within ANT_ACTIVE_SLACK (m) of its threshold (f32 positions of
# about 5 m carry about 5e-7 m of rounding) and on the capsule-box slots
# whose validity is the 1e-6 coincidence test of two f32 segment
# parameters (``ant_coincidence_rows``: the kernel's fused multiply-adds
# and the twin's separate roundings put such a flag on either side); rows
# whose flags differ are left out of the value comparison
ANT_KERNEL_TOL = 1e-9
ANT_F32_TOL = {"ant_smooth": 1e-5, "ant_rows": 2e-3, "ant_newton": 1e-4}
ANT_ACTIVE_SLACK = 1e-5
# on random contact states f32 strays from f64 in either engine: after one
# physics stage (RK4, frame_skip 3) the kernels' f32 qpos lies within
# ANT_DRIFT_FACTOR times the batched engine's f32 distance from the f64
# step (or of ANT_PHYSICS_TOL's qpos, were that larger).  Newton's 8th
# iterate is not converged: where a line search's bracket falls on one
# rounding, two f64 runs part by up to 1e-8 relative and meet again an
# iteration later (the twin on the card against the twin on the CPU, at
# 4,096 states; NVIDIA H100 80GB HBM3, 700 W).  So at 4,096 states the
# f64 gate holds Newton after ANT_NEWTON_CONVERGED iterations (converged
# to about 1e-13), and at the envs' 8 on ANT_ENGINE_STATES states
ANT_DRIFT_FACTOR = 4.0
ANT_NEWTON_CONVERGED = 16
ANT_KERNELS = ("ant_smooth", "ant_rows", "ant_newton")
ANT_KERNEL_REPLACES = {"ant_smooth": "gym_po_tpu/physics/dynamics.py:553",
                       "ant_rows": "gym_po_tpu/physics/contact.py:568",
                       "ant_newton": "gym_po_tpu/physics/contact.py:915"}


def ant_contact_states(n: int, seed: int, walls: bool):
    """``n`` standing poses in contact with the floor, perturbed (hinges,
    height, tilt, velocities, controls, warm starts), the second half pushed
    against the tag arena's walls (x or y at ±4.4) when ``walls``: numpy
    f64 (qpos, qvel, ctrl, warm)."""
    from gym_po_tpu_torch.envs.ant_physics import STAND_POSE

    rng = np.random.default_rng(seed)
    qpos = np.tile(STAND_POSE.astype(np.float64), (n, 1))
    qpos[:, :2] = rng.uniform(-3.5, 3.5, (n, 2))
    qpos[:, 2] += rng.uniform(-0.1, 0.05, n)
    qpos[:, 3:7] += rng.normal(scale=0.05, size=(n, 4))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, 8))
    if walls:
        h = n // 2
        ax = rng.integers(0, 2, h)
        qpos[np.arange(h, n), ax] = rng.choice([-4.4, 4.4], h)
    return (qpos, 0.5 * rng.normal(size=(n, 14)), rng.uniform(-1, 1, (n, 8)),
            0.1 * rng.normal(size=(n, 14)))


def ant_engine_check(dev) -> None:
    """The engine on the card against itself on the CPU at f64: one forward
    and one step (rk4, frame_skip 2, 15 iterations) of 64 contact states."""
    from gym_po_tpu_torch.physics import TAG_WALLS, make_ant_model
    from gym_po_tpu_torch.physics.engine import PhysicsState, forward, step

    model = make_ant_model(TAG_WALLS)
    arrays = ant_contact_states(ANT_ENGINE_STATES, 0, walls=True)
    on = {d: [torch.as_tensor(x, device=d) for x in arrays]
          for d in (dev, torch.device("cpu"))}
    worst = {}
    for name, fn in (
            ("forward", lambda q, v, c, w: forward(model, q, v, c, w, iters=15)),
            ("step", lambda q, v, c, w: tuple(step(
                model, PhysicsState(q, v, w), c, frame_skip=2, iters=15,
                integrator="rk4")))):
        got = [x.cpu() for x in fn(*on[dev])]
        want = fn(*on[torch.device("cpu")])
        for g, w in zip(got, want):
            err = ((g - w).abs() / w.abs().clamp_min(1.0)).max().item()
            worst[name] = max(worst.get(name, 0.0), err)
            if not err <= ANT_ENGINE_TOL:
                raise AssertionError(f"ant engine {name}: card vs CPU {err:.3e}")
    say("ant-engine", f"f64, {ANT_ENGINE_STATES} contact states (standing "
        f"poses on the floor, half against the walls), card == CPU: forward (qacc, "
        f"warm) {worst['forward']:.3e}, step rk4 frame_skip 2 iters 15 (qpos, "
        f"qvel, warm) {worst['step']:.3e} (relative to max(1, |x|); limit "
        f"{ANT_ENGINE_TOL:g})")


def ant_env_states(dev, env_id: str, seed: int = 11):
    """``B_ANT_STAGES`` states of ``env_id`` in motion (a reset and two
    steps of one random action at frame_skip ANT_STAGES_FRAME_SKIP) and
    that action."""
    import gym_po_tpu_torch as gp

    env = gp.make(env_id, frame_skip=ANT_STAGES_FRAME_SKIP, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, st = env.reset_vec(gen, B_ANT_STAGES)
    act = torch.rand(B_ANT_STAGES, 8, generator=gen, device=dev) * 2 - 1
    for _ in range(2):
        _, st, *_ = env.step_vec(gen, st, act)
    return st, act


def ant_stage_check(dev, env_id: str) -> None:
    """One env step of the card against the CPU, stage by stage, at f32:
    the physics from one state, then each task stage fed the same inputs."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.core import map_tensors

    cpu = torch.device("cpu")
    env_d, env_c = (gp.make(env_id, frame_skip=ANT_STAGES_FRAME_SKIP, device=d)
                    for d in (dev, cpu))
    st, act = ant_env_states(dev, env_id)
    gen = torch.Generator(device=dev).manual_seed(12)
    B = B_ANT_STAGES

    def c(x):
        return map_tensors(lambda t: t.to(cpu), x)

    # some envs one step from the time limit, some tags or arrivals in reach
    near = (torch.arange(B, device=dev) % 4 == 1)[:, None]
    if env_id.startswith("AntTag"):
        st = st.replace(target_xy=torch.where(near, st.qpos[:, :2] + 0.3,
                                              st.target_xy))
    else:
        sites = torch.as_tensor(HH_SITES_XY, device=dev)[torch.arange(B, device=dev) % 3]
        st = st.replace(qpos=torch.cat([torch.where(near, sites, st.qpos[:, :2]),
                                        st.qpos[:, 2:]], 1))
    st = st.replace(elapsed=torch.where(torch.arange(B, device=dev) % 5 == 0,
                                        env_d.time_limit - 1, st.elapsed))
    st_c = c(st)
    phys = env_d.physics(st.qpos, st.qvel, st.warm, act)
    phys_c = env_c.physics(st_c.qpos, st_c.qvel, st_c.warm, c(act))
    errs = {k: ((a.cpu() - b).abs() / (b.abs().clamp_min(1.0) if k == "warm"
                                       else 1.0)).max().item()
            for k, a, b in zip(("qpos", "qvel", "warm"), phys, phys_c)}
    for k, lim in ANT_PHYSICS_TOL.items():
        if not errs[k] <= lim:
            raise AssertionError(f"{env_id} physics stage: card vs CPU {k} "
                                 f"{errs[k]:.3e} > {lim}")
    if env_id.startswith("AntTag"):
        extra = (torch.randint(0, 4, (B,), generator=gen, device=dev,
                               dtype=torch.int32),)
        draws = (torch.rand(B, 2, generator=gen, device=dev),
                 torch.rand(B, 257, 2, generator=gen, device=dev))
    else:
        extra = ()
        draws = (torch.rand(B, 2, generator=gen, device=dev),
                 torch.rand(B, generator=gen, device=dev) < 0.5)
    mask = torch.arange(B, device=dev) % 3 == 0

    def stages(env, s, phys, extra, draws, mask):
        mid, rew, done, trunc = env.advance(s, *phys, *extra)
        fresh = env.fresh(*draws)
        new = env.apply_reset(mid, mask, fresh)
        return [mid, rew, done, trunc, fresh, new, env.observe(new)]

    got = stages(env_d, st, phys, extra, draws, mask)
    want = stages(env_c, st_c, c(phys), c(extra), c(draws), c(mask))
    worst = 0.0
    for g, w in zip(collect_outputs(got), collect_outputs(want)):
        g = g.cpu()
        if g.dtype.is_floating_point:
            worst = max(worst, (g - w).abs().max().item())
            ok = (g - w).abs().max().item() <= ANT_STAGE_ATOL
        else:
            ok = torch.equal(g, w)
        if not ok:
            raise AssertionError(f"{env_id}: a task stage differs, card vs CPU")
    done, trunc = got[2], got[3]
    say("ant-stages", f"{env_id} f32 B={B}, card vs CPU: physics (frame_skip "
        f"{env_d.frame_skip}, {env_d.integrator}, {env_d.solver_iters} "
        f"iterations) from one state qpos {errs['qpos']:.3e}, qvel "
        f"{errs['qvel']:.3e}, warm {errs['warm']:.3e} relative to max(1, "
        f"|x|) (limits {ANT_PHYSICS_TOL}); advance, fresh, apply_reset, observe fed the "
        f"same inputs: ints and bools exact, floats {worst:.3e} "
        f"(limit {ANT_STAGE_ATOL:g}); {int(done.sum())} tags or arrivals, "
        f"{int(trunc.sum())} truncations")


def ant_run(dev, card, env_id: str, integrator: str,
            pipeline: str = "scalar") -> None:
    """Steps of random actions at the env's defaults (B = 4,096) with
    ``pipeline``: step 0 a warm-up, steps 1-3 timed (env-steps/s from their
    median, host clock around a sync), step 4 under torch.profiler (device
    ops, busy share, peak memory).  Euler with "scalar" runs 20 steps, step
    5 under the sync debug mode at 'error' (a host sync raises); otherwise
    5 (the RK4 PPO update's collect graph holds its steps sync-free).
    With "scalar", the profiled step's device time of each ant kernel, and
    on the steps neither timed nor profiled (0, and 5 on from Euler's) the
    active rows of each env in every forward (read from the forward's rows
    buffer after it): their largest count and the share of envs above
    ``ant_newton``'s resident rows (``newton_rows_cap``; more are restaged
    in every pass).  After every
    step each qpos is finite, each torso above the floor and each ant
    inside its walls."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.ops import ant_forward as af

    env = gp.make(env_id, integrator=integrator, pipeline=pipeline, device=dev)
    forward, seen = af.forward, []

    def recorded(model, qpos, *args):
        out = forward(model, qpos, *args)
        rows = af._plan(model, qpos.dtype, qpos.device).batch(qpos.shape[0])[1]
        n = rows.active.sum(0)
        seen.append(torch.stack([n.max(), (n > af.newton_rows_cap()).sum().to(n.dtype)]))
        return out

    gen = torch.Generator(device=dev).manual_seed(3)
    _, st = env.reset_vec(gen, B_ANT)
    (x_lo, x_hi), (y_lo, y_hi) = ANT_ARENA[env_id]
    n_steps = (ANT_STEPS if integrator == "euler" and pipeline == "scalar"
               else ANT_TIMED + 2)
    times, resets, z = [], 0, []
    for i in range(n_steps):
        act = torch.rand(B_ANT, 8, generator=gen, device=dev) * 2 - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == ANT_TIMED + 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kept = {}
            n_ops, busy, top = device_ops(
                lambda: kept.update(out=env.step_vec(gen, st, act)), top=10**4)
            out = kept["out"]
            peak = torch.cuda.max_memory_allocated() - base
            ops = (f"{n_ops} device ops per env step, device busy {busy:.3f} "
                   f"ms = {busy / statistics.median(times):.4f} of the step"
                   if n_ops else "device ops: not measured (no device events "
                   "in the trace)") + f"; peak memory of a step {peak / 2**20:.1f} MiB"
            if n_ops and pipeline == "scalar":
                kern = {k: [(c, ms) for name, c, ms in top if f"{k}_kernel" in name]
                        for k in ANT_KERNELS}
                k_ms = sum(ms for v in kern.values() for _, ms in v)
                ops += ("; in its trace " + ", ".join(
                    f"{k} {sum(c for c, _ in v)} launches {sum(ms for _, ms in v):.3f} ms"
                    for k, v in kern.items())
                    + f", together {k_ms:.3f} ms = {k_ms / busy:.4f} of the busy time")
        else:
            if pipeline == "scalar" and not 1 <= i <= ANT_TIMED:
                af.forward = recorded
            if i == ANT_TIMED + 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = env.step_vec(gen, st, act)
            finally:
                af.forward = forward
                torch.cuda.set_sync_debug_mode("default")
            if i == ANT_TIMED + 2:
                ops += "; step 5 under set_sync_debug_mode('error'): no host sync"
        torch.cuda.synchronize()
        if 1 <= i <= ANT_TIMED:
            times.append((time.perf_counter() - t0) * 1e3)
        _, st, rew, done, trunc, info = out
        q = info["terminal_state"].qpos
        if not torch.isfinite(q).all():
            raise AssertionError(f"{env_id}: non-finite qpos")
        if not (q[:, 2] > 0).all():
            raise AssertionError(f"{env_id}: a torso under the floor")
        inside = ((q[:, 0] > x_lo) & (q[:, 0] < x_hi)
                  & (q[:, 1] > y_lo) & (q[:, 1] < y_hi))
        if not inside.all():
            raise AssertionError(f"{env_id}: an ant outside its walls")
        resets += int(info["reset_mask"].sum())
        z += [float(q[:, 2].min()), float(q[:, 2].max())]
    med = statistics.median(times)
    if seen:
        most, above = torch.stack(seen).amax(0)[0], torch.stack(seen)[:, 1].sum()
        ops += (f"; {len(seen)} forwards of the untimed steps: at most "
                f"{int(most)} active rows an env, {int(above)} of "
                f"{len(seen) * B_ANT} envs ({float(above) / (len(seen) * B_ANT):.6f}) "
                f"above the {af.newton_rows_cap()} held resident")
    say("ant-speed", f"{env_id} {integrator} pipeline {pipeline} B={B_ANT} "
        f"frame_skip {env.frame_skip} iters {env.solver_iters} ls "
        f"{env.ls_iters} f32 on {card}: {B_ANT / med * 1e3:.6e} env-steps/s "
        f"({med:.3f} ms/step, median of {', '.join(f'{t:.3f}' for t in times)}); "
        f"{ops}")
    say("ant-rollout", f"{env_id} {integrator} {pipeline} B={B_ANT}, {n_steps} steps of "
        f"random actions: qpos finite, torso z in [{min(z):.4f}, "
        f"{max(z):.4f}], every ant inside x in ({x_lo}, {x_hi}), "
        f"y in ({y_lo}, {y_hi}); {resets} resets")


def chol_solve_unrolled(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``H x = g`` by a Cholesky factorisation and two substitutions
    unrolled over the columns, each step one batched torch op (the JAX
    package's trace-time unrolled form, in array ops): timed beside the
    engine's solve, and used nowhere in the port."""
    n = H.shape[-1]
    L = torch.zeros_like(H)
    for j in range(n):
        s = H[..., j:, j]
        if j:
            s = s - (L[..., j:, :j] * L[..., j:j + 1, :j]).sum(-1)
        L[..., j:, j] = s / torch.sqrt(s[..., :1])
    y = torch.zeros_like(g)
    for i in range(n):
        s = g[..., i]
        if i:
            s = s - (L[..., i, :i] * y[..., :i]).sum(-1)
        y[..., i] = s / L[..., i, i]
    x = torch.zeros_like(g)
    for i in reversed(range(n)):
        s = y[..., i]
        if i < n - 1:
            s = s - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)
        x[..., i] = s / L[..., i, i]
    return x


def ant_cholesky_routes(dev, card) -> None:
    """The engine's 14x14 solve (``linalg.chol_solve``) and the unrolled one
    on the card, on the batch of one M per env at B = 4,096 (CUDA
    events)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.physics import dynamics, linalg

    env = gp.make(ANT_IDS[0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    _, st = env.reset_vec(gen, B_ANT)
    act = torch.rand(B_ANT, 8, generator=gen, device=dev) * 2 - 1
    _, M, _, qfrc = dynamics.smooth_forward(env.model, st.qpos, st.qvel, act)
    routes = {"library": linalg.chol_solve, "unrolled": chol_solve_unrolled}
    x = {r: fn(M, qfrc) for r, fn in routes.items()}
    agree = (x["library"] - x["unrolled"]).abs().max().item()
    solve = {r: event_windows(lambda i, fn=fn: fn(M, qfrc), 3, 20)
             for r, fn in routes.items()}
    say("ant-cholesky", f"B={B_ANT} f32 on {card}: one solve, library "
        f"(cholesky_ex + 2 solve_triangular) {solve['library']:.4f} ms, "
        f"unrolled {solve['unrolled']:.4f} ms (CUDA events, median of 3 "
        f"windows of 20); routes agree to {agree:.3e}; the engine takes the "
        "library's")


def ant_ppo(dev, card, integrator: str, T: int, pipeline: str = "scalar") -> None:
    """One PPO update on AntTagPhysics-v0 with ``pipeline`` (the env's
    other knobs at their defaults), B = 4,096, E = M = 4, after the first
    (the collect graph's capture), split into collect and learn by CUDA
    events."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo

    env = gp.make(ANT_IDS[0], integrator=integrator, pipeline=pipeline,
                  device=dev)
    cfg = ppo.PPOConfig(num_envs=B_ANT, rollout_steps=T)
    model, ts = ppo.init_train_state(env, cfg,
                                     torch.Generator(device=dev).manual_seed(0))
    step = ppo.make_train_step(env, model, cfg)
    t0 = time.perf_counter()
    ts, m = step(ts)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts, m = step(ts)
    collect_ms, learn_ms = ppo.halves_ms(step)
    wall = time.perf_counter() - t0
    if not torch.isfinite(ts.env_obs).all():
        raise AssertionError("ant PPO: non-finite observations")
    say("ant-ppo", f"{ANT_IDS[0]} ({env.integrator}, {pipeline}, frame_skip "
        f"{env.frame_skip}) B={B_ANT} T={T} E={cfg.epochs} "
        f"M={cfg.minibatches} hidden {cfg.hidden} on {card}: first update "
        f"(graph capture) {first:.3f} s; update 2 {wall * 1e3:.3f} ms (CUDA "
        f"events: collect {collect_ms:.3f} ms, learn {learn_ms:.3f} ms), "
        f"{B_ANT * T / wall:.6e} PPO env-steps/s; {ppo_metrics_line(m)}")


def ant_ppo_multi(dev, card) -> None:
    """The multi step against single updates (:func:`ppo_multi_check`) on
    AntTagPhysics-v0 at its defaults (RK4), B = 4,096, T = 2."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo

    env = gp.make(ANT_IDS[0], device=dev)
    cfg = ppo.PPOConfig(num_envs=B_ANT, rollout_steps=2)
    ppo_multi_check(dev, card, env, cfg, f"{ANT_IDS[0]} ({env.integrator}, "
                    f"frame_skip {env.frame_skip}) B={B_ANT} T=2",
                    phase="ant-ppo-multi")


def ant_train(dev, card) -> None:
    """``train()`` on AntHeavenHellPhysics-v0 (ANT_TRAIN_HH), a history row
    an update through the multi step: every metric and observation finite."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo

    integrator, T, n = ANT_TRAIN_HH
    env = gp.make(ANT_IDS[1], integrator=integrator, device=dev)
    cfg = ppo.PPOConfig(num_envs=B_ANT, rollout_steps=T)
    t0 = time.perf_counter()
    _, ts, history = ppo.train(env, cfg, seed=0, num_updates=n, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ts.update_idx != n or len(history) != n:
        raise AssertionError(f"{ANT_IDS[1]} train: wrong history")
    if not torch.isfinite(ts.env_obs).all():
        raise AssertionError(f"{ANT_IDS[1]} train: non-finite observations")
    lines = [ppo_metrics_line(h) for h in history]
    say("ant-train", f"train() on {ANT_IDS[1]} ({integrator}, frame_skip "
        f"{env.frame_skip}) B={B_ANT} T={T} E={cfg.epochs} M={cfg.minibatches} "
        f"on {card}: {n} updates through make_multi_train_step(1), each a "
        f"replay of one UpdateGraph, {wall:.3f} s with the capture; last row "
        f"{lines[-1]}")


def ant_rnn_ppo(dev, card) -> None:
    """GRU-PPO (width 128) on AntTagPhysics-v0 (ANT_RNN), B = 4,096: the
    first update (the collect graph's capture) and one more, timed; every
    metric, observation and hidden value finite."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo, ppo_rnn

    integrator, T = ANT_RNN
    env = gp.make(ANT_IDS[0], integrator=integrator, device=dev)
    cfg = ppo.PPOConfig(num_envs=B_ANT, rollout_steps=T)
    model, ts = ppo_rnn.init_rnn_state(env, cfg,
                                       torch.Generator(device=dev).manual_seed(0))
    step = ppo_rnn.make_rnn_train_step(env, model, cfg)
    t0 = time.perf_counter()
    ts, m = step(ts)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    ppo_metrics_line(m)
    label = f"{ANT_IDS[0]} ({integrator}, frame_skip {env.frame_skip}) GRU 128"
    ts, m, *_ = rnn_update(ppo, step, ts, card, label, B_ANT, T)
    if not torch.isfinite(ts.env_obs).all():
        raise AssertionError(f"{label}: non-finite observations")
    say("ant-rnn", f"{label} B={B_ANT} T={T} E={cfg.epochs} M={cfg.minibatches}: "
        f"first update (the collect graph's capture) {first:.3f} s; the second "
        "above; metrics, observations and hidden state finite")


def ant_render_check(dev, card, env_id: str) -> None:
    """``render_ant`` of 4 rows of a B = 4,096 card state after one Euler
    step: the frame of the state's CPU copy pixel for pixel, through
    ``render`` too, with the torso, walls and legs drawn; the card's f64
    ``fk`` of those rows against the renderer's NumPy FK; ms per frame
    (host clock, median of 3 renders after a warm-up)."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.core import map_tensors
    from gym_po_tpu_torch.physics.dynamics import fk
    from gym_po_tpu_torch.render import COLORS, render, render_ant
    from gym_po_tpu_torch.render.renderers import _np_fk

    env = gp.make(env_id, integrator="euler", device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    _, st = env.reset_vec(gen, B_ANT)
    act = torch.rand(B_ANT, 8, generator=gen, device=dev) * 2 - 1
    _, st, *_ = env.step_vec(gen, st, act)
    torch.cuda.synchronize()
    rows = list(ANT_RENDER_ROWS)
    render_ant(env, st, rows)
    times = []
    for _ in range(ANT_TIMED):
        t0 = time.perf_counter()
        img = render_ant(env, st, rows)
        times.append((time.perf_counter() - t0) * 1e3)
    host = map_tensors(lambda t: t.cpu(), st)
    if not (np.array_equal(img, render_ant(env, host, rows))
            and np.array_equal(img, render(env, st, rows))):
        raise AssertionError(f"{env_id}: the card state's frame differs "
                             "from its CPU copy's")
    drawn = {tuple(c) for c in np.unique(img.reshape(-1, 3), axis=0)}
    if not {COLORS["agent"], COLORS["wall"], (150, 110, 60)} <= drawn:
        raise AssertionError(f"{env_id}: no torso, walls or legs in the frame")
    q = st.qpos[rows].double()
    xpos, _, xmat = fk(env.model, q)
    q = q.cpu().numpy()
    err = 0.0
    for k in range(len(rows)):
        p, m = _np_fk(env.model, q[k])
        err = max(err, float(np.abs(xpos[k].cpu().numpy() - p).max()),
                  float(np.abs(xmat[k].cpu().numpy() - m).max()))
    if not err <= ANT_RENDER_FK_TOL:
        raise AssertionError(f"{env_id}: card fk vs NumPy FK {err:.3e}")
    med = statistics.median(times)
    say("ant-render", f"{env_id}: render_ant of {len(rows)} rows of a "
        f"B={B_ANT} card state after one Euler step, {img.shape} uint8: the "
        f"CPU copy's frame pixel for pixel (render() too), torso, walls and "
        f"legs drawn; card f64 fk vs the renderer's NumPy FK {err:.3e} (limit "
        f"{ANT_RENDER_FK_TOL:g}); {med / len(rows):.3f} ms per frame on the "
        f"host (median of {', '.join(f'{t:.3f}' for t in times)} ms for "
        f"{len(rows)}; {card})")


def ant_batch_scan(dev, card) -> None:
    """Whether the card loses env-steps/s above B = 4,096 on the ant
    (the TPU's reason for ``vector/chunked.py``): on AntTagPhysics-v0,
    Euler, the env's other knobs at their defaults, one ``step_vec`` at
    B = 16,384 against ``make_chunked_step(env, 4096)`` on another
    B = 16,384 state (four ``step_vec`` calls of 4,096 rows each).  A
    warm-up of each, then 3 timed rounds of both in turn (host clock
    around a sync); peak memory of the single step."""
    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.vector import make_chunked_step

    env = gp.make(ANT_IDS[0], integrator="euler", device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    n = ANT_SCAN_CHUNKS
    st = {"one": env.reset_vec(gen, B_ANT_SCAN)[1],
          "four": env.reset_vec(gen, B_ANT_SCAN)[1]}
    act = torch.rand(B_ANT_SCAN, 8, generator=gen, device=dev) * 2 - 1
    chunked = make_chunked_step(env, B_ANT)

    def one():
        st["one"] = env.step_vec(gen, st["one"], act)[1]

    def four():
        st["four"] = chunked(gen, st["four"], act)[1]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(one)
    timed(four)
    times = {"one": [], "four": []}
    for r in range(ANT_TIMED):
        if r == 0:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        times["one"].append(timed(one))
        if r == 0:
            peak = torch.cuda.max_memory_allocated() - base
        times["four"].append(timed(four))
    rate = {"one": B_ANT_SCAN / statistics.median(times["one"]),
            "four": n * B_ANT / statistics.median(times["four"])}
    ratio = rate["one"] / rate["four"]
    verdict = ("no cliff: chunking is no speed remedy on the card"
               if ratio >= ANT_NO_CLIFF else
               "a cliff: chunked steps outrun the single step")
    say("ant-batch-scan", f"{ANT_IDS[0]} euler frame_skip {env.frame_skip} "
        f"iters {env.solver_iters} f32 on {card}: one step_vec at "
        f"B={B_ANT_SCAN} {rate['one']:.6e} env-steps/s (s: "
        f"{', '.join(f'{t:.4f}' for t in times['one'])}), make_chunked_step: "
        f"{n} chunks of B={B_ANT} {rate['four']:.6e} env-steps/s (s: "
        f"{', '.join(f'{t:.4f}' for t in times['four'])}); ratio "
        f"{ratio:.4f} (no cliff at >= {ANT_NO_CLIFF}): {verdict}; peak "
        f"memory of the B={B_ANT_SCAN} step {peak / 2**20:.1f} MiB")


def _ant_models():
    from gym_po_tpu_torch.physics import HEAVEN_HELL_WALLS, TAG_WALLS, make_ant_model

    return {ANT_IDS[0]: make_ant_model(TAG_WALLS),
            ANT_IDS[1]: make_ant_model(HEAVEN_HELL_WALLS)}


def _rel_abs(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(largest error relative to max(1, |want|), largest absolute error)."""
    d = (got - want).abs()
    return (d / want.abs().clamp_min(1.0)).max().item(), d.max().item()


def ant_row_margin(model, skin: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
    """``[ne, B]``: how far each row lies from its activation threshold
    (a limit row its hinge's distance to the nearer bound, a contact row
    its candidate's distance less the pair margin; a row is active below
    0), from the kinematics in ``skin`` by the plain path."""
    from gym_po_tpu_torch.ops import ant_forward as af
    from gym_po_tpu_torch.physics import contact, dynamics

    t = dynamics.model_tensors(model, qpos.dtype, qpos.device)
    q_j = qpos[:, t.jnt_qpos]
    lim = torch.minimum(q_j - t.jnt_lo, t.jnt_hi - q_j)
    dist, _, _ = contact.candidates(model, af._skin_kinematics(model, skin))
    cont = torch.repeat_interleave(dist - 2.0 * model.margin, 4, dim=1)
    return torch.cat([lim, cont], 1).T


def ant_coincidence_rows(model) -> np.ndarray:
    """``[ne]`` bool: the rows of each capsule's second and third
    capsule-box slot, which hold a contact only where the segment's first
    and last minimizing parameters differ by more than 1e-6 (the second)
    or do not (the third).  At f32 that test can fall either way for one
    pose: a kernel and its twin, which round differently, may then
    disagree on these rows' active flags."""
    from gym_po_tpu_torch.ops import ant_forward as af
    from gym_po_tpu_torch.physics import contact

    n_slots = len(contact._wall_slots(model.walls))
    kind = [(c - af.NFLOOR) % af.NSLOT_CAND
            for c in range(af.NFLOOR + af.NSLOT_CAND * n_slots)]
    cand = [c >= af.NFLOOR and k > 0 and (k - 1) % 3 > 0 for c, k in enumerate(kind)]
    return np.concatenate([np.zeros(af.NJ, bool), np.repeat(cand, 4)])


def ant_scalar_check(dev) -> None:
    """Each ant kernel against its plain twin on the card at f64 on the
    same inputs (contact states of each arena, ``ant_contact_states``; 10
    bisections; the launches not counted): ``ant_smooth`` on (qpos,
    qvel, ctrl), ``ant_rows`` on the kernel's kinematics, ``ant_newton``
    on the kernel's M, qacc_smooth and rows, from the warm start.  M,
    qacc_smooth, the kinematics, the rows densified through the support
    table (against the twin's whole Jacobian), aref, r, qacc and warm
    within ANT_KERNEL_TOL, the active flags equal: on ANT_ENGINE_STATES
    states after the envs' 8 Newton iterations, and on B_ANT states after
    ANT_NEWTON_CONVERGED (the 8th iterate's error at B_ANT printed beside
    the twin's own, on the card against on the CPU).
    Then at f32 one physics stage (RK4, frame_skip 3):
    "scalar" against "array" from the stage check's states of the env in
    motion (``ant_env_states``) within ANT_PHYSICS_TOL; and on
    ANT_ENGINE_STATES random contact states each pipeline's f32 qpos
    against the f64 step, the kernels' distance within ANT_DRIFT_FACTOR
    of the batched engine's."""
    from gym_po_tpu_torch.ops import ant_forward as af
    from gym_po_tpu_torch.physics.engine import PhysicsState, step

    lines = []
    for env_id, model in _ant_models().items():
        f64 = []
        for n, iters in ((ANT_ENGINE_STATES, 8), (B_ANT, ANT_NEWTON_CONVERGED)):
            q, v, c, w = (torch.as_tensor(x, device=dev)
                          for x in ant_contact_states(n, 7, walls=True))
            with uncounted():
                sm = af.ant_smooth(model, q, v, c)
                rows = af.ant_rows(model, sm.skin, q, v)
                got = {k: af.ant_newton(model, sm, rows, w, iters=k, ls_iters=10)
                       for k in {8, iters}}
            tw = af.smooth_twin(model, q, v, c)
            rt = af.rows_twin(model, sm.skin, q, v)
            full = af._contact.constraint_rows(
                model, af._skin_kinematics(model, sm.skin), q, v)
            want = {k: af.newton_twin(model, sm, rows, w, iters=k, ls_iters=10)
                    for k in got}
            errs = {"ant_smooth": [_rel_abs(g, t) for g, t in zip(sm, tw)],
                    "ant_rows": [_rel_abs(af.dense_rows(model, rows).jac, full.jac),
                                 _rel_abs(rows.aref, rt.aref),
                                 _rel_abs(rows.r, rt.r)],
                    "ant_newton": [_rel_abs(g, t)
                                   for g, t in zip(got[iters], want[iters])]}
            for k, e in errs.items():
                r_max = max(x[0] for x in e)
                if not r_max <= ANT_KERNEL_TOL:
                    raise AssertionError(f"{k} vs twin, {env_id} f64, {n} "
                                         f"states: {r_max:.3e}")
            if not torch.equal(rows.active, rt.active):
                raise AssertionError(f"ant_rows vs twin, {env_id} f64: "
                                     f"{int((rows.active != rt.active).sum())} "
                                     "active flags differ")
            line = (f"{n} states ({rt.active.sum().item() / n:.2f} active rows "
                    "a state) " + ", ".join(
                        f"{k} {max(x[0] for x in e):.3e}" for k, e in errs.items())
                    + f" ({iters} iterations)")
            if iters != 8:
                on_cpu = af.newton_twin(model, af.Smooth(*(x.cpu() for x in sm)),
                                        af.Rows(*(x.cpu() for x in rows)),
                                        w.cpu(), iters=8, ls_iters=10)
                spread = max(_rel_abs(t.cpu(), u)[0] for t, u in zip(want[8], on_cpu))
                per_env = torch.stack([((g - t).abs() / t.abs().clamp_min(1.0)).amax(1)
                                       for g, t in zip(got[8], want[8])]).amax(0)
                line += (f", at 8 iterations ant_newton {per_env.max().item():.3e} "
                         f"({int((per_env > ANT_KERNEL_TOL).sum())} states beyond "
                         f"{ANT_KERNEL_TOL:g}), the twin on the card vs on the "
                         f"CPU {spread:.3e}")
            f64.append(line)
        f64 = f"{env_id} f64: " + "; ".join(f64)
        # f32: scalar vs array on the env in motion
        st, act = ant_env_states(dev, env_id)
        out = {p: step(model, PhysicsState(st.qpos, st.qvel, st.warm), act,
                       frame_skip=ANT_STAGES_FRAME_SKIP, iters=8, pipeline=p)
               for p in ("scalar", "array")}
        stage = {}
        for k, (name, lim) in enumerate(ANT_PHYSICS_TOL.items()):
            g, t = out["scalar"][k], out["array"][k]
            stage[name] = ((g - t).abs() / (t.abs().clamp_min(1.0)
                                            if name == "warm" else 1.0)).max().item()
            if not (torch.isfinite(g).all() and stage[name] <= lim):
                raise AssertionError(f"{env_id} f32 physics stage, scalar vs "
                                     f"array: {name} {stage[name]:.3e} > {lim}")
        # f32 against f64 on random contact states, either pipeline
        q, v, c, w = (torch.as_tensor(x, device=dev) for x in
                      ant_contact_states(ANT_ENGINE_STATES, 7, walls=True))

        def stage_qpos(dtype, p):
            return step(model, PhysicsState(q.to(dtype), v.to(dtype), w.to(dtype)),
                        c.to(dtype), frame_skip=ANT_STAGES_FRAME_SKIP, iters=8,
                        pipeline=p).qpos.double()

        ref = stage_qpos(torch.float64, "array")
        drift = {p: (stage_qpos(torch.float32, p) - ref).abs().max().item()
                 for p in ("scalar", "array")}
        lim = ANT_DRIFT_FACTOR * max(drift["array"], ANT_PHYSICS_TOL["qpos"])
        if not drift["scalar"] <= lim:
            raise AssertionError(f"{env_id}: the kernels' f32 qpos lies "
                                 f"{drift['scalar']:.3e} from f64, the batched "
                                 f"engine's {drift['array']:.3e} (limit {lim:.3e})")
        lines.append(f"{f64}; f32 physics stage rk4 frame_skip 3, scalar vs "
                     "array on the env in motion " + ", ".join(
                         f"{k} {x:.3e}" for k, x in stage.items())
                     + f"; f32 vs f64 qpos on {ANT_ENGINE_STATES} random contact "
                     f"states: scalar {drift['scalar']:.3e}, array "
                     f"{drift['array']:.3e} (limit {lim:.3e})")
    say("ant-kernels", f"each kernel vs its twin on the card at f64 on "
        f"contact states, relative to max(1, |x|) (limit {ANT_KERNEL_TOL:g}); "
        f"f32 gates {ANT_PHYSICS_TOL}, drift factor {ANT_DRIFT_FACTOR:g}: "
        + "; ".join(lines))


def ant_f32_errs(model, dev, q, v, c, w, sm, rows, got) -> tuple:
    """The f32 kernels' outputs ``sm``, ``rows``, ``got`` (qacc, warm)
    against their twins' on the same inputs: ``({kernel: (largest error
    relative to max(1, |x|), largest absolute error)}, flags that
    differ)``.  Raises where a flag differs off the slack or a kernel
    exceeds ANT_F32_TOL (rows whose flags differ left out)."""
    from gym_po_tpu_torch.ops import ant_forward as af

    p = af._plan(model, torch.float32, dev)
    tw = af.smooth_twin(model, q, v, c)
    rt = af.rows_twin(model, sm.skin, q, v)
    want = af.newton_twin(model, sm, rows, w, iters=8, ls_iters=10)
    differ = rows.active != rt.active
    coincide = torch.as_tensor(ant_coincidence_rows(model), device=dev)[:, None]
    far = (differ & ~coincide
           & (ant_row_margin(model, sm.skin, q).abs() > ANT_ACTIVE_SLACK))
    if far.any():
        raise AssertionError(f"ant_rows vs twin, f32: {int(far.sum())} active "
                             f"flags differ farther than {ANT_ACTIVE_SLACK} from "
                             "a threshold, off the coincidence slots")

    def kept(g, t, same):
        return _rel_abs(torch.where(same, g, t), t)

    parts = {"ant_smooth": [_rel_abs(g, t) for g, t in zip(sm, tw)],
             "ant_rows": [kept(rows.vals, rt.vals, ~differ[p.row]),
                          kept(rows.aref, rt.aref, ~differ),
                          kept(rows.r, rt.r, ~differ)],
             "ant_newton": [_rel_abs(g, t) for g, t in zip(got, want)]}
    errs = {k: (max(x[0] for x in e), max(x[1] for x in e))
            for k, e in parts.items()}
    for k, (rel, _) in errs.items():
        if not rel <= ANT_F32_TOL[k]:
            raise AssertionError(f"{k} vs twin, f32 B={q.shape[0]}: {rel:.3e} "
                                 f"> {ANT_F32_TOL[k]}")
    return errs, int(differ.sum())


def ant_kernel_bounds(model, p, rows, iters: int, ls_iters: int) -> dict:
    """Each ant kernel's bound at f32 on this batch (``p`` the kernels'
    plan, ``rows`` the batch's rows): bytes, each input read once and
    each output written once (the solve reads M over the lower triangle of
    its static support, ``mass_support``, the active flags of every row and
    the support values, aref and R of the active rows only), and
    a lower bound of f32 arithmetic instructions (an FMA one): smooth, 7
    a mass-matrix dof pair, the factor's NV^3/6 and the solve's NV^2;
    rows, 40 a candidate, one a support entry and 2 x 10 bisection steps
    of 9 a capsule and wall slot; Newton, each iteration the mass matrix
    products, the factor and solve, 2 a support entry of an active row
    and 3 an active row a bisection step."""
    from gym_po_tpu_torch.ops import ant_forward as af

    NV, B = af.NV, rows.active.shape[1]
    dof_mask = np.asarray(model.dof_mask)
    pairs = int(sum(n * (n + 1) // 2 for n in dof_mask.sum(1).astype(int)))
    nc = (p.ne - 8) // 4
    row_ptr = p.tables[:p.ne + 1].long()
    size = (row_ptr[1:] - row_ptr[:-1]).to(rows.active.dtype)
    active = rows.active.sum().item()
    active_entries = (size[:, None] * rows.active).sum().item()
    m_sup = int(sum(bin(int(x)).count("1") for x in
                    p.tables[p.ne + 1 + p.nnz:].tolist()))
    m_low = int(np.tril(af.mass_support(model)).sum())
    work = {
        "ant_smooth": (4 * B * (af.NQ + NV + af.NU + NV * NV + NV + af.SKIN),
                       B * (7 * pairs + NV ** 3 // 6 + NV * NV)),
        "ant_rows": (4 * B * (af.SKIN + af.NQ + NV + p.nnz + 3 * p.ne),
                     B * (40 * nc + p.nnz + 180 * af.NCAP * p.n_slots)),
        "ant_newton": (4 * (B * (m_low + NV + NV + p.ne + 2 * NV)
                            + active_entries + 2 * active),
                       iters * (B * (2 * m_sup + NV ** 3 // 6 + NV * NV)
                                + 2 * active_entries + 3 * ls_iters * active)),
    }
    return {k: bound(nbytes, {"fp32": ops, "issue": ops})
            for k, (nbytes, ops) in work.items()}


def ant_kernel_times(dev, card) -> tuple:
    """Each ant kernel and its twin at the main path's shapes: B = 4,096
    f32, 8 iterations and 10 bisections, on contact states of each arena
    (``ant_contact_states``; CUDA events, the kernel's median of 3 windows
    of 20 launches into the same buffers, the twin's of 3 windows of 2;
    not counted); the timed launches' outputs held against the twins' on
    the same inputs (``ant_f32_errs``).  Returns the tag arena's {kernel:
    (ms, plain ms, bound)} and {kernel: (relative, absolute error)}, the
    record's."""
    from gym_po_tpu_torch.ops import ant_forward as af

    out, out_errs, lines = {}, {}, []
    for env_id, model in _ant_models().items():
        q, v, c, w = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                      for x in ant_contact_states(B_ANT, 21, walls=True))
        p = af._plan(model, torch.float32, dev)
        with uncounted():
            sm = af.ant_smooth(model, q, v, c)
            rows = af.ant_rows(model, sm.skin, q, v)
            ms = {"ant_smooth": event_windows(
                      lambda i: af.ant_smooth(model, q, v, c, out=sm), 3, 20),
                  "ant_rows": event_windows(
                      lambda i: af.ant_rows(model, sm.skin, q, v, out=rows), 3, 20),
                  "ant_newton": event_windows(
                      lambda i: af.ant_newton(model, sm, rows, w, 8, 10), 3, 20)}
            got = af.ant_newton(model, sm, rows, w, 8, 10)
        errs, n_differ = ant_f32_errs(model, dev, q, v, c, w, sm, rows, got)
        plain = {"ant_smooth": event_windows(
                     lambda i: af.smooth_twin(model, q, v, c), 3, 2),
                 "ant_rows": event_windows(
                     lambda i: af.rows_twin(model, sm.skin, q, v), 3, 2),
                 "ant_newton": event_windows(
                     lambda i: af.newton_twin(model, sm, rows, w, 8, 10), 3, 2)}
        bounds = ant_kernel_bounds(model, p, rows, 8, 10)
        held = sum(t.numel() * t.element_size()
                   for part in p.batch(B_ANT) for t in part)
        na = rows.active.sum(0)
        lines.append(f"{env_id} ({p.ne} rows, {p.nnz} support entries, "
                     f"{len(p.units)} ant_rows units, {na.mean().item():.2f} "
                     f"active a state (at most {int(na.max().item())}), "
                     f"buffers {held / 2**20:.1f} MiB, ant_newton's shared "
                     f"memory {af.newton_smem_bytes(model, torch.float32)} B "
                     "a block): "
                     + ", ".join(f"{k} {ms[k]:.4f} ms (twin {plain[k]:.3f}, "
                                 f"bound {bounds[k][0]:.4f} by {bounds[k][1]}; "
                                 f"vs twin {errs[k][0]:.3e} relative, "
                                 f"{errs[k][1]:.3e} absolute)"
                                 for k in ANT_KERNELS)
                     + f"; {n_differ} active flags differ, within "
                     f"{ANT_ACTIVE_SLACK:g} of a threshold or on the "
                     "coincidence slots")
        if env_id == ANT_IDS[0]:
            out = {k: (ms[k], plain[k], bounds[k]) for k in ANT_KERNELS}
            out_errs = errs
    say("ant-kernel-times", f"B={B_ANT} f32 on {card}, CUDA events; the "
        f"timed outputs vs the twins' relative to max(1, |x|) (limits "
        f"{ANT_F32_TOL}): " + "; ".join(lines))
    return out, out_errs


def ptxas_summary(log: str) -> str:
    """Each kernel entry of an nvcc ``-Xptxas=-v`` log: its registers,
    stack frame, spills and static shared memory (a kernel named by its
    function and type: ``ant_newton_kernel<f>``; its build that counts the
    active rows ``ant_newton_kernel<f, counted>``)."""
    out, name, frame = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(ant_\w+?_kernel)I([fd])", m.group(1))
            counted = ", counted" if "Lb1E" in m.group(1) else ""
            name = f"{k.group(1)}<{k.group(2)}{counted}>" if k else m.group(1)[:40]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"{m.group(1)} B stack frame, {m.group(2)} B spill "
                     f"stores, {m.group(3)} B spill loads")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name} {m.group(1)} registers, {frame}, "
                       f"{smem.group(1) if smem else 0} B static shared memory")
            name, frame = None, "?"
    return "; ".join(out)


def ant_path(dev, card, record: bool = False) -> tuple:
    """Path 9: the articulated ant (engine and both task envs, PPO on the
    ant, the renderer of a card state, the batch scan).  The kernels'
    checks and times first; then, counted, the envs' rates, PPO (single
    updates, the multi step against them, ``train()`` on the heaven-hell
    env) and GRU-PPO with their default ``pipeline="scalar"`` (the three
    ant kernels); then one
    Euler run of the tag env with ``"array"`` (the batched engine, the
    dryrun's pipeline), the renderer and the batch scan.  ``record`` adds
    the rest of ``"array"``'s rates and PPO updates and the 14x14 solve's
    routes (PERF.md's record of the batched engine).  Returns the counted
    launches and each kernel's errors and times at the timed shape."""
    import importlib.util

    from gym_po_tpu_torch.ops._build import LAUNCHES

    t_path = time.perf_counter()
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("triton", "mujoco", "gymnasium", "pygame")}
    say("modules", "this machine has " + ", ".join(
        f"{m} {'yes' if v else 'no'}" for m, v in found.items()))
    errs, times, spent = {}, {}, []

    def run(phases):
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            spent.append(f"{name} {time.perf_counter() - t0:.1f}")

    def kernel_times():
        t, e = ant_kernel_times(dev, card)
        times.update(t)
        errs.update(e)

    with uncounted():
        run([("kernels", lambda: ant_scalar_check(dev)),
             ("kernel times", kernel_times),
             ("engine", lambda: ant_engine_check(dev))]
            + [(f"stages {e}", lambda e=e: ant_stage_check(dev, e)) for e in ANT_IDS])
    LAUNCHES.clear()
    run([(f"{e} {i}", lambda e=e, i=i: ant_run(dev, card, e, i))
         for e in ANT_IDS for i in ("rk4", "euler")]
        + [(f"ppo {i}", lambda i=i, T=T: ant_ppo(dev, card, i, T))
           for i, T in ANT_PPO]
        + [("ppo multi rk4", lambda: ant_ppo_multi(dev, card)),
           ("train heaven-hell", lambda: ant_train(dev, card)),
           ("gru ppo", lambda: ant_rnn_ppo(dev, card))])
    counted = LAUNCHES.copy()
    array = [(e, i) for e in ANT_IDS for i in ("rk4", "euler")
             if record or (e, i) == (ANT_IDS[0], "euler")]
    run([(f"{e} {i} array", lambda e=e, i=i: ant_run(dev, card, e, i, "array"))
         for e, i in array]
        + ([(f"ppo {i} array", lambda i=i, T=T: ant_ppo(dev, card, i, T, "array"))
            for i, T in ANT_PPO]
           + [("cholesky", lambda: ant_cholesky_routes(dev, card))]
           if record else [])
        + [(f"render {e}", lambda e=e: ant_render_check(dev, card, e))
           for e in ANT_IDS]
        + [("batch scan", lambda: ant_batch_scan(dev, card))])
    say("ant", f"path 9 took {time.perf_counter() - t_path:.2f} s ("
        + ", ".join(spent) + " s)")
    return counted, errs, times


def block_ops(full: float, part: float = 0) -> dict:
    """Slots by pipe of ``full`` Philox blocks of which three or four words
    are used and ``part`` of which words 0-1 alone are (one product and one
    XOR fewer in round 10)."""
    products, xors = 16 * full + 15 * part, 18 * full + 17 * part
    return {"fma": WIDE_PRODUCT_FMA_SLOTS * products, "alu": xors,
            "issue": products + xors}


def philox_ops(n_sites: int, steps: float, terms: float = 0) -> dict:
    """Slots by pipe of ``steps`` env-steps that draw ``n_sites`` Philox
    words each, and of ``terms`` applied update terms."""
    full, part = divmod(n_sites, 4)
    ops = block_ops((full + (part == 3)) * steps, (0 < part < 3) * steps)
    ops["issue"] += TERM_ISSUE * terms
    return ops


def normal_ops(n: float) -> dict:
    """Slots by pipe of ``n`` Box-Muller normals' logf, cosf and sqrtf."""
    return {pipe: slots * n for pipe, slots in NORMAL_SLOTS.items()}


def add_ops(*ops: dict) -> dict:
    out: dict = {}
    for o in ops:
        for pipe, slots in o.items():
            out[pipe] = out.get(pipe, 0) + slots
    return out


def bound(nbytes: float, ops: dict) -> tuple:
    """(ms, what bounds it, the pipe that binds): the largest of bytes over
    the memory rate and each pipe's slots (``ops``, as :func:`philox_ops`
    and :func:`normal_ops` count them; ``fma+fp32`` the two together) over
    its rate at the card's top SM clock."""
    sm_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops, pipe = max((sum(ops.get(k, 0) for k in p.split("+"))
                       / (rate * sms * sm_hz), p)
                      for p, rate in PIPE_LANES_PER_SM.items())
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, pipe


EMBED_ROWS, EMBED_OBS, EMBED_H = 131072, 320, 64  # the taxi PPO minibatch
EMBED_TOL = 2.0 ** -17  # tests/test_torch_cuda.py's EMBED_KERNEL_TOL
EMBED_TWIN_TOL = 2.0 ** -14  # and its EMBED_TWIN_TOL


def embed_grad_checks(dev) -> dict:
    """The discrete first layer's backward, ``embed_grad``, at the taxi PPO
    cell's minibatch (131,072 rows, 320 observations, H = 64) on each law
    of ``probe_embed.inputs`` in float32 and the uniform law in bfloat16:
    the kernel against the float64 sums of the same rows within
    ``EMBED_TOL`` of each entry's sum of |g| (bfloat16: plus half an ulp),
    against its twin on the CPU copy within ``EMBED_TOL + EMBED_TWIN_TOL``
    (bfloat16: plus an ulp), a second call bit for bit.  Then, on each
    float32 law (CUDA events, medians of 3 windows of 20 calls, not
    counted), the kernel and PyTorch's index backward that autograd ran
    before it (``index_put_`` accumulating into zeros, plus the bias's
    ``sum``), and on the uniform law the twin on the card.  Returns the
    record's numbers, the uniform law's times."""
    from gym_po_tpu_torch.ops import probe_embed as pe
    from gym_po_tpu_torch.ops.embed import embed_grad, embed_grad_twin

    n, errs, lines = EMBED_OBS, [], []
    with uncounted():
        for law, dtype in ([(law, torch.float32) for law in pe.LAWS]
                           + [("uniform", torch.bfloat16)]):
            g, idx = pe.inputs(law, dev, dtype, seed=11, n=n, H=EMBED_H,
                               rows=EMBED_ROWS)
            gw, gb = embed_grad(g, idx, n)
            again = embed_grad(g, idx, n)
            torch.cuda.synchronize()
            if not (torch.equal(gw, again[0]) and torch.equal(gb, again[1])):
                raise AssertionError(f"embed_grad {law} {dtype}: two calls differ")
            tw, tb = embed_grad_twin(g.cpu(), idx.cpu(), n)
            ew, eb, aw, ab = pe.exact(g, idx, n)
            worst = 0.0
            for got, twin, want, mag in ((gw, tw, ew, aw), (gb, tb, eb, ab)):
                got, twin = got.cpu().double(), twin.double()
                f32 = dtype == torch.float32
                rounding = 0.0 if f32 else 2.0 ** -8 * want.abs()
                ulp = 0.0 if f32 else 2.0 ** -7 * twin.abs()
                if not ((got - want).abs() <= EMBED_TOL * mag + rounding).all():
                    raise AssertionError(f"embed_grad {law} {dtype}: off the "
                                         "float64 sums")
                if not ((got - twin).abs()
                        <= (EMBED_TOL + EMBED_TWIN_TOL) * mag + ulp).all():
                    raise AssertionError(f"embed_grad {law} {dtype}: off its twin")
                worst = max(worst, float(((got - want).abs()
                                          / mag.clamp_min(1e-300)).max()))
                if f32:
                    errs.append(float((got - twin).abs().max()))
            lines.append(f"{law} {str(dtype)[6:]} {worst:.3e}")
        say("embed-grad", f"kernel == float64 sums within {EMBED_TOL:.2e} of "
            "each sum of |g| (bfloat16 half an ulp besides), == twin, two calls "
            f"bit for bit, at {EMBED_ROWS} x {n} x {EMBED_H}; largest error over "
            f"sum |g|: {', '.join(lines)}; largest |kernel - twin| {max(errs):.3e}")
        ms = {}
        for law in pe.LAWS:
            g, idx = pe.inputs(law, dev, seed=11, n=n, H=EMBED_H, rows=EMBED_ROWS)
            il = idx.long()

            def library(i):
                w = torch.zeros(n, EMBED_H, device=dev)
                torch.ops.aten._index_put_impl_(w, (il,), g, True, True)
                return w, g.sum(0)

            ms[law] = (event_windows(lambda i: embed_grad(g, idx, n), 3, 20),
                       event_windows(library, 3, 20))
            if law == "uniform":
                plain = event_windows(lambda i: embed_grad_twin(g, idx, n), 3, 20)
                nbytes = (g.numel() * g.element_size() + idx.numel() * idx.element_size()
                          + (n + 1) * EMBED_H * 4)
    b = bound(nbytes, {})
    say("embed-grad", "ms a call, kernel / PyTorch's index backward: " + "; ".join(
        f"{law} {k:.4f} / {lib:.4f}" for law, (k, lib) in ms.items())
        + f"; twin (index_add_ on the card) {plain:.4f}; bound {b[0]:.4f} "
        f"(bytes: {nbytes / 1e6:.2f} MB)")
    return {"ms": ms["uniform"][0], "plain_ms": plain, "library_ms": ms["uniform"][1],
            "bound": b, "max_abs_err": max(errs)}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.entry import entry
    from gym_po_tpu_torch.ops import (
        KernelRNG,
        make_fused_taxi_rollout,
        philox4x32_10,
    )
    from gym_po_tpu_torch.ops._build import LAUNCHES, build_log, load_library
    from gym_po_tpu_torch.vector import rollout

    card = nvidia_smi("name,power.limit")
    print(card, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    say("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    sources = ("fused_taxi", "fused_qlearning", "fused_rooms", "fused_ac",
               "fused_msrooms", "fused_rocksample", "fused_crooms",
               "fused_q_crooms", "fused_tag", "ant_forward", "embed")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(load_library, sources))  # one nvcc each, together
    say("build", f"{', '.join(f'{s}.cu' for s in sources)} built and loaded "
        f"in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in build_log(name).splitlines():
            if "registers" in line or "build" in line or "spill" in line:
                say("build", f"{name}: {line.strip()[:160]}")
    say("build", f"ant_forward.cu by kernel: {ptxas_summary(build_log('ant_forward'))}")

    sass_check()
    divisors_check(dev)

    z = torch.zeros(1, dtype=torch.int64, device=dev)
    words = tuple(int(w) for w in philox4x32_10((z, z, z, z), (0, 0)))
    if words != PHILOX_KAT:
        raise AssertionError(f"Philox known answer: {[hex(w) for w in words]}")
    rng = KernelRNG(0, 1, 1, 9, device=dev)
    rng.begin_step(0)
    draws = [int(rng.draw32()) for _ in range(9)]
    if tuple(draws[:4]) != PHILOX_KAT or draws[8] != PHILOX_BLOCK2_KAT:
        raise AssertionError(f"Philox sites: {[hex(w) for w in draws]}")
    say("philox-kat", "twin on the card gives 6627e8d5 e169c58d bc57ac4c "
        "9b00dbd8, and 0661d677 at site 8 (block 2)")

    errs: list = []
    trainer_errs = ([], [])  # fused_qlearning, fused_double_q
    tape_checks(dev, errs)
    philox_check(dev, errs)
    distribution_check(dev)
    trainer_tape_checks(dev, trainer_errs)
    plain_ms: dict = {}
    trainer_philox_checks(dev, trainer_errs, plain_ms)
    rooms_errs = {k: [] for k in ("fused_rooms", "fused_q_rooms",
                                  "fused_qlambda_rooms", "fused_ac")}
    rooms_rollout_checks(dev, rooms_errs["fused_rooms"])
    rooms_distribution_check(dev)
    rooms_terms: dict = {}
    rooms_trainer_checks(dev, rooms_errs, plain_ms, rooms_terms)
    redesign_checks(dev, rooms_errs)
    p4_errs = {k: [] for k in ("fused_msrooms", "fused_q_msrooms",
                               "fused_rocksample")}
    path4_rollout_checks(dev, p4_errs)
    path4_distribution_checks(dev)
    msrooms_trainer_checks(dev, p4_errs["fused_q_msrooms"], plain_ms,
                           rooms_terms)
    one_step_redesign_checks(dev, {
        "fused_qlearning": trainer_errs[0], "fused_double_q": trainer_errs[1],
        "fused_q_rooms": rooms_errs["fused_q_rooms"],
        "fused_q_msrooms": p4_errs["fused_q_msrooms"]})
    p5_errs = {k: [] for k in ("fused_crooms", "fused_tag", "fused_heavenhell",
                               "fused_q_crooms")}
    libm_check(dev)
    path5_checks(dev, p5_errs)
    path5_distribution_checks(dev)
    path5_trainer_philox(dev, p5_errs["fused_q_crooms"], plain_ms)
    crooms_trainer_redesign_checks(dev, p5_errs["fused_q_crooms"])

    # plain versions first: the twin of the headline kernel, and the
    # step_vec rollout path
    env = gp.make("HansenTaxi-v4", device=dev)
    run = make_fused_taxi_rollout(env, B_HEAD, K_HEAD)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B_HEAD)
    s0 = st.s.reshape(-1, 128).contiguous()
    twin_out = []
    twin_s = time_windows(lambda i: twin_out.append(run.twin(100 + i, s0)),
                          windows=1, calls=1)
    # the kernel against the twin at the headline's own shape (the first
    # timed twin call), exact; not counted as a main-path launch
    compare(f"headline shape B={B_HEAD} K={K_HEAD}", run(100, s0), twin_out[0],
            errs)
    del twin_out
    say("headline-check", f"kernel == twin exactly: HansenTaxi-v4 B={B_HEAD} "
        f"K={K_HEAD}, Philox mode")
    scan_gen = torch.Generator(device=dev).manual_seed(3)
    scan_s = time_windows(
        lambda i: rollout(env, scan_gen, None, B_SCAN, K_HEAD), windows=3, calls=1
    )

    # path 1, counted: headline kernel calls, then the acting step
    LAUNCHES.clear()
    state = {"s": s0}

    def head_call(i):
        state["s"], _ = run(1000 + i, state["s"])

    head_call(-1)  # warm-up
    kern_s = time_windows(head_call, windows=5, calls=4)
    check_states(env, state["s"])

    forward, (model, gen, obs, est) = entry(device=dev, num_envs=B_ACT)
    n_obs = model.obs_space.n
    for _ in range(ACT_STEPS):
        obs, est, rew, value, logp = forward(model, gen, obs, est)
        torch.cuda.synchronize()
        for name, x in (("reward", rew), ("value", value), ("logp", logp)):
            if not torch.isfinite(x).all():
                raise AssertionError(f"acting step: non-finite {name}")
        if not ((obs >= 0) & (obs < n_obs)).all():
            raise AssertionError("acting step: obs out of range")
    launches = {"fused_taxi": LAUNCHES["fused_taxi"]}
    if launches["fused_taxi"] <= 0:
        raise AssertionError("the headline did not go through the kernel")

    steps = B_HEAD * K_HEAD
    say("headline", f"fused Taxi rollout HansenTaxi-v4 B={B_HEAD} K={K_HEAD} "
        f"on {card}: kernel {steps / kern_s:.6e} env-steps/s "
        f"({kern_s * 1e3:.3f} ms/call, median of 5 windows x 4 calls); "
        f"twin {steps / twin_s:.6e} env-steps/s ({twin_s * 1e3:.3f} ms/call); "
        f"step_vec rollout B={B_SCAN} {B_SCAN * K_HEAD / scan_s:.6e} env-steps/s")
    say("acting", f"{ACT_STEPS} entry.forward steps on ExtendedHansenTaxi-v4 "
        f"B={B_ACT} hidden (64, 64): finite, obs in range, last value mean "
        f"{value.mean().item():.6f}")

    # path 2, counted: the trainers at full width, then learning runs
    LAUNCHES.clear()
    kern_ms: dict = {}
    learner_path(dev, kern_ms, trainer_errs)
    for key in ("fused_qlearning", "fused_double_q"):
        launches[key] = LAUNCHES[key]
        if launches[key] <= 0:
            raise AssertionError(f"the learner path did not go through {key}")

    # path 3, the ROOMS workflow.  Plain versions first: the rollout twin at
    # the headline's shape (its first call held against the kernel, not
    # counted) and the step_vec rollout
    from gym_po_tpu_torch.ops import make_fused_rooms_rollout

    renv = gp.make("Rooms-v0", device=dev)
    rrun = make_fused_rooms_rollout(renv, B_HEAD, K_HEAD)
    _, rst = renv.reset_vec(torch.Generator(device=dev).manual_seed(0), B_HEAD)
    ra0, rg0 = rooms_cells(renv, rst.agent_yx), rooms_cells(renv, rst.goal_yx)
    twin_out = []
    rtwin_s = time_windows(
        lambda i: twin_out.append(rrun.twin(100 + i, ra0, rg0)), windows=1,
        calls=1)
    compare(f"rooms headline shape B={B_HEAD} K={K_HEAD}", rrun(100, ra0, rg0),
            twin_out[0], rooms_errs["fused_rooms"])
    del twin_out
    say("rooms-headline-check", f"kernel == twin exactly: Rooms-v0 B={B_HEAD} "
        f"K={K_HEAD}, Philox mode")
    scan_gen = torch.Generator(device=dev).manual_seed(3)
    rscan_s = time_windows(
        lambda i: rollout(renv, scan_gen, None, B_SCAN, K_HEAD), windows=3,
        calls=1)

    # counted: the rollout at the headline's size, then the trainers and
    # the learning runs
    LAUNCHES.clear()
    rstate = {"a": ra0, "g": rg0}

    def rooms_head_call(i):
        rstate["a"], rstate["g"], _ = rrun(1000 + i, rstate["a"], rstate["g"])

    rooms_head_call(-1)  # warm-up
    rkern_s = time_windows(rooms_head_call, windows=5, calls=4)
    check_cells(renv, rstate["a"])
    say("rooms-headline", f"fused ROOMS rollout Rooms-v0 B={B_HEAD} K={K_HEAD} "
        f"on {card}: kernel {steps / rkern_s:.6e} env-steps/s "
        f"({rkern_s * 1e3:.3f} ms/call, median of 5 windows x 4 calls); twin "
        f"{steps / rtwin_s:.6e} env-steps/s ({rtwin_s * 1e3:.3f} ms/call); "
        f"step_vec rollout B={B_SCAN} {B_SCAN * K_HEAD / rscan_s:.6e} "
        "env-steps/s")
    rooms_path(dev, kern_ms, rooms_errs)
    for key in rooms_errs:
        launches[key] = LAUNCHES[key]
        if launches[key] <= 0:
            raise AssertionError(f"the ROOMS path did not go through {key}")

    # path 4, MultistoryFourRooms and RockSample.  Plain versions first: the
    # rollout twins at the headline's shape (their first calls held against
    # the kernels, not counted); then, counted, the rollouts, the MSRooms
    # trainer and the MSRooms learning run
    heads = path4_headline_checks(dev, p4_errs, plain_ms)
    LAUNCHES.clear()
    path4_rollout_times(dev, card, heads, kern_ms)
    msrooms_path(dev, kern_ms, p4_errs["fused_q_msrooms"])
    for key in p4_errs:
        launches[key] = LAUNCHES[key]
        if launches[key] <= 0:
            raise AssertionError(f"path 4 did not go through {key}")

    # path 5, the continuous envs.  Plain versions first: the rollout twins
    # at the headline's shape (their first calls held against the kernels,
    # not counted); then, counted, the rollouts, the CRooms trainer and the
    # CRooms learning run
    heads5 = path5_headline_checks(dev, p5_errs, plain_ms)
    LAUNCHES.clear()
    needs = path5_rollout_times(dev, card, heads5, kern_ms)
    crooms_trainer_path(dev, kern_ms, p5_errs["fused_q_crooms"])
    for key in p5_errs:
        launches[key] = LAUNCHES[key]
        if launches[key] <= 0:
            raise AssertionError(f"path 5 did not go through {key}")

    # path 6, the PPO update: plain PyTorch (the collect half a CUDA
    # graph) but for the discrete first layer's backward, embed_grad
    LAUNCHES.clear()
    ppo_path(dev, card)
    if set(LAUNCHES) != {"embed_grad"}:
        raise AssertionError(f"path 6 launched {dict(LAUNCHES)}, not embed_grad alone")
    launches["embed_grad"] = LAUNCHES["embed_grad"]
    # path 7, recurrent PPO on the taxi: the GRU's embed, the same kernel
    LAUNCHES.clear()
    rnn_path(dev, card)
    if set(LAUNCHES) != {"embed_grad"}:
        raise AssertionError(f"path 7 launched {dict(LAUNCHES)}, not embed_grad alone")
    launches["embed_grad"] += LAUNCHES["embed_grad"]
    # path 8, data parallelism: the fused Taxi Q trainer [2] and the
    # actor-critic [13] under a mesh, counted here and in the ranks'
    # processes, and the PPO update's embed_grad
    LAUNCHES.clear()
    path8 = mesh_path(dev, card) + LAUNCHES
    if set(path8) - {"fused_qlearning", "fused_ac", "embed_grad"}:
        raise AssertionError(f"path 8 launched other kernels: {dict(path8)}")
    launches["embed_grad"] += path8["embed_grad"]
    for key in ("fused_qlearning", "fused_ac"):
        if path8[key] <= 0:
            raise AssertionError(f"path 8 did not go through {key}")
        launches[key] += path8[key]
    # the kernel that paths 6-8 reach, against its twin and timed
    embed = embed_grad_checks(dev)
    # path 9, the articulated ant: the envs' default "scalar" forward runs
    # the three ant kernels (counted inside ant_path: its checks first)
    path9, ant_errs, ant_times = ant_path(dev, card)
    if {k for k, v in path9.items() if v} != set(ANT_KERNELS):
        raise AssertionError(f"path 9 launched {dict(path9)}, not the three "
                             "ant kernels")
    launches.update({k: path9[k] for k in ANT_KERNELS})
    say("launches", "on the main paths: " + ", ".join(
        f"{k} {v}" for k, v in launches.items())
        + "; paths 6 (PPO), 7 (recurrent PPO) and 8's PPO: embed_grad alone; "
        f"path 8's share: fused_qlearning {path8['fused_qlearning']}, "
        f"fused_ac {path8['fused_ac']}")

    # bounds of this run's main-path shapes
    ns_sites_head = make_fused_taxi_rollout(env, B_HEAD, K_HEAD).n_sites
    b_taxi = bound(12 * B_HEAD, philox_ops(ns_sites_head, B_HEAD * K_HEAD))
    taxi = gp.make("Taxi-v4", device=dev)
    b_train = {}
    for key, opts in (("fused_qlearning", dict(average_duplicates=True)),
                      ("fused_double_q", "double")):
        run_t = make_trainer(taxi, B_TRAIN, K_TRAIN, opts)
        nq = q_rows(taxi, opts) * 128
        # per env-step: the Philox blocks and one update term
        b_train[key] = bound(12 * B_TRAIN + 8 * nq, philox_ops(
            run_t.n_sites, B_TRAIN * K_TRAIN, B_TRAIN * K_TRAIN))
    b_rooms = {"fused_rooms": bound(20 * B_HEAD, philox_ops(
        rrun.n_sites, B_HEAD * K_HEAD))}
    for key, kind, opts in ROOMS_TRAINERS[:2] + ROOMS_TRAINERS[3:]:
        run_t = make_rooms_trainer(renv, kind, B_TRAIN, K_TRAIN, opts)
        steps = B_TRAIN * K_TRAIN
        if kind == "ac":  # A + 1 fixed-point adds and one count per env-step
            ops = philox_ops(run_t.n_sites, steps, (2 * (renv.num_actions + 1)
                                                   + 1) / 3 * rooms_terms[key])
            nbytes = 12 * B_TRAIN + 16 * 32 * 128
        else:  # each applied term: one fixed-point add and one count
            ops = philox_ops(run_t.n_sites, steps, rooms_terms[key])
            nbytes = 12 * B_TRAIN + 8 * 32 * 128
        b_rooms[key] = bound(nbytes, ops)
    # path 4: the rollouts read 8 B and write 12 B per env, one Philox block
    # per env-step; the trainer as the ROOMS one (its sites, 3 per applied
    # term)
    for key, run_h in (("fused_msrooms", heads[0][0]),
                       ("fused_rocksample", heads[1][0])):
        b_rooms[key] = bound(20 * B_HEAD, philox_ops(run_h.n_sites,
                                                     B_HEAD * K_HEAD))
    from gym_po_tpu_torch.ops import make_fused_q_trainer_msrooms
    b_rooms["fused_q_msrooms"] = bound(12 * B_TRAIN + 8 * 32 * 128, philox_ops(
        make_fused_q_trainer_msrooms(heads[0][1], B_TRAIN, K_TRAIN).n_sites,
        B_TRAIN * K_TRAIN, rooms_terms["fused_q_msrooms"]))
    # path 5: the rollouts read their state tiles and write them and the
    # reward sums once per env (CRooms 24 + 28 B, Tag 16 + 20, HeavenHell
    # 12 + 16).  What the warm-up call's data needed of the three
    # rollouts: HeavenHell, words 0-1 of block 0 every env-step and word 0
    # of block 1 at each reset (the spawn's x and y, words 2-3 of block 0,
    # left out: a bound need only be low); Tag,
    # block 0 (sites 0-2) every env-step and at each reset at least block 1
    # (the agent's y and the first candidate); CRooms, every env-step block
    # 0, words 0-1 of block 1 and the action's two normals, at each hit
    # words 2-3 of block 1, block 2's words 0-1 and two normals more, and at
    # each reset block 2 (at least max(hits, resets) third blocks).  Their
    # eager counts (every site and normal every step, as the parent kernels
    # drew them) are printed beside.  The CRooms trainer reads 16 B and
    # writes 20 B per env, Q in and out; it needs, every env-step, blocks 0
    # and 1 (the acting draws and the action's normals, sites 0-7) and the
    # action's two normals, and 3 issue slots per update term, one term per
    # env-step (every env is live every step).  A wall hit's block 2 and two
    # normals and a respawn's block 3 are left out: this run does not count
    # the trainer's hits, and a bound need only be low (probe_fused_taxi
    # ``shares`` counts them and prints the bound at its shares).
    nh, nt, nc = needs["fused_heavenhell"], needs["fused_tag"], needs["fused_crooms"]
    b_rooms["fused_heavenhell"] = bound(28 * B_HEAD, block_ops(
        0, nh["steps"] + nh["resets"]))
    b_rooms["fused_tag"] = bound(36 * B_HEAD, block_ops(nt["steps"] + nt["resets"]))
    b_rooms["fused_crooms"] = bound(52 * B_HEAD, add_ops(
        block_ops(nc["steps"], nc["steps"] + max(nc["hits"], nc["resets"])),
        {"fma": WIDE_PRODUCT_FMA_SLOTS * nc["hits"], "alu": nc["hits"],
         "issue": 2 * nc["hits"]},
        normal_ops(2 * nc["steps"] + 2 * nc["hits"])))
    eager = {"fused_heavenhell": bound(28 * B_HEAD, philox_ops(
                 heads5["fused_heavenhell"][0].n_sites, B_HEAD * K_HEAD)),
             "fused_tag": bound(36 * B_HEAD, philox_ops(
                 heads5["fused_tag"][0].n_sites, B_HEAD * K_HEAD)),
             "fused_crooms": bound(52 * B_HEAD, add_ops(philox_ops(
                 heads5["fused_crooms"][0].n_sites, B_HEAD * K_HEAD),
                 normal_ops(4 * B_HEAD * K_HEAD)))}
    say("bound", "at this run's shares, against every site and normal every "
        "step: " + "; ".join(f"{k} {b_rooms[k][0]:.4f} ms ({b_rooms[k][2]}), "
                             f"eager {v[0]:.4f} ms ({v[2]})"
                             for k, v in eager.items()))
    b_rooms["fused_q_crooms"] = bound(36 * B_TRAIN + 8 * 32 * 128, add_ops(
        philox_ops(8, B_TRAIN * K_TRAIN, B_TRAIN * K_TRAIN),
        normal_ops(2 * B_TRAIN * K_TRAIN)))
    say("bound", f"fused_taxi {b_taxi[0]:.4f} ms ({b_taxi[2]}); "
        + "; ".join(f"{k} {v[0]:.4f} ms ({v[2]})" for k, v in b_rooms.items())
        + "; "
        + "; ".join(f"{k} {v[0]:.4f} ms ({v[2]})" for k, v in b_train.items())
        + f"; SM clock {nvidia_smi('clocks.max.sm')} max, now "
        f"{nvidia_smi('clocks.sm')}")

    record = [{
        "name": "fused_taxi",
        "route": "cuda",
        "source": "gym_po_tpu_torch/csrc/fused_taxi.cu",
        "replaces": "gym_po_tpu/ops/fused_taxi.py:64",
        "launches": launches["fused_taxi"],
        "max_abs_err": max(errs),
        "ms": kern_s * 1e3,
        "plain_ms": twin_s * 1e3,
        "bound_ms": b_taxi[0],
        "bound_by": b_taxi[1],
        "library_ms": None,
    }]
    for i, (key, replaces) in enumerate((
            ("fused_qlearning", "gym_po_tpu/ops/fused_qlearning.py:146"),
            ("fused_double_q", "gym_po_tpu/ops/fused_double_q.py:44"))):
        record.append({
            "name": key,
            "route": "cuda",
            "source": "gym_po_tpu_torch/csrc/fused_qlearning.cu",
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(trainer_errs[i]),
            "ms": kern_ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": b_train[key][0],
            "bound_by": b_train[key][1],
            "library_ms": None,
        })
    kern_ms["fused_rooms"] = rkern_s * 1e3
    plain_ms["fused_rooms"] = rtwin_s * 1e3
    for key, source, replaces in (
            ("fused_rooms", "fused_rooms.cu", "fused_rooms.py:46"),
            ("fused_q_rooms", "fused_qlearning.cu", "fused_qlearning.py:494"),
            ("fused_qlambda_rooms", "fused_qlearning.cu", "fused_qlambda.py:51"),
            ("fused_ac", "fused_ac.cu", "fused_ac.py:41"),
            ("fused_msrooms", "fused_msrooms.cu", "fused_msrooms.py:34"),
            ("fused_q_msrooms", "fused_qlearning.cu", "fused_qlearning.py:710"),
            ("fused_rocksample", "fused_rocksample.cu", "fused_rocksample.py:40"),
            ("fused_crooms", "fused_crooms.cu", "fused_crooms.py:36"),
            ("fused_tag", "fused_tag.cu", "fused_tag.py:59"),
            ("fused_heavenhell", "fused_tag.cu", "fused_tag.py:219"),
            ("fused_q_crooms", "fused_q_crooms.cu", "fused_q_crooms.py:35")):
        record.append({
            "name": key,
            "route": "cuda",
            "source": f"gym_po_tpu_torch/csrc/{source}",
            "replaces": f"gym_po_tpu/ops/{replaces}",
            "launches": launches[key],
            "max_abs_err": max({**rooms_errs, **p4_errs, **p5_errs}[key]),
            "ms": kern_ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": b_rooms[key][0],
            "bound_by": b_rooms[key][1],
            "library_ms": None,
        })
    for key in ANT_KERNELS:
        ms, plain, b = ant_times[key]
        record.append({
            "name": key,
            "route": "cuda",
            "source": "gym_po_tpu_torch/csrc/ant_forward.cu",
            "replaces": ANT_KERNEL_REPLACES[key],
            "launches": launches[key],
            "max_abs_err": ant_errs[key][1],
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": b[0],
            "bound_by": b[1],
            "library_ms": None,
        })
    record.append({
        "name": "embed_grad",
        "route": "cuda",
        "source": "gym_po_tpu_torch/csrc/embed.cu",
        "replaces": None,  # the JAX first layer's one-hot product is XLA's
        "launches": launches["embed_grad"],
        "max_abs_err": embed["max_abs_err"],
        "ms": embed["ms"],
        "plain_ms": embed["plain_ms"],
        "bound_ms": embed["bound"][0],
        "bound_by": embed["bound"][1],
        "library_ms": embed["library_ms"],
    })
    say("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        print("[chip_smoke] FAILED", flush=True)
        sys.exit(1)
