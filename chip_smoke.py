#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gym_po_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's two main paths on the card, each through the entry points
a user calls, with the kernels' launch counts zeroed just before the path
and read just after:

1. the fused Taxi rollout kernel at the size ``bench.py`` runs the JAX
   package (``HansenTaxi-v4``, B = 2^20 envs, K = 256 steps), then the
   acting step of ``gym_po_tpu_torch.entry`` (ActorCritic 64x64 over
   ``ExtendedHansenTaxi-v4``, random weights from a seed);
2. tabular Q-learning on Taxi: the fused Q and double-Q trainer kernels at
   full width (``Taxi-v4``, B = 65,536, K = 256, lr = eps = 0.1, duplicates
   averaged), then training runs at B = 4,096, K = 4,096 through the
   kernels (the first chunk of each held against its twin, exactly) and
   the ``fused_q_learning`` driver, each greedy policy evaluated by
   ``vector.rollout`` and by the fused Taxi kernel against the JAX
   package's hardware-test thresholds, and the ``q_learning`` step_vec
   learner at B = 512 and B = 4,096.

Each phase prints one line; any failure exits non-zero.  There is no CPU
fallback: without a CUDA device the script fails before printing a result.

Phases: device; build of ``gym_po_tpu_torch/csrc`` (into
``build/gym_po_tpu_torch/``, one nvcc per source, in parallel); Philox
known answers; every kernel against its plain twin on the card, exact, in
tape mode and in Philox mode; distribution check against the step_vec
rollout path; kernel vs twin at the headline's shape; path 1 with the
headline timing; path 2 with the trainers' timing and learning checks.  The
line before the last is the kernels' JSON record; the last line is the
result.
"""

from __future__ import annotations

import json
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
SCHED_Q = [(0.05, 0.3)] * 3 + [(0.02, 0.05)] * 3 + [(0.01, 0.01)] * 2
SCHED_QLAMBDA = [(0.3, 0.3)] * 2 + [(0.1, 0.05)] + [(0.05, 0.01)]
SCHED_DOUBLE = [(0.1, 0.3)] * 2 + [(0.05, 0.05)] * 2
# step_vec learner: tests/test_qlearning.py's schedule at its B = 512, and
# examples/solve_taxi.py's at B = 4,096.  The learner sums duplicates, so
# its step grows with B / ns: at B = 4,096 the test's schedule stalls at
# the never-pickup optimum in both packages (tests/_q_learning_at_scale.py)
SCHED_STEP_VEC_TEST = [(0.3, 0.1, 40), (0.05, 0.05, 40)]
SCHED_STEP_VEC = [(0.30, 0.05, 150), (0.05, 0.02, 150), (0.01, 0.01, 100)]

# bounds: H100 SXM memory rate (NVIDIA H100 datasheet); INT32 issue is
# 16 lanes per SM partition, 4 partitions per SM (Hopper white paper);
# Philox4x32-10 is 80 INT32 instructions a block (10 rounds of 2 IMUL.HI,
# 2 IMUL, 2 three-input XOR, 2 key IADD).  Every other integer operation
# counts as free, so each bound is a lower bound.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
PHILOX_BLOCK_OPS = 80


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
                                           q0)), windows=3, calls=1)
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


def train_chunks(dev, env, run, sched, errs, name, n_tables=1):
    """The JAX hardware tests' loop: one trainer call per schedule entry,
    chunk ``i`` seeded ``i + 1``; returns the mean of the tables as
    ``[ns, 5]``.  The first chunk is held against the twin on the same
    inputs, exactly: the learning runs' shape (B = 4,096, K = 4,096, 16
    blocks) is checked as well as the timed one."""
    from gym_po_tpu_torch.ops import banks_to_q

    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B_LEARN)
    s = st.s.reshape(-1, 128).contiguous()
    qb = torch.zeros((32 * n_tables, 128), device=dev)
    for i, (lr, eps) in enumerate(sched):
        want = run.twin(i + 1, lr, eps, s, qb) if i == 0 else None
        s, qb, rsum = run(i + 1, lr, eps, s, qb)
        if want is not None:
            torch.cuda.synchronize()
            compare(f"{name}, chunk 1", (s, qb, rsum), want, errs)
            say("learning", f"kernel == twin exactly: {name}, chunk 1, "
                f"B={B_LEARN} K={K_LEARN} lr={lr} eps={eps}, grid {run.grid} "
                "(blocks, envs/thread)")
            del want
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
    name = "fused Q, summed duplicates, 8 chunks"
    run = make_trainer(env, B_LEARN, K_LEARN, dict(average_duplicates=False))
    evaluate(dev, env, name, train_chunks(dev, env, run, SCHED_Q, errs[0], name))
    name = "fused Watkins Q(lambda=0.9, L=16), 4 chunks"
    run = make_trainer(env, B_LEARN, K_LEARN,
                       dict(average_duplicates=True, lam=0.9, trace_len=16))
    evaluate(dev, env, name,
             train_chunks(dev, env, run, SCHED_QLAMBDA, errs[0], name))
    name = "fused double Q, 4 chunks"
    run = make_trainer(env, B_LEARN, K_LEARN, "double")
    evaluate(dev, env, name,
             train_chunks(dev, env, run, SCHED_DOUBLE, errs[1], name,
                          n_tables=2),
             bad_limit=0.01)
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


def bound(nbytes: float, int_ops: float) -> tuple:
    """(ms, what bounds it): the larger of bytes over the memory rate and
    INT32 instructions over the card's issue rate at its top SM clock."""
    sm_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / (INT32_LANES_PER_SM * sms * sm_hz)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
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
    from gym_po_tpu_torch.ops.kernel_rng import philox_blocks
    from gym_po_tpu_torch.vector import rollout

    card = nvidia_smi("name,power.limit")
    print(card, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    say("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    sources = ("fused_taxi", "fused_qlearning")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(load_library, sources))  # one nvcc each, together
    say("build", f"{', '.join(f'{s}.cu' for s in sources)} built and loaded "
        f"in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in build_log(name).splitlines():
            if "registers" in line or "build" in line or "spill" in line:
                say("build", f"{name}: {line.strip()[:160]}")

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

    # plain versions first: the twin of the headline kernel, and the
    # step_vec rollout path
    env = gp.make("HansenTaxi-v4", device=dev)
    run = make_fused_taxi_rollout(env, B_HEAD, K_HEAD)
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(0), B_HEAD)
    s0 = st.s.reshape(-1, 128).contiguous()
    twin_out = []
    twin_s = time_windows(lambda i: twin_out.append(run.twin(100 + i, s0)),
                          windows=3, calls=1)
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
    say("launches", "on the main paths: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))

    # bounds of this run's main-path shapes
    ns_sites_head = make_fused_taxi_rollout(env, B_HEAD, K_HEAD).n_sites
    b_taxi = bound(12 * B_HEAD, PHILOX_BLOCK_OPS * philox_blocks(ns_sites_head)
                   * B_HEAD * K_HEAD)
    taxi = gp.make("Taxi-v4", device=dev)
    b_train = {}
    for key, opts in (("fused_qlearning", dict(average_duplicates=True)),
                      ("fused_double_q", "double")):
        run_t = make_trainer(taxi, B_TRAIN, K_TRAIN, opts)
        nq = q_rows(taxi, opts) * 128
        # per env-step: the Philox blocks and one fixed-point add (two INT32
        # words) plus one count add per update term
        per_step = PHILOX_BLOCK_OPS * philox_blocks(run_t.n_sites) + 3
        b_train[key] = bound(12 * B_TRAIN + 8 * nq,
                             per_step * B_TRAIN * K_TRAIN)
    say("bound", f"fused_taxi {b_taxi[0]:.4f} ms ({b_taxi[1]}); "
        + "; ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in b_train.items())
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
