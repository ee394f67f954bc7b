#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gym_po_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path on the card: the fused Taxi rollout kernel at
the size ``bench.py`` runs the JAX package (``HansenTaxi-v4``, B = 2^20 envs,
K = 256 steps) and the acting step of ``gym_po_tpu_torch.entry`` (ActorCritic
64x64 over ``ExtendedHansenTaxi-v4``, random weights from a seed).  Each
phase prints one line; any failure exits non-zero.  There is no CPU
fallback: without a CUDA device the script fails before printing a result.

Phases: device; build of ``gym_po_tpu_torch/csrc`` (into
``build/gym_po_tpu_torch/``); Philox known answer; kernel vs plain twin on
the card, tape mode and Philox mode, exact; distribution check against the
step_vec rollout path; kernel vs twin at the headline's shape, exact;
headline timing; acting step.  The line before the
last is the kernels' JSON record; the last line is the result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

B_HEAD, K_HEAD = 1 << 20, 256  # headline: bench.py's fused-path defaults
B_CHECK, K_TAPE = 65536, 64
B_SCAN = 65536
B_ACT, ACT_STEPS = 4096, 8
PHILOX_KAT = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)  # Random123
DIST_ATOL = 0.02


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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
    """Median seconds per call over ``windows`` windows of chained calls."""
    times = []
    for w in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(w * calls + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.entry import entry
    from gym_po_tpu_torch.ops import make_fused_taxi_rollout, philox4x32_10
    from gym_po_tpu_torch.ops._build import build_log, load_library
    from gym_po_tpu_torch.vector import rollout

    card = card_line()
    print(card, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    say("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    load_library("fused_taxi")
    say("build", f"fused_taxi.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in build_log("fused_taxi").splitlines():
        if "registers" in line or "build" in line or "spill" in line:
            say("build", line.strip())

    z = torch.zeros(1, dtype=torch.int64, device=dev)
    words = tuple(int(w) for w in philox4x32_10((z, z, z, z), (0, 0)))
    if words != PHILOX_KAT:
        raise AssertionError(f"Philox known answer: {[hex(w) for w in words]}")
    say("philox-kat", "twin on the card gives 6627e8d5 e169c58d bc57ac4c 9b00dbd8")

    errs: list = []
    tape_checks(dev, errs)
    philox_check(dev, errs)
    distribution_check(dev)

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

    # the main path, counted: headline kernel calls, then the acting step
    run.launches = 0
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
    launches = run.launches
    if launches <= 0:
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
    say("launches", f"fused_taxi launched {launches} times on the main path")

    print(json.dumps({"kernels": [{
        "name": "fused_taxi",
        "route": "cuda",
        "source": "gym_po_tpu_torch/csrc/fused_taxi.cu",
        "replaces": "gym_po_tpu/ops/fused_taxi.py:64",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kern_s * 1e3,
        "plain_ms": twin_s * 1e3,
    }]}))
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
