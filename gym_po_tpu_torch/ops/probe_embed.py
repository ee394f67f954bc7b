"""Measurement probe of the discrete first layer's backward on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_embed [check] [ab] [update]

Inputs at the taxi PPO cell's shape (``PPOConfig``'s defaults on
ExtendedHansenTaxi-v4: minibatches of N = 131,072 rows, n = 320
observations, H = 64, a float32 gradient, int32 observations), the gradient
normal and the observations drawn from a fixed seed in three laws:
``uniform`` over the n observations, ``concentrated`` (nine tenths of the
rows on 8 observations, the rest uniform) and ``one`` (every row one
observation).

Sections:

- ``check``: the kernel's first calls.  Its ptxas report, then, for each
  law (and bfloat16 on the uniform law), ``embed_grad`` against the
  float64 sums of the same rows: the largest error of the weight's and
  the bias's gradients over each entry's sum of absolute values, and
  whether a second call equals the first bit for bit.
- ``ab``: the kernel's time against PyTorch's index backward
  (``library_ms``: what autograd ran for the index, ``index_put_`` with
  accumulation into zeros, plus the bias's ``sum`` over the rows) and the
  plain twin (``embed_grad_twin``, ``index_add_`` on the card), and the
  bound: the gradient's, the indices' and the outputs' bytes over 3.35 TB/s.
  CUDA-event windows of 20 calls in the order library, kernel, kernel,
  library, three times; medians.  ``warm`` reads one gradient again and
  again (it stays in the 50 MB L2, as the update's freshly written gradient
  partly does); ``cold`` turns over four gradients (134 MB).
- ``update``: the kernel inside the taxi cell's update (:func:`update`).

Every line it prints is a measurement of this run; the first line is the
card's name and power limit as ``nvidia-smi`` gives them.  No launch here
is counted.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

SECTIONS = ("check", "ab", "update")
N, N_OBS, HIDDEN = 131072, 320, 64
LAWS = ("uniform", "concentrated", "one")
HBM_BYTES_PER_S = 3.35e12
WINDOW = 20


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def inputs(law: str, dev, dtype=torch.float32, seed: int = 0, n: int = N_OBS,
           H: int = HIDDEN, rows: int = N):
    """``(grad [rows, H], idx [rows] int32)`` under ``law``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(rows, H, generator=gen, device=dev).to(dtype)
    if law == "one":
        idx = torch.full((rows,), n // 3, dtype=torch.int32, device=dev)
    else:
        idx = torch.randint(0, n, (rows,), generator=gen, device=dev, dtype=torch.int32)
        if law == "concentrated":
            hot = torch.rand(rows, generator=gen, device=dev) < 0.9
            few = torch.randint(0, 8, (rows,), generator=gen, device=dev,
                                dtype=torch.int32) * (n // 8)
            idx = torch.where(hot, few, idx)
    return g, idx


def exact(g: torch.Tensor, idx: torch.Tensor, n: int):
    """The float64 sums of the rows and of their absolute values, on the
    CPU: ``(gw, gb, |gw|, |gb|)`` in the kernel's layouts."""
    g64, i = g.double().cpu(), idx.long().cpu()
    H = g.shape[-1]

    def sums(x):
        w = torch.zeros(n, H, dtype=torch.float64).index_add_(0, i, x)
        return w.t(), x.sum(0)

    return (*sums(g64), *sums(g64.abs()))


def errors(got, g, idx, n):
    """The largest error of the weight's and the bias's gradients, each
    entry's over its sum of absolute values."""
    gw, gb, aw, ab_ = exact(g, idx, n)
    ew = ((got[0].double().cpu() - gw).abs() / aw.clamp_min(1e-300)).max()
    eb = ((got[1].double().cpu() - gb).abs() / ab_.clamp_min(1e-300)).max()
    return float(ew), float(eb)


def check(dev) -> None:
    from ._build import build_log
    from .embed import embed_grad, plan

    g, idx = inputs("uniform", dev)
    embed_grad(g, idx, N_OBS)
    torch.cuda.synchronize()
    for line in build_log("embed").splitlines():
        if "registers" in line or "build" in line or "spill" in line or "smem" in line:
            print("ptxas", line.strip()[:200])
    for law, dtype in [(law, torch.float32) for law in LAWS] + [("uniform", torch.bfloat16)]:
        g, idx = inputs(law, dev, dtype)
        a = embed_grad(g, idx, N_OBS)
        b = embed_grad(g, idx, N_OBS)
        torch.cuda.synchronize()
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        ew, eb = errors(a, g, idx, N_OBS)
        print(f"check {law} {str(dtype)[6:]}: plan {plan(g, idx, N_OBS)}, weight error "
              f"{ew:.3e}, bias error {eb:.3e} (over each sum of |g|), repeat equal {same}")


def _windows(fns, reps: int = 3):
    """Median ms a call of each of ``fns`` (a dict), in windows of WINDOW
    calls in the order first, ..., last, last, ..., first, ``reps`` times."""
    names = list(fns)
    order = names + names[::-1]
    times = {k: [] for k in names}
    for fn in fns.values():
        fn(0)
    torch.cuda.synchronize()
    for _ in range(reps):
        for k in order:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(WINDOW):
                fns[k](i)
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / WINDOW)
    return {k: statistics.median(v) for k, v in times.items()}


def ab(dev) -> None:
    from .embed import embed_grad, embed_grad_twin

    bound_ms = (N * HIDDEN * 4 + N * 4 + (N_OBS + 1) * HIDDEN * 4) / HBM_BYTES_PER_S * 1e3
    print(f"ab bound {bound_ms:.4f} ms (bytes: gradient, indices, outputs)")
    for law in LAWS:
        sets = [inputs(law, dev, seed=s) for s in range(4)]
        for mode in ("warm", "cold"):
            pick = (lambda i: sets[0]) if mode == "warm" else (lambda i: sets[i % 4])

            def library(i):
                g, idx = pick(i)
                w = torch.zeros(N_OBS, HIDDEN, device=dev)
                torch.ops.aten._index_put_impl_(w, (idx.long(),), g, True, True)
                return w, g.sum(0)

            fns = {"library": library,
                   "kernel": lambda i: embed_grad(*pick(i), N_OBS)}
            if law == "uniform":
                fns["twin"] = lambda i: embed_grad_twin(*pick(i), N_OBS)
            ms = _windows(fns)
            print(f"ab {law} {mode}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"; kernel/bound {ms['kernel'] / bound_ms:.2f}, "
                  f"library/kernel {ms['library'] / ms['kernel']:.1f}")


def update(dev, updates: int = 3) -> None:
    """The kernel inside the taxi cell's update: PPO at ``PPOConfig``'s
    defaults on ExtendedHansenTaxi-v4, one update a replay of
    ``make_multi_train_step``'s graph, captured with the port's spans on;
    the kernel's launches a replay and, for each of ``updates`` replays
    traced alone, its two passes' device ms and launches as traced (the
    profiler can drop device events) and the ``ppo.collect`` and
    ``ppo.learn`` spans."""
    from torch.profiler import ProfilerActivity, profile

    import gym_po_tpu_torch as gp
    from gym_po_tpu_torch.agents import ppo
    from gym_po_tpu_torch.utils.profiling import enable_spans, pair_markers, parse_marker

    def ns(e, what):
        fn = getattr(e, f"{what}_ns", None)
        return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")() * 1000)

    env = gp.make("ExtendedHansenTaxi-v4", device=dev)
    cfg = ppo.PPOConfig()
    model, ts = ppo.init_train_state(env, cfg, torch.Generator(device=dev).manual_seed(0))
    enable_spans(True)
    try:
        multi = ppo.make_multi_train_step(env, model, cfg, 1)
        for _ in range(3):
            ts, _ = multi(ts)
        per_replay = sum(k for (_, name), k in multi.graph.launches.items()
                         if name == "embed_grad")
        print(f"update: {per_replay} embed_grad launches a replay (epochs x minibatches "
              f"{cfg.epochs * cfg.minibatches})")
        for i in range(updates):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ts, _ = multi(ts)
                torch.cuda.synchronize()
            passes, marks = {}, []
            for e in prof.profiler.kineto_results.events():
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    continue
                if parse_marker(e.name()) is not None:
                    marks.append((e.name(), ns(e, "start"), ns(e, "duration")))
                for name in ("embed_grad_rows", "embed_grad_sum", "indexing_backward"):
                    if name in e.name():
                        t, k = passes.get(name, (0, 0))
                        passes[name] = (t + ns(e, "duration"), k + 1)
            try:
                spans = pair_markers(marks)
                halves = ", ".join(f"{k} {(b - a) / 1e6:.2f} ms" for k in ("ppo.collect", "ppo.learn")
                                   for a, b in spans.get(k, ()))
            except ValueError as err:  # a device event dropped
                halves = f"spans not paired ({err})"
            print(f"update {i}: " + ", ".join(
                f"{k} {t / 1e6:.4f} ms in {n} launches ({t / 1e3 / n:.2f} us each)"
                for k, (t, n) in passes.items()) + f"; {halves}")
    finally:
        enable_spans(False)


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(_nvidia_smi("name,power.limit"), flush=True)
    for name in argv or SECTIONS:
        if name not in SECTIONS:
            raise SystemExit(f"unknown section {name!r}; sections: {', '.join(SECTIONS)}")
        {"check": check, "ab": ab, "update": update}[name](dev)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
