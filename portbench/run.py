"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: builds the cell's program state from the
seed (its set-up: kernel libraries loaded from ``build/``, weights and
inputs made on the card, every shape warmed up), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
then ``checks``).  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
a short profiled stretch after the window.  Exits non-zero with no
result line where there is no card, too few cards, no program in the
checkout, or a module of JAX or the JAX package loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX through a
    library that would load it by itself."""
    build = _ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(_ROOT))


def run_cell(spec, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """Set up, measure, trace and check one run of a cell; returns
    ``(line, checks)``."""
    import torch

    from portbench import core

    torch.set_num_threads(2)
    try:
        import gym_po_tpu_torch
    except ImportError as e:
        raise core.CellError(f"the program is not in this checkout: {e}") from e
    if not core.program_root_ok(gym_po_tpu_torch):
        raise core.CellError(f"gym_po_tpu_torch loaded from outside the checkout: "
                             f"{gym_po_tpu_torch.__file__}")
    traffic, config = spec["traffic"], spec["config"]
    cell = core.driver(traffic["kind"]).Cell(spec, seed, torch.device(device))
    setup_s = core.process_age_s()
    cuda = torch.device(device).type == "cuda"
    win = core.run_window(cell.enqueue, seconds, torch, cuda)
    cell.close_window()
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1 if cuda else 0,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    reduced = None
    if trace and cuda:
        reduced = core.reduce_trace(core.traced_stretch(cell.enqueue,
                                                        cell.trace_units, torch))
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    bad = core.forbidden_modules()
    if bad:
        raise core.CellError(f"modules of JAX or the JAX package are loaded: {bad}")
    rec = {"setup_s": setup_s, "window": win, "trace": reduced,
           "floor": core.floor_of(spec["cell"]["config"], traffic["kind"],
                                  config, traffic),
           "peaks": core.peaks(kind), "kind": kind,
           "cell": spec["cell"]["name"], "config": config, "traffic": traffic,
           "unit_work": cell.unit_work}
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = core.read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = cell.check()
    failed = sum(not core.check_ok(c) for c in checks)
    breakdown = None
    if reduced is not None:
        breakdown = {"device_ops": [[k, v] for k, v in reduced["device_ops"]],
                     "idle_gaps": [[k, v] for k, v in reduced["idle_gaps"]]}
    line = core.result_line(failed == 0, win["units"], cell.failed_units(checks),
                            metrics, dev, checks, breakdown)
    return line, checks


def main(argv=None) -> int:
    _environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import core

    try:
        spec = core.cell_spec(core.benchmark(), args.workload)
        import torch

        chips = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise core.CellError(f"the cell needs {chips} CUDA device(s); "
                                 f"{torch.cuda.device_count()} available")
        line, checks = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    except core.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for c in checks:
        ok = "ok" if core.check_ok(c) else "FAILED"
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
