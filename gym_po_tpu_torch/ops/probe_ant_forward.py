"""Measurement probe of the ant's scalar-forward kernels on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_ant_forward ab --parent DIR

Run from the repository's root: it takes its states, bounds and helpers
from ``chip_smoke.py``'s path 9.

Sections:

- ``ab``: the one-env-a-thread design's ``ant_rows`` and ``ant_newton``,
  built from ``--parent DIR`` (a ``csrc`` directory unpacked by ``mkdir -p
  build/ant_parent && git archive ffa4c43 gym_po_tpu_torch/csrc | tar -x -C
  build/ant_parent --strip-components=2``; its C interface, with the
  solve's four ``[ne, B]`` scratch buffers, is checked in the source)
  against the current kernels in one process, on ``chip_smoke.py``'s timed
  inputs: ``ant_contact_states`` of each arena at B = 4,096 f32, 8
  iterations and 10 bisections.  CUDA-event windows of 20 launches in the
  order parent, current, current, parent, twice; their medians and the
  ratio current/parent.  The two designs' outputs are compared: the rows
  where both set the same flags, the solves on the current rows.  First,
  the parent's registers, stack frame and spills from ptxas.

Every line it prints is a measurement of this run; the first line is the
card's name and power limit as ``nvidia-smi`` gives them.  No launch here
is counted.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SECTIONS = ("ab",)
# the parent's ant_newton_launch ends with the solve's scratch: this
# probe's ctypes interface is that one
PARENT_SIGNATURE = "void* warm_out, void* s_idx, void* s_D, void* s_slack,"


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def parent_library(parent: Path):
    """``(library, nvcc's output)`` of ``parent/ant_forward.cu`` built with
    the port's nvcc flags into ``build/gym_po_tpu_torch/probe/``."""
    from ._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    src = parent / "ant_forward.cu"
    if PARENT_SIGNATURE not in src.read_text():
        raise SystemExit(f"{src}: not the one-env-a-thread design's C interface "
                         "(git archive ffa4c43 gym_po_tpu_torch/csrc)")
    out = BUILD_DIR / "probe" / "ant_forward_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    pv, i = ctypes.c_void_p, ctypes.c_int
    lib.ant_rows_launch.argtypes = [i] * 4 + [pv] * 10
    lib.ant_newton_launch.argtypes = [i] * 5 + [pv] * 15
    lib.ant_rows_launch.restype = lib.ant_newton_launch.restype = i
    return lib, f"built in {time.perf_counter() - t0:.2f} s\n{proc.stdout}{proc.stderr}"


def ab(parent: str) -> None:
    import chip_smoke as cs

    from . import ant_forward as af

    lib, log = parent_library(Path(parent))
    print(f"parent ant_forward.cu {log.splitlines()[0]}, by kernel: "
          f"{cs.ptxas_summary(log)}", flush=True)
    dev, B = torch.device("cuda", 0), cs.B_ANT
    for env_id, model in cs._ant_models().items():
        q, v, c, w = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                      for x in cs.ant_contact_states(B, 21, walls=True))
        p = af._plan(model, torch.float32, dev)
        st = torch.cuda.current_stream(dev).cuda_stream
        with cs.uncounted():
            sm = af.ant_smooth(model, q, v, c)
            rows = af.ant_rows(model, sm.skin, q, v)
            got = af.ant_newton(model, sm, rows, w, 8, 10)
        prow = af.Rows(*(torch.empty_like(x) for x in rows))
        pout = [torch.empty_like(x) for x in got]
        scratch = [torch.empty(p.ne, B, dtype=torch.int32, device=dev)] + [
            torch.empty(p.ne, B, device=dev) for _ in range(3)]

        def launched(err, name):
            if err:
                raise RuntimeError(f"the parent's {name} launch failed: CUDA "
                                   f"error {err}")

        def parent_rows(i):
            launched(lib.ant_rows_launch(
                0, B, p.n_slots, p.ne, p.model.data_ptr(), p.tables.data_ptr(),
                sm.skin.data_ptr(), q.data_ptr(), v.data_ptr(),
                *(x.data_ptr() for x in prow), st), "ant_rows")

        def parent_newton(i):
            launched(lib.ant_newton_launch(
                0, B, p.ne, 8, 10, p.tables.data_ptr(), sm.M.data_ptr(),
                sm.qacc_smooth.data_ptr(), *(x.data_ptr() for x in rows),
                w.data_ptr(), *(x.data_ptr() for x in pout),
                *(x.data_ptr() for x in scratch), st), "ant_newton")

        calls = {"ant_rows": {"parent": parent_rows, "current": lambda i: af.ant_rows(
                     model, sm.skin, q, v, out=rows)},
                 "ant_newton": {"parent": parent_newton, "current": lambda i: af.ant_newton(
                     model, sm, rows, w, 8, 10)}}
        times = {k: {"parent": [], "current": []} for k in calls}
        with cs.uncounted():
            for k, fns in calls.items():
                for fn in fns.values():  # warm-up
                    fn(0)
                for who in ("parent", "current", "current", "parent") * 2:
                    times[k][who].append(cs.event_windows(fns[who], 1, 20))
        same = prow.active == rows.active
        d_rows = max(cs._rel_abs(torch.where(same[p.row], prow.vals, rows.vals),
                                 rows.vals)[0],
                     *(cs._rel_abs(torch.where(same, a, b), b)[0]
                       for a, b in ((prow.aref, rows.aref), (prow.r, rows.r))))
        d_newton = max(cs._rel_abs(a, b)[0] for a, b in zip(pout, got))
        bounds = cs.ant_kernel_bounds(model, p, rows, 8, 10)
        parts = []
        for k, t in times.items():
            med = {who: statistics.median(x) for who, x in t.items()}
            parts.append(f"{k} parent {med['parent']:.4f} ms, current "
                         f"{med['current']:.4f} ms, current/parent "
                         f"{med['current'] / med['parent']:.4f}, bound "
                         f"{bounds[k][0]:.4f} ms by {bounds[k][1]} (windows "
                         + "; ".join(f"{who} " + ", ".join(f"{x:.4f}" for x in xs)
                                     for who, xs in t.items()) + ")")
        print(f"ab {env_id} B={B} f32, 8 iterations, 10 bisections, medians of "
              "4 windows of 20 launches: " + ", ".join(parts) + "; the parent's "
              f"outputs vs the current: rows {d_rows:.3e} relative where both "
              f"set the same flags ({int((~same).sum())} flags differ), qacc "
              f"and warm {d_newton:.3e}", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device; none is available")
    argv = list(argv)
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = argv[i + 1]
        del argv[i:i + 2]
    names = argv or list(SECTIONS)
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"unknown section(s) {unknown}; choose from {SECTIONS}")
    if "ab" in names and not parent:
        raise SystemExit("ab needs --parent DIR (the parent's csrc directory)")
    print(_nvidia_smi("name,power.limit"), flush=True)
    for name in names:
        {"ab": lambda: ab(parent)}[name]()
    print("clocks after:", _nvidia_smi(
        "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
