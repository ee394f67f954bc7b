"""Measurement probe of the ant's scalar-forward kernels on a CUDA device.

    python -m gym_po_tpu_torch.ops.probe_ant_forward [ab --parent DIR] [parts]

Run from the repository's root: it takes its states, bounds and helpers
from ``chip_smoke.py``'s path 9.

Sections:

- ``ab``: the parent's ``ant_smooth`` and ``ant_newton`` (whose solve the
  current ``ant_smooth`` shares) built from ``--parent DIR`` (a ``csrc``
  directory unpacked by ``mkdir -p build/ant_parent && git archive b6d2ef9
  gym_po_tpu_torch/csrc | tar -x -C build/ant_parent
  --strip-components=2``; its C interface, ``ant_newton`` with no
  active-rows counter, is checked in the source) against the current
  kernels in one process, each side launched alike through its library's
  C entry point, the current ``ant_newton`` with its counter null (its
  build without the count) and, as ``counted``, with a counter (its
  counting build, as while the port's spans are on), on
  ``chip_smoke.py``'s timed inputs: ``ant_contact_states`` of each arena
  at B = 4,096 f32.  CUDA-event windows of 100 launches in the order
  parent, current[, counted, counted], current, parent, twice; their
  medians and the ratios current/parent and counted/current.  The two
  ``ant_smooth``s' outputs (M, qacc_smooth, the kinematics) are compared,
  the ``ant_newton``s' on the same inputs bit for bit, and the counter
  against the launches times the active rows.  First, the parent's
  registers, stack frame and spills from ptxas.
- ``parts``: where ``ant_smooth``'s time goes.  Copies of the current
  ``ant_forward.cu`` with one step of the per-env work cut out (FK, the
  kinematics, the mass matrix, the bias force, the solve; ``io``: all of
  them, leaving the block's staging of inputs and outputs) are built in
  parallel and timed beside the full kernel on the same inputs (the tag
  arena's contact states, B = 4,096 f32), windows of 100 launches in the
  order full, each cut, full, twice; a step's share is the full kernel's
  median less its cut copy's.  The cut copies' outputs are not used.

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

SECTIONS = ("ab", "parts")
# parts: the text each cut copy of ant_forward.cu leaves out of ant_smooth's
# per-env function, from the first marker up to the second (not included)
_SOLVE = "  chol_solve_warp(s + SE_H"
_END = "}\n\n// One warp per env, W consecutive envs a block."
PARTS = {
    "fk": ("  // ---- FK (_fk_s)", "  // ---- kinematics_s"),
    "kinematics": ("  // ---- kinematics_s", "  // ---- mass_matrix_s"),
    "mass": ("  // ---- mass_matrix_s", "  // ---- bias_force_s"),
    "bias": ("  // ---- bias_force_s", "  // ---- qacc_smooth"),
    "solve": (_SOLVE, _END),
    "io": ("  // ---- FK (_fk_s)", _END),
}
# the parent's launchers: ant_smooth's with the tree table, ant_newton's
# with no active-rows counter (this probe's ctypes interface is theirs)
PARENT_SIGNATURES = ("int ant_smooth_launch(int dtype, int B, const void* mdl, "
                     "const void* tab,",
                     "void* warm_out, void* stream) {")


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
    text = src.read_text()
    if not all(sig in text for sig in PARENT_SIGNATURES):
        raise SystemExit(f"{src}: not the launchers' C interface before the "
                         "active-rows counter (git archive b6d2ef9 "
                         "gym_po_tpu_torch/csrc)")
    out = BUILD_DIR / "probe" / "ant_forward_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    pv, i = ctypes.c_void_p, ctypes.c_int
    lib.ant_smooth_launch.argtypes = [i, i] + [pv] * 9
    lib.ant_newton_launch.argtypes = [i] * 5 + [pv] * 11
    lib.ant_smooth_launch.restype = lib.ant_newton_launch.restype = i
    return lib, f"built in {time.perf_counter() - t0:.2f} s\n{proc.stdout}{proc.stderr}"


def ab(parent: str) -> None:
    import chip_smoke as cs

    from . import ant_forward as af
    from ._build import build_log

    lib, log = parent_library(Path(parent))
    print(f"parent ant_forward.cu {log.splitlines()[0]}, by kernel: "
          f"{cs.ptxas_summary(log)}", flush=True)
    af._lib()
    print("current ant_forward.cu by kernel: "
          f"{cs.ptxas_summary(build_log('ant_forward'))}", flush=True)
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
        psm, csm = (af.Smooth(*(torch.empty_like(x) for x in sm)) for _ in range(2))
        pout, cout = ([torch.empty_like(x) for x in got] for _ in range(2))

        def launched(err, name):
            if err:
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")

        # both sides launched alike, through their libraries' C entry points
        def smooth_of(lib_, out):
            return lambda i: launched(lib_.ant_smooth_launch(
                0, B, p.model.data_ptr(), p.smooth_table.data_ptr(), q.data_ptr(),
                v.data_ptr(), c.data_ptr(), *(x.data_ptr() for x in out), st),
                "ant_smooth")

        def newton_of(lib_, out, *counter):
            return lambda i: launched(lib_.ant_newton_launch(
                0, B, p.ne, 8, 10, p.tables.data_ptr(), sm.M.data_ptr(),
                sm.qacc_smooth.data_ptr(), *(x.data_ptr() for x in rows),
                w.data_ptr(), *(x.data_ptr() for x in out), *counter, st), "ant_newton")

        # "counted": the current ant_newton's build that counts the active
        # rows (the pointer set, as while the port's spans are on)
        rows_count = torch.zeros((), dtype=torch.int64, device=dev)
        kout = [torch.empty_like(x) for x in got]
        calls = {"ant_smooth": {"parent": smooth_of(lib, psm),
                                "current": smooth_of(af._lib(), csm)},
                 "ant_newton": {"parent": newton_of(lib, pout),
                                "current": newton_of(af._lib(), cout, None),
                                "counted": newton_of(af._lib(), kout,
                                                     rows_count.data_ptr())}}
        times = {k: {who: [] for who in fns} for k, fns in calls.items()}
        with cs.uncounted():
            for k, fns in calls.items():
                for fn in fns.values():  # warm-up
                    fn(0)
                for who in (list(fns) + list(fns)[::-1]) * 2:
                    times[k][who].append(cs.event_windows(fns[who], 1, 100))
        torch.cuda.synchronize(dev)
        launches = 1 + len(times["ant_newton"]["counted"]) * 100
        active = int(torch.count_nonzero(rows.active))
        diff = {name: cs._rel_abs(a, b)[0]
                for name, a, b in zip(af.Smooth._fields, psm, csm)}
        same = all(torch.equal(a, b) for a, b in zip(pout, cout))
        counted_same = all(torch.equal(a, b) for a, b in zip(kout, cout))
        bounds = cs.ant_kernel_bounds(model, p, rows, 8, 10)
        parts = []
        for k, t in times.items():
            med = {who: statistics.median(x) for who, x in t.items()}
            counted = (f", counted {med['counted']:.4f} ms, counted/current "
                       f"{med['counted'] / med['current']:.4f}"
                       if "counted" in med else "")
            parts.append(f"{k} parent {med['parent']:.4f} ms, current "
                         f"{med['current']:.4f} ms, current/parent "
                         f"{med['current'] / med['parent']:.4f}{counted}, bound "
                         f"{bounds[k][0]:.4f} ms by {bounds[k][1]} (windows "
                         + "; ".join(f"{who} " + ", ".join(f"{x:.4f}" for x in xs)
                                     for who, xs in t.items()) + ")")
        print(f"ab {env_id} B={B} f32, 8 iterations, 10 bisections, medians of 4 "
              "windows of 100 launches: " + ", ".join(parts) + "; the parent's "
              "ant_smooth outputs vs the current, relative to max(1, |x|): "
              + ", ".join(f"{k} {x:.3e}" for k, x in diff.items())
              + f"; the parent's ant_newton on the same inputs "
              f"{'equal to' if same else 'NOT equal to'} the current's, bit "
              f"for bit; the counted build's {'equal to' if counted_same else 'NOT equal to'}"
              f" the current's, its counter {int(rows_count)} over {launches} launches "
              f"against {active} active rows a launch "
              f"({'equal' if int(rows_count) == launches * active else 'NOT equal'})",
              flush=True)


def _cut(text: str, start: str, end: str) -> str:
    if text.count(start) != 1 or text.count(end) != 1:
        raise SystemExit(f"the markers {start!r}, {end!r} are not unique in "
                         "ant_forward.cu")
    i = text.index(start)
    return text[:i] + text[text.index(end, i):]


def parts() -> None:
    import chip_smoke as cs

    from . import ant_forward as af
    from ._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

    text = (CSRC / "ant_forward.cu").read_text()
    out = BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (start, end) in PARTS.items():
        src = out / f"ant_forward_cut_{name}.cu"
        src.write_text(_cut(text, start, end))
        procs[name] = (src, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        lib.ant_smooth_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
        lib.ant_smooth_launch.restype = ctypes.c_int
        libs[name] = lib
        print(f"cut {name}: {cs.ptxas_summary(log)}", flush=True)
    dev, B = torch.device("cuda", 0), cs.B_ANT
    env_id, model = next(iter(cs._ant_models().items()))
    q, v, c, _ = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                  for x in cs.ant_contact_states(B, 21, walls=True))
    p = af._plan(model, torch.float32, dev)
    st = torch.cuda.current_stream(dev).cuda_stream
    with cs.uncounted():
        sm = af.ant_smooth(model, q, v, c)
    scratch = af.Smooth(*(torch.empty_like(x) for x in sm))

    def cut(lib):
        def run(i):
            err = lib.ant_smooth_launch(
                0, B, p.model.data_ptr(), p.smooth_table.data_ptr(), q.data_ptr(),
                v.data_ptr(), c.data_ptr(), *(x.data_ptr() for x in scratch), st)
            if err:
                raise RuntimeError(f"a cut ant_smooth launch failed: CUDA error {err}")
        return run

    fns = {"full": lambda i: af.ant_smooth(model, q, v, c, out=sm),
           **{name: cut(lib) for name, lib in libs.items()}}
    times = {k: [] for k in fns}
    order = ["full", *libs, "full"]
    with cs.uncounted():
        for fn in fns.values():  # warm-up
            fn(0)
        for who in order * 2:
            times[who].append(cs.event_windows(fns[who], 1, 100))
    med = {k: statistics.median(x) for k, x in times.items()}
    print(f"parts {env_id} B={B} f32, ant_smooth medians of windows of 100 "
          f"launches: full {med['full']:.4f} ms; " + "; ".join(
              f"without {k} {med[k]:.4f} ms (share {med['full'] - med[k]:.4f})"
              for k in PARTS) + " (windows " + "; ".join(
              f"{k} " + ", ".join(f"{x:.4f}" for x in xs)
              for k, xs in times.items()) + ")", flush=True)


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
        {"ab": lambda: ab(parent), "parts": parts}[name]()
    print("clocks after:", _nvidia_smi(
        "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
