"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/gym_po_tpu_torch/`` at the repository root and loaded with
``ctypes``.  The library's file name carries a hash of the sources (the
``.cu`` and every ``csrc/*.cuh``) and of the flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs at import:
this module imports on a machine with no ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "load_source", "build_log", "count_launch",
           "take_captured", "count_replay", "LAUNCHES", "BUILD_DIR", "CSRC"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gym_po_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Launches of each kernel in this process, by source name: every wrapper adds
# one where it launches its kernel, and nowhere else, so that a run can show
# that a path went through the kernels (chip_smoke.py zeroes it before a path
# and reads it after).
LAUNCHES: collections.Counter = collections.Counter()


# A launch made under CUDA-graph capture is recorded into the graph, not
# run: it is set aside here, and counted where the graph replays it.
_CAPTURED: collections.Counter = collections.Counter()


def count_launch(run, name: str) -> None:
    """Record one launch of kernel ``name`` by wrapper ``run``: its own
    ``run.launches`` and the process-wide :data:`LAUNCHES`.  Under
    CUDA-graph capture the launch is set aside for :func:`take_captured`
    instead."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        _CAPTURED[run, name] += 1
        return
    run.launches += 1
    LAUNCHES[name] += 1


def take_captured() -> collections.Counter:
    """The launches set aside under capture since the last call, by
    (wrapper, kernel name); clears them.  Call it before a capture and
    after it, and pass the second result to :func:`count_replay` at each
    replay of the graph."""
    taken = _CAPTURED.copy()
    _CAPTURED.clear()
    return taken


def count_replay(captured: collections.Counter) -> None:
    """Count the launches of one replay of a graph that recorded
    ``captured`` (:func:`take_captured`)."""
    for (run, name), n in captured.items():
        run.launches += n
        LAUNCHES[name] += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    current build of ``name``, with the build's wall time."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hashed library is missing; load it."""
    return _load(CSRC / f"{name}.cu", _library_path(name))


def load_source(stem: str, source: str) -> ctypes.CDLL:
    """Build a generated CUDA source, written to
    ``build/gym_po_tpu_torch/<stem>-<hash>.cu``, if its hashed library is
    missing; load it."""
    h = hashlib.sha256(source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    src = out.with_suffix(".cu")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = src.with_name(f"{src.stem}.{os.getpid()}.tmp.cu")
        tmp.write_text(source)
        os.replace(tmp, src)
    return _load(src, out)


def _load(src: Path, out: Path) -> ctypes.CDLL:
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(
            f"build {time.perf_counter() - t0:.2f} s: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return ctypes.CDLL(str(out))
