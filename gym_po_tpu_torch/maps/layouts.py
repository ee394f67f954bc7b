"""ROOMS layout bank loader and grid compiler (NumPy only).

A copy of :mod:`gym_po_tpu.maps.layouts`: importing that module runs
``gym_po_tpu/__init__.py``, which imports jax, so the PyTorch port carries
its own copy, with its own copy of ``data/rooms_layouts.txt`` (domain data
from the hplanning ROOMS domains).  ``tests/test_torch_rooms.py`` holds the
two copies' grids, starts and ends equal.

Compiler semantics re-derived from reference
``gym_po/envs/rooms/layouts.py:217-232``: wall char ``x`` -> -1, every other
distinct char -> a dense room id assigned in sorted-unique order.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "LAYOUT_NAMES",
    "load_layout_bank",
    "layout_rows",
    "layout_grid",
    "layout_start",
    "layout_end",
    "WALL",
]

WALL = -1
_DATA = Path(__file__).parent / "data" / "rooms_layouts.txt"


@functools.lru_cache(maxsize=1)
def load_layout_bank() -> Tuple[Dict[str, List[str]], Dict[str, Tuple[int, int]],
                                Dict[str, Tuple[int, int]]]:
    layouts: Dict[str, List[str]] = {}
    starts: Dict[str, Tuple[int, int]] = {}
    ends: Dict[str, Tuple[int, int]] = {}
    section = None
    for line in _DATA.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1]
            if section not in ("STARTS", "ENDS"):
                layouts[section] = []
            continue
        if section == "STARTS":
            k, y, x = line.split()
            starts[k] = (int(y), int(x))
        elif section == "ENDS":
            k, y, x = line.split()
            ends[k] = (int(y), int(x))
        else:
            layouts[section].append(line)
    return layouts, starts, ends


LAYOUT_NAMES = ("1", "2", "4", "4b", "8", "8b", "10", "10b", "16", "16b", "32", "32b")


def layout_rows(name: str) -> List[str]:
    layouts, _, _ = load_layout_bank()
    return layouts[name]


def layout_grid(name: str) -> np.ndarray:
    """Char layout -> int grid: wall=-1, rooms=0..R-1 (sorted-char order)."""
    rows = layout_rows(name)
    chars = np.asarray(rows, dtype="c").astype("U")
    uniq = np.unique(chars)
    room_chars = uniq[uniq != "x"]
    grid = np.full(chars.shape, WALL, dtype=np.int64)
    for i, ch in enumerate(room_chars):
        grid[chars == ch] = i
    return grid


def _base_name(name: str) -> str:
    # 'b' variants share STARTS/ENDS with their base layout
    # (reference rooms.py:122-123)
    return name[:-1] if name.endswith("b") else name


def layout_start(name: str) -> Tuple[int, int]:
    _, starts, _ = load_layout_bank()
    return starts[_base_name(name)]


def layout_end(name: str) -> Tuple[int, int]:
    _, _, ends = load_layout_bank()
    return ends[_base_name(name)]
