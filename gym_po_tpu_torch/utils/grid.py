"""Grid coordinate utilities, a copy of :mod:`gym_po_tpu.utils.grid`
(NumPy only; the parity surface for the reference's grid_utils).

Equivalents of the reference's public helpers (reference
``gym_po/envs/grid_utils.py:18-119``):

* direction constant banks (2-D and 3-D unit moves);
* neighbor-index generators (``surrounding_indices`` for an n-ring window,
  ``hansen_indices`` for the 4 cardinal neighbors) — used by renderers and
  user highlighting code;
* flat ↔ coordinate converters for a given grid shape.

These are host-side NumPy functions (precompute/render territory); the
device-side equivalents live in the compiled env tables.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = [
    "DIRECTIONS_2D",
    "DIRECTIONS_3D",
    "surrounding_indices",
    "hansen_indices",
    "flat_to_coord",
    "coord_to_flat",
]

# [2, 8] bank: N, S, W, E, NW, NE, SW, SE as (dy, dx) columns
# (reference grid_utils.py DIRECTIONS_2D_NP, :8-20)
DIRECTIONS_2D = np.array(
    [[-1, 0], [1, 0], [0, -1], [0, 1], [-1, -1], [-1, 1], [1, -1], [1, 1]],
    np.int64,
).T
# [3, 10] bank: N, S, W, E, upstairs, downstairs, NW, NE, SW, SE as
# (dz, dy, dx) columns (reference DIRECTIONS_3D_NP, :23-38)
DIRECTIONS_3D = np.array(
    [
        [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1],
        [1, 0, 0], [-1, 0, 0],
        [0, -1, -1], [0, -1, 1], [0, 1, -1], [0, 1, 1],
    ],
    np.int64,
).T


def _at_least_2d(coordinate: np.ndarray) -> np.ndarray:
    coordinate = np.asarray(coordinate)
    return coordinate[:, None] if coordinate.ndim == 1 else coordinate


def surrounding_indices(coordinate: np.ndarray, surround: int = 1) -> np.ndarray:
    """All coordinates within an n-ring of each input coordinate
    (reference grid_utils.py:43-61; center excluded, z fixed for 3-D).

    Args:
        coordinate: [ndim] or [ndim, ncoord].
    Returns:
        [ndim, ncoord, n_ring_cells] index array.
    """
    coordinate = _at_least_2d(coordinate)
    if not surround:
        return coordinate[..., None]
    ndim, ncoord = coordinate.shape
    span = np.arange(-surround, surround + 1)
    if ndim == 2:
        g = np.stack(np.meshgrid(span, span, indexing="ij"))
    else:
        g = np.stack(np.meshgrid(np.arange(1), span, span, indexing="ij"))
    g = g.reshape(ndim, -1)
    g = g[:, (g[-2:] != 0).any(0)]  # drop the center cell
    return (g[:, None] + coordinate[..., None]).reshape(ndim, ncoord, -1)


def hansen_indices(coordinate: np.ndarray) -> np.ndarray:
    """The 4 cardinal neighbors of each input coordinate
    (reference grid_utils.py:64-77).

    Returns [ndim, ncoord, 4].
    """
    coordinate = _at_least_2d(coordinate)
    ndim, ncoord = coordinate.shape
    g = np.array([[-1, 1, 0, 0], [0, 0, -1, 1]], np.int64)  # N, S, W, E
    if ndim == 3:
        g = np.concatenate([np.zeros((1, 4), np.int64), g])
    return (g[:, None] + coordinate[..., None]).reshape(ndim, ncoord, -1)


def flat_to_coord(grid_shape: Sequence[int]) -> Callable[[np.ndarray], np.ndarray]:
    """Flat cell index -> [ndim, ...] coordinates (reference :80-91)."""

    def f(flat):
        return np.array(np.unravel_index(np.asarray(flat), grid_shape))

    return f


def coord_to_flat(grid_shape: Sequence[int]) -> Callable[..., np.ndarray]:
    """[ndim, ...] coordinates -> flat cell index, wrap mode
    (reference :109-119)."""

    def f(coords):
        return np.ravel_multi_index(tuple(np.asarray(coords)), grid_shape, mode="wrap")

    return f
