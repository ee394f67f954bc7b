"""Host-side taxi map compiler (NumPy only).

A copy of :mod:`gym_po_tpu.maps.taxi_maps`: importing that module runs
``gym_po_tpu/__init__.py``, which imports jax and flax, so the PyTorch port
carries its own copy.  ``tests/test_torch_taxi.py`` holds the two copies'
tables equal, array for array.

Compiles the ASCII taxi maps into dense lookup tables so that the on-device
step is nothing but integer gathers (TPU speed-of-light for this workload):

* ``next_s[s, a]``   — full tabular transition over the encoded state space
* ``event[s, a]``    — move classification (none / goal dropoff / pickup / bad)
* ``hansen_obs[s]``  — precomputed Hansen partial observation per state
* ``valid_init``     — encoded states valid as episode starts

Semantics are re-derived from the reference implementation
(``gym_po/envs/extended_taxi.py`` of gym-po-taxi):

* map border + pseudo-wall handling: reference ``extended_taxi.py:57-70``
* Hansen 4-bit wall code (N=1, S=2, W=4, E=8): reference ``:102-114``
* state codec ``((r*cols + c)*(nlocs+1) + p)*nlocs + d``: reference ``:84-99``
* movement/collision incl. "crossed pseudo-wall" test: reference ``:248-259``
* pickup/dropoff/bad classification: reference ``:264-273``
* valid initial state enumeration: reference ``:205-218``
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np

__all__ = [
    "TAXI_MAP",
    "EXTENDED_TAXI_MAP",
    "TaxiTables",
    "compile_taxi_map",
    "encode_state_np",
    "decode_state_np",
]

# Event codes for `event[s, a]`
EV_NONE = 0
EV_GOAL = 1
EV_PICKUP = 2
EV_BAD = 3

# Classic 5x5 taxi map with ':' pseudo-walls (reference extended_taxi.py:26-32)
TAXI_MAP = (
    "R: | : :G",
    " : | : : ",
    " : : : : ",
    " | : | : ",
    "Y| : |B: ",
)

# Extended 8x8 taxi map (reference extended_taxi.py:45-54)
EXTENDED_TAXI_MAP = (
    "R  |   G",
    "   |    ",
    "   |    ",
    "        ",
    "        ",
    "  |  |  ",
    "  |  |  ",
    "Y |  |B ",
)

# Movement deltas: North, South, West, East, Pickup/Dropoff
# (reference extended_taxi.py:154)
ACTIONS_YX = np.array([[-1, 0], [1, 0], [0, -1], [0, 1], [0, 0]], dtype=np.int64)
NUM_ACTIONS = 5


def encode_state_np(r, c, p, d, cols: int, nlocs: int):
    """Reference extended_taxi.py:97-99."""
    return ((r * cols + c) * (nlocs + 1) + p) * nlocs + d


def decode_state_np(s, cols: int, nlocs: int):
    """Reference extended_taxi.py:84-94."""
    d = s % nlocs
    tmp = s // nlocs
    p = tmp % (nlocs + 1)
    tmp = tmp // (nlocs + 1)
    c = tmp % cols
    r = tmp // cols
    return r, c, p, d


def _convert_map(map_rows: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, Callable]:
    """Pad a '|' border; extract the navigable sub-grid (stride-2 columns when
    ':' pseudo-walls are present) plus reduced->bordered coordinate mapping.
    Reference extended_taxi.py:57-70."""
    bordered = np.pad(np.asarray(map_rows, dtype="c").astype(str), 1, constant_values="|")
    if ":" in bordered:
        return bordered, bordered[1:-1, 1:-1:2], lambda r, c: (r + 1, (2 * c) + 1)
    return bordered, bordered[1:-1, 1:-1], lambda r, c: (r + 1, c + 1)


@dataclasses.dataclass(frozen=True)
class TaxiTables:
    """Compiled device-constant tables for one taxi map."""

    rows: int
    cols: int
    nlocs: int
    ns: int  # encoded state-space size: rows*cols*(nlocs+1)*nlocs
    next_s: np.ndarray  # [ns, 5] int32 tabular transition
    event: np.ndarray  # [ns, 5] int32 in {EV_NONE, EV_GOAL, EV_PICKUP, EV_BAD}
    hansen_obs: np.ndarray  # [ns] int32 Hansen-coded partial observation
    valid_init: np.ndarray  # [nv] int32 encoded valid initial states
    state_distribution: np.ndarray  # [ns] float64 (parity-mode multinomial dist)
    np_locs: np.ndarray  # [nlocs+1, 2] pickup/dropoff cells (+ sentinel row)
    hansen_grid: np.ndarray  # [rows, cols] 4-bit wall code per cell
    desc: np.ndarray  # bordered char map (render/debug)
    tgrid: np.ndarray  # navigable char grid
    n_hansen_obs: int  # 2**4 * nlocs * (nlocs+1)


def compile_taxi_map(map_rows: Sequence[str] = TAXI_MAP) -> TaxiTables:
    desc, tgrid, cc = _convert_map(map_rows)
    rows, cols = tgrid.shape
    iswall = desc == "|"

    # Hansen wall-code grid (reference extended_taxi.py:102-114)
    rr, cts = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    br, bc = cc(rr, cts)
    hansen_grid = (
        iswall[br - 1, bc].astype(np.int64)
        + 2 * iswall[br + 1, bc]
        + 4 * iswall[br, bc - 1]
        + 8 * iswall[br, bc + 1]
    )

    # Landmark locations (reference extended_taxi.py:117-118,182-185)
    locs = np.nonzero((tgrid != "|") & (tgrid != " ") & (tgrid != ":"))
    np_locs = np.array(locs).T
    nlocs = np_locs.shape[0]
    np_locs = np.concatenate((np_locs, [[-1, -1]]))  # sentinel "in taxi" row

    ns = rows * cols * (nlocs + 1) * nlocs
    s_all = np.arange(ns, dtype=np.int64)
    r, c, p, d = decode_state_np(s_all, cols, nlocs)

    # -------------------------------------------------------- movement table
    # Per-cell blocked mask for the 4 movement actions.
    next_s = np.empty((ns, NUM_ACTIONS), dtype=np.int64)
    event = np.full((ns, NUM_ACTIONS), EV_NONE, dtype=np.int64)
    for a in range(4):
        dy, dx = ACTIONS_YX[a]
        rn = np.clip(r + dy, 0, rows - 1)
        cn = np.clip(c + dx, 0, cols - 1)
        brn, bcn = cc(rn, cn)
        blocked = iswall[brn, bcn]
        if dx != 0:
            # crossed-pseudo-wall test (reference extended_taxi.py:256-259)
            blocked = blocked | iswall[brn, bcn - dx]
        r2 = np.where(blocked, r, rn)
        c2 = np.where(blocked, c, cn)
        next_s[:, a] = encode_state_np(r2, c2, p, d, cols, nlocs)

    # ------------------------------------------------- pickup/dropoff action
    tloc = np.stack([r, c], -1)  # [ns, 2]
    at_dest = (np_locs[d] == tloc).all(-1)
    goal = (p == nlocs) & at_dest
    at_pass = (np_locs[np.minimum(p, nlocs)] == tloc).all(-1)
    pickup = (p < nlocs) & at_pass
    p2 = np.where(pickup, nlocs, p)
    next_s[:, 4] = encode_state_np(r, c, p2, d, cols, nlocs)
    event[:, 4] = np.where(goal, EV_GOAL, np.where(pickup, EV_PICKUP, EV_BAD))

    # --------------------------------------------------- valid initial states
    # Same enumeration order as reference extended_taxi.py:205-218.
    valid = np.array(
        [
            encode_state_np(rr_, cc_, pp_, dd_, cols, nlocs)
            for rr_ in range(rows)
            for cc_ in range(cols)
            if tgrid[rr_, cc_] != "|"
            for pp_ in range(nlocs)
            for dd_ in range(nlocs)
            if dd_ != pp_
        ],
        dtype=np.int64,
    )
    dist = np.zeros(ns, dtype=np.float64)
    dist[valid] += 1
    dist /= dist.sum()

    # ------------------------------------------------------ Hansen obs table
    # (reference extended_taxi.py:370-372)
    hansen_obs = (hansen_grid[r, c] * (nlocs + 1) + p) * nlocs + d

    return TaxiTables(
        rows=rows,
        cols=cols,
        nlocs=nlocs,
        ns=ns,
        next_s=next_s.astype(np.int32),
        event=event.astype(np.int32),
        hansen_obs=hansen_obs.astype(np.int32),
        valid_init=valid.astype(np.int32),
        state_distribution=dist,
        np_locs=np_locs,
        hansen_grid=hansen_grid,
        desc=desc,
        tgrid=tgrid,
        n_hansen_obs=int(2**4 * nlocs * (nlocs + 1)),
    )
