"""Observation models of the rooms family, PyTorch port of
:mod:`gym_po_tpu.obs.observations` (discrete coordinates).

``make_rooms_obs(obs_type, grid, obs_n)`` returns ``(space, obs_fn)`` with
``obs_fn(agent_yx, goal_yx) -> obs`` written over any leading batch axes
(``[..., 2]`` int coordinates in, ``[...]`` or ``[..., k]`` int32 out), where
the JAX package builds single-instance functions for ``vmap``.  Lookups are
native indexing in place of the JAX package's matrix-unit ``table_gather``.
Observation semantics re-derived from reference
``gym_po/envs/rooms/observations.py``:

* discrete state grid: ``((grid>=0).cumsum()-1).reshape(...)`` (``:16-29``)
* room-abstract count: #unique room ids (``:32-41``)
* Hansen scalar: neighbor wall/empty bits · 2^i, × (goal_dir+1) (``:44-71``)
* n×n grid window, out-of-bounds redirected to wall cell (0,0) (``:74-103``)
* Hansen vector: per-neighbor {0 wall, 1 empty, 2 goal} (``:106-131``)

Keyword-flag parsing of ``obs_type`` (substring matching on 'vector', 'goal',
'room', 'mdp', 'hansen'/'hansen8', 'grid', 'lidar') mirrors reference
``rooms.py:19-67``.  Continuous variants (``cell_size`` given) discretize
coordinates by ``floor(x / cell_size)`` before every lookup (reference
``crooms.py:16-88``; ``coord_to_grid`` in ``rooms/utils.py:15-20``); their
'mdp' vector is the raw coordinates.  ``lidar`` (continuous only) is the
JAX package's fixed-count ray march against the wall grid plus the goal
offset: the reference declares it but never implements it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.spaces import Box, Discrete, Space
from ..utils.actions import ACTIONS_CARDINAL, ACTIONS_ORDINAL

__all__ = [
    "n_discrete_states",
    "state_grid",
    "n_room_states",
    "make_rooms_obs",
]


def n_discrete_states(grid: np.ndarray) -> int:
    return int((grid >= 0).sum())


def state_grid(grid: np.ndarray) -> np.ndarray:
    """Dense walkable-cell id per cell (reference observations.py:16-29)."""
    return ((grid >= 0).cumsum() - 1).reshape(grid.shape)


def n_room_states(grid: np.ndarray) -> int:
    """#rooms, ignoring walls (reference observations.py:32-41)."""
    return len(np.unique(grid)) - 1


def make_rooms_obs(
    obs_type: str,
    grid: np.ndarray,
    obs_n: int = 3,
    cell_size: Optional[float] = None,
    device=None,
) -> Tuple[Space, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """Build ``(space, obs_fn(agent, goal) -> obs)`` for a rooms-family grid;
    the lookup tables live on ``device``.

    ``cell_size=None``: discrete (int cell) coordinates.  Otherwise
    continuous coordinates of any float dtype, pre-discretized by
    ``cell_size``."""
    continuous = cell_size is not None
    is_vector = "vector" in obs_type
    has_goal = "goal" in obs_type
    H, W = grid.shape
    grid_flat = torch.as_tensor(grid.reshape(-1), dtype=torch.int32, device=device)

    def flat(yx):
        return (yx[..., 0] * W + yx[..., 1]).long()

    def lookup(table, yx):
        """``table[yx]``, and 0 for a cell outside the grid, as the JAX
        package's one-hot ``table_gather`` reads it: layout '32''s default
        goal lies outside its grid (ROADMAP Queue 3)."""
        i = flat(yx)
        inside = (i >= 0) & (i < table.numel())
        return torch.where(inside, table[i.clamp(0, table.numel() - 1)], 0)

    def grid_at(yx):
        return lookup(grid_flat, yx)

    if continuous:
        def to_cell(x):
            return torch.floor(x / cell_size).to(torch.int32)

        # computed in float64, as the reference's numpy bound
        a_max = np.asarray(grid.shape, np.float64) - 1 - 1e-6
        mdp_low, mdp_dtype = 1.0, torch.float32

        def mdp_vec(x):
            return x  # the raw coordinates, in their own dtype
    else:
        def to_cell(x):
            return x

        a_max = np.asarray(grid.shape, np.int64) - 2
        mdp_low, mdp_dtype = 1, torch.int32

        def mdp_vec(x):
            return x.to(torch.int32)

    if "room" in obs_type:
        n = n_room_states(grid)
        if has_goal:
            space = Discrete(int(n**2))

            def obs(agent, goal):
                return grid_at(to_cell(agent)) + n * grid_at(to_cell(goal))
        else:
            space = Discrete(int(n))

            def obs(agent, goal):
                return grid_at(to_cell(agent))
    elif "mdp" in obs_type:
        if is_vector:
            if has_goal:
                space = Box(mdp_low, np.tile(a_max, 2), (4,), dtype=mdp_dtype)

                def obs(agent, goal):
                    return mdp_vec(torch.cat((agent, goal), -1))
            else:
                space = Box(mdp_low, a_max, (2,), dtype=mdp_dtype)

                def obs(agent, goal):
                    return mdp_vec(agent)
        else:
            n = n_discrete_states(grid)
            sg_flat = torch.as_tensor(state_grid(grid).reshape(-1),
                                      dtype=torch.int32, device=device)
            if has_goal:
                space = Discrete(int(n**2))

                def obs(agent, goal):
                    return (lookup(sg_flat, to_cell(agent))
                            + n * lookup(sg_flat, to_cell(goal)))
            else:
                space = Discrete(int(n))

                def obs(agent, goal):
                    return lookup(sg_flat, to_cell(agent))
    elif "hansen" in obs_type:
        base_n = 8 if "8" in obs_type else 4
        offs = torch.as_tensor(
            ACTIONS_CARDINAL if base_n == 4 else ACTIONS_ORDINAL,
            dtype=torch.int32, device=device)

        def neighbor_vals(agent, goal):
            agent, goal = to_cell(agent), to_cell(goal)
            nb = agent[..., None, :] + offs  # [..., k, 2]
            empty = (grid_at(nb) >= 0).to(torch.int32)
            is_goal = (nb == goal[..., None, :]).all(-1)  # [..., k]
            return empty, is_goal

        if is_vector:
            if has_goal:
                space = Box(0, 2, (base_n,), dtype=torch.int32)

                def obs(agent, goal):
                    empty, is_goal = neighbor_vals(agent, goal)
                    return torch.where(is_goal, 2, empty).to(torch.int32)
            else:
                space = Box(0, 1, (base_n,), dtype=torch.int32)

                def obs(agent, goal):
                    return neighbor_vals(agent, goal)[0]
        else:
            space = Discrete(int(2**base_n * (base_n + 1)))
            mult = torch.as_tensor([2**i for i in range(base_n)],
                                   dtype=torch.int32, device=device)

            def obs(agent, goal):
                empty, is_goal = neighbor_vals(agent, goal)
                code = (empty * mult).sum(-1)
                # first goal neighbour + 1, or 1 without one (argmax of a
                # bool row is its first True)
                goal_mult = torch.where(
                    is_goal.any(-1),
                    is_goal.to(torch.int32).argmax(-1) + 1, 1)
                return (code * goal_mult).to(torch.int32)
    elif "grid" in obs_type:
        space = Box(0, 2, (obs_n, obs_n), dtype=torch.int32)
        off = obs_n // 2
        mg = np.mgrid[:obs_n, :obs_n] - off  # [2, n, n]
        mg_t = torch.as_tensor(mg.reshape(2, -1).T, dtype=torch.int32,
                               device=device)  # [n*n, 2]

        def obs(agent, goal):
            agent, goal = to_cell(agent), to_cell(goal)
            coords = agent[..., None, :] + mg_t  # [..., n*n, 2]
            oob = ((coords[..., 0] < 0) | (coords[..., 1] < 0)
                   | (coords[..., 0] >= H) | (coords[..., 1] >= W))
            # invalid coords redirect to wall cell (0,0): reference :92-98
            coords = torch.where(oob[..., None], 0, coords)
            is_goal = (coords == goal[..., None, :]).all(-1)
            sq = torch.where(is_goal, 2, (grid_at(coords) >= 0).to(torch.int32))
            return sq.to(torch.int32).reshape(*agent.shape[:-1], obs_n, obs_n)
    elif "lidar" in obs_type:
        # fixed-angle ray march against the wall grid, a fixed number of
        # probes, plus the relative goal offset (JAX package
        # obs/observations.py:186-242)
        if not continuous:
            raise NotImplementedError("lidar obs requires a continuous env")
        bins = obs_n if obs_n > 2 else 8
        max_range = float(np.hypot(H, W)) * cell_size
        step_len = 0.5 * cell_size
        n_march = int(np.ceil(max_range / step_len))
        angles = np.linspace(0.0, 2 * np.pi, bins, endpoint=False)
        dirs = torch.as_tensor(np.stack([np.sin(angles), np.cos(angles)], -1),
                               dtype=torch.float32, device=device)  # (dy, dx)
        ts = torch.arange(1, n_march + 1, dtype=torch.float32) * step_len
        space = Box(
            np.concatenate([np.zeros(bins), -np.asarray(a_max, np.float64)]),
            np.concatenate([np.full(bins, max_range),
                            np.asarray(a_max, np.float64)]),
            (bins + 2,), dtype=torch.float32)

        def ray_ranges(agent):
            pos = agent.to(torch.float32)[..., None, :]  # [..., 1, 2]
            hit = torch.full((*agent.shape[:-1], bins), max_range,
                             dtype=torch.float32, device=agent.device)
            for t in ts:  # the first probe that lands on a wall, else max
                probe = pos + dirs * t  # [..., bins, 2]
                cy = torch.clamp(torch.floor(probe[..., 0] / cell_size), 0,
                                 H - 1).to(torch.int32)
                cx = torch.clamp(torch.floor(probe[..., 1] / cell_size), 0,
                                 W - 1).to(torch.int32)
                inside = ((probe[..., 0] >= 0) & (probe[..., 0] < H * cell_size)
                          & (probe[..., 1] >= 0) & (probe[..., 1] < W * cell_size))
                wall = (grid_at(torch.stack([cy, cx], -1)) < 0) | ~inside
                hit = torch.where(wall & (t < hit), t, hit)
            return hit

        def obs(agent, goal):
            rel = (goal - agent).to(torch.float32)
            return torch.cat([ray_ranges(agent), rel], -1)
    else:
        raise NotImplementedError(f"Observation type {obs_type!r} not recognized")

    return space, obs
