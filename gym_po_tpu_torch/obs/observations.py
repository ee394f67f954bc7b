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
'room', 'mdp', 'hansen'/'hansen8', 'grid') mirrors reference
``rooms.py:19-67``.  The continuous branch (``cell_size``) and ``lidar``
come with the continuous rooms env and raise ``NotImplementedError`` here.
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
    """Build ``(space, obs_fn(agent, goal) -> obs)`` for a rooms-family grid
    with discrete (int cell) coordinates; the lookup tables live on
    ``device``."""
    if cell_size is not None or "lidar" in obs_type:
        raise NotImplementedError(
            "continuous-coordinate observations (cell_size, lidar) are not "
            "ported yet: they come with the continuous rooms env")
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

    a_max = np.asarray(grid.shape, np.int64) - 2

    if "room" in obs_type:
        n = n_room_states(grid)
        if has_goal:
            space = Discrete(int(n**2))

            def obs(agent, goal):
                return grid_at(agent) + n * grid_at(goal)
        else:
            space = Discrete(int(n))

            def obs(agent, goal):
                return grid_at(agent)
    elif "mdp" in obs_type:
        if is_vector:
            if has_goal:
                space = Box(1, np.tile(a_max, 2), (4,), dtype=torch.int32)

                def obs(agent, goal):
                    return torch.cat((agent, goal), -1).to(torch.int32)
            else:
                space = Box(1, a_max, (2,), dtype=torch.int32)

                def obs(agent, goal):
                    return agent.to(torch.int32)
        else:
            n = n_discrete_states(grid)
            sg_flat = torch.as_tensor(state_grid(grid).reshape(-1),
                                      dtype=torch.int32, device=device)
            if has_goal:
                space = Discrete(int(n**2))

                def obs(agent, goal):
                    return lookup(sg_flat, agent) + n * lookup(sg_flat, goal)
            else:
                space = Discrete(int(n))

                def obs(agent, goal):
                    return lookup(sg_flat, agent)
    elif "hansen" in obs_type:
        base_n = 8 if "8" in obs_type else 4
        offs = torch.as_tensor(
            ACTIONS_CARDINAL if base_n == 4 else ACTIONS_ORDINAL,
            dtype=torch.int32, device=device)

        def neighbor_vals(agent, goal):
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
            coords = agent[..., None, :] + mg_t  # [..., n*n, 2]
            oob = ((coords[..., 0] < 0) | (coords[..., 1] < 0)
                   | (coords[..., 0] >= H) | (coords[..., 1] >= W))
            # invalid coords redirect to wall cell (0,0): reference :92-98
            coords = torch.where(oob[..., None], 0, coords)
            is_goal = (coords == goal[..., None, :]).all(-1)
            sq = torch.where(is_goal, 2, (grid_at(coords) >= 0).to(torch.int32))
            return sq.to(torch.int32).reshape(*agent.shape[:-1], obs_n, obs_n)
    else:
        raise NotImplementedError(f"Observation type {obs_type!r} not recognized")

    return space, obs
