"""RockSample(n, k), PyTorch port of :mod:`gym_po_tpu.envs.rocksample`.

The canonical POMDP of Smith & Simmons, "Heuristic Search Value Iteration
for POMDPs" (UAI 2004), as the JAX package defines it over the reference's
stub (its enums ``Obs{NULL,GOOD,BAD}`` and ``ACTION{NORTH,EAST,SOUTH,WEST,
SAMPLE}``):

* an n×n grid with k rocks at fixed positions (drawn once from
  ``layout_seed`` with numpy, so a seed gives the JAX package's layout);
  each rock is good/bad with p=0.5 per episode; the rover position is fully
  observable, rock quality is not;
* actions: NORTH, EAST, SOUTH, WEST, SAMPLE, CHECK_1..CHECK_k (5+k total);
* moving EAST off the map exits the episode with reward +10; other off-grid
  moves are no-ops;
* SAMPLE on a rock: +10 if good (the rock becomes bad), -10 if bad;
  SAMPLE off-rock: -100;
* CHECK_i reads rock i's quality through a noisy sensor with accuracy
  eta(d) = 0.5 * (1 + 2**(-d / d0)), d the Euclidean rover-rock distance.

Observation = ``pos_index * 3 + reading`` (reading in {NULL, GOOD, BAD},
NULL unless the action was a CHECK); ``obs_type='vector'`` gives
``[y, x, reading]``.  The stages (``advance``, ``apply_reset``,
``observe``) take every draw as an argument; ``step_env`` / ``step_vec``
compose them with draws from an explicit ``torch.Generator``.  The rock of
a CHECK is taken by native indexing where the JAX package contracts a
one-hot vector with its matrix unit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Box, Discrete, Environment, EnvState

__all__ = ["RockSample", "RockSampleState", "OBS_NULL", "OBS_GOOD", "OBS_BAD"]

# stub enums (reference rocksample.py:8-20)
OBS_NULL, OBS_GOOD, OBS_BAD = 0, 1, 2
A_NORTH, A_EAST, A_SOUTH, A_WEST, A_SAMPLE = 0, 1, 2, 3, 4

_MOVES_YX = np.array(
    [[-1, 0], [0, 1], [1, 0], [0, -1], [0, 0]], dtype=np.int32
)  # N, E, S, W, stay(sample)

GOOD_REWARD = 10.0
BAD_PENALTY = -10.0
EXIT_REWARD = 10.0
ILLEGAL_SAMPLE_PENALTY = -100.0


@dataclasses.dataclass(frozen=True)
class RockSampleState(EnvState):
    pos_yx: torch.Tensor  # int32 [..., 2]
    rock_good: torch.Tensor  # bool [..., k]
    reading: torch.Tensor  # int32 [...] in {NULL, GOOD, BAD}


class RockSample(Environment[RockSampleState]):
    """Canonical RockSample(n, k).  Args mirror the JAX package's
    constructor plus ``device`` (the card by default; pass ``"cpu"`` for the
    CPU)."""

    def __init__(
        self,
        map_size: Sequence[int] = (5, 5),
        num_rocks: int = 5,
        init_pos: Sequence[int] = (1, 1),
        rock_positions: Optional[Sequence[Sequence[int]]] = None,
        half_efficiency_distance: float = 20.0,
        time_limit: int = 200,
        obs_type: str = "discrete",
        layout_seed: int = 0,
        device: Any = "cuda",
    ):
        self.rows, self.cols = int(map_size[0]), int(map_size[1])
        self.k = int(num_rocks)
        self.time_limit = int(time_limit)
        self.d0 = float(half_efficiency_distance)
        self.obs_type = obs_type
        self.name = f"RockSample({self.rows}x{self.cols},{self.k})"
        self.device = torch.device(device)

        if rock_positions is None:
            # fixed per-instance layout, sampled once at construction
            rng = np.random.default_rng(layout_seed)
            flat = rng.choice(self.rows * self.cols, self.k, replace=False)
            rock_positions = np.stack(
                np.unravel_index(flat, (self.rows, self.cols)), -1)
        self.rock_positions_np = np.asarray(rock_positions, np.int32)
        if self.rock_positions_np.shape != (self.k, 2):
            raise ValueError(f"rock_positions must have shape {(self.k, 2)}")
        self.init_pos_np = np.asarray(init_pos, np.int32)

        def dev(x, dtype=torch.int32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        self._rocks = dev(self.rock_positions_np)
        self._rocks_f = dev(self.rock_positions_np, torch.float32)
        self._init_pos = dev(self.init_pos_np)
        self._moves = dev(_MOVES_YX)

        self.num_actions = 5 + self.k
        self._action_space = Discrete(self.num_actions)
        if obs_type == "vector":
            self._observation_space = Box(
                np.zeros(3, np.float32),
                np.array([self.rows - 1, self.cols - 1, 2], np.float32),
                (3,), dtype=torch.int32)
        else:
            self._observation_space = Discrete(self.rows * self.cols * 3 + 3)

    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def sensor_accuracy(self, pos_yx: torch.Tensor,
                        action: torch.Tensor) -> torch.Tensor:
        """``eta = 0.5 * (1 + 2^(-d/d0))`` in f32 for the rock a CHECK
        ``action`` names (clipped to a rock for the other actions)."""
        rock_idx = torch.clamp(action - 5, 0, self.k - 1).long()
        diff = pos_yx.to(torch.float32) - self._rocks_f[rock_idx]
        dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
        return 0.5 * (1.0 + torch.exp2(-dist / self.d0))

    def advance(
        self, state: RockSampleState, action: torch.Tensor,
        sensor_u: torch.Tensor,
    ) -> Tuple[RockSampleState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One transition; ``sensor_u`` is the uniform used by CHECK noise."""
        elapsed = state.elapsed + 1
        is_move = action < 4
        is_sample = action == A_SAMPLE
        is_check = action > A_SAMPLE
        rock_idx = torch.clamp(action - 5, 0, self.k - 1).long()

        # movement (exit east off-grid terminates; other off-grid = no-op)
        delta = self._moves[torch.clamp(action, max=4).long()]
        proposed = state.pos_yx + torch.where(is_move[..., None], delta, 0)
        exited = is_move & (proposed[..., 1] >= self.cols)
        inside = ((proposed[..., 0] >= 0) & (proposed[..., 0] < self.rows)
                  & (proposed[..., 1] >= 0) & (proposed[..., 1] < self.cols))
        pos = torch.where(inside[..., None], proposed, state.pos_yx)

        # sampling
        at_rock = (state.pos_yx[..., None, :] == self._rocks).all(-1)  # [..., k]
        on_any = at_rock.any(-1)
        here_good = (at_rock & state.rock_good).any(-1)
        sample_rew = torch.where(
            on_any, torch.where(here_good, GOOD_REWARD, BAD_PENALTY),
            ILLEGAL_SAMPLE_PENALTY).to(torch.float32)
        rock_good = torch.where((is_sample & on_any)[..., None],
                                state.rock_good & ~at_rock, state.rock_good)

        # sensing
        correct = sensor_u < self.sensor_accuracy(state.pos_yx, action)
        truth = state.rock_good.gather(-1, rock_idx[..., None])[..., 0]
        seen_good = torch.where(correct, truth, ~truth)
        reading = torch.where(
            is_check, torch.where(seen_good, OBS_GOOD, OBS_BAD),
            OBS_NULL).to(torch.int32)

        rew = torch.where(exited, EXIT_REWARD,
                          torch.where(is_sample, sample_rew, 0.0))
        trunc = elapsed >= self.time_limit
        mid = state.replace(elapsed=elapsed, pos_yx=pos, rock_good=rock_good,
                            reading=reading)
        return mid, rew, exited, trunc

    def apply_reset(self, state: RockSampleState, mask: torch.Tensor,
                    rock_good_new: torch.Tensor) -> RockSampleState:
        m = mask[..., None]
        return state.replace(
            elapsed=torch.where(mask, 0, state.elapsed),
            pos_yx=torch.where(m, self._init_pos, state.pos_yx),
            rock_good=torch.where(m, rock_good_new, state.rock_good),
            reading=torch.where(mask, OBS_NULL, state.reading),
        )

    def observe(self, state: RockSampleState) -> torch.Tensor:
        if self.obs_type == "vector":
            return torch.cat([state.pos_yx, state.reading[..., None]],
                             -1).to(torch.int32)
        pos_idx = state.pos_yx[..., 0] * self.cols + state.pos_yx[..., 1]
        return (pos_idx * 3 + state.reading).to(torch.int32)

    def observe_vec(self, state: RockSampleState) -> torch.Tensor:
        return self.observe(state)  # written over any leading axes

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator):
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _first(state)

    def step_env(self, generator: torch.Generator, state: RockSampleState,
                 action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _batch1(state), action.reshape(1))
        info = {"terminal_state": _first(info["terminal_state"]),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _first(st), rew[0], done[0], trunc[0], info

    # ------------------------------------------------------ batched fast path
    def _rock_quality(self, generator: torch.Generator, num: int) -> torch.Tensor:
        """``[num, k]`` rock qualities, each good with p = 0.5."""
        return torch.rand((num, self.k), generator=generator,
                          device=self.device) < 0.5

    def reset_vec(self, generator: torch.Generator, num_envs: int):
        state = RockSampleState(
            elapsed=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            pos_yx=self._init_pos.expand(num_envs, 2).clone(),
            rock_good=self._rock_quality(generator, num_envs),
            reading=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
        )
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: RockSampleState,
                 action: torch.Tensor):
        B = action.shape[0]
        u = torch.rand(B, generator=generator, device=self.device)
        mid, rew, done, trunc = self.advance(state, action, u)
        reset_mask = done | trunc
        new_state = self.apply_reset(mid, reset_mask,
                                     self._rock_quality(generator, B))
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return self.observe(new_state), new_state, rew, done, trunc, info


def _first(state: RockSampleState) -> RockSampleState:
    return RockSampleState(elapsed=state.elapsed[0], pos_yx=state.pos_yx[0],
                           rock_good=state.rock_good[0],
                           reading=state.reading[0])


def _batch1(state: RockSampleState) -> RockSampleState:
    return RockSampleState(elapsed=state.elapsed.reshape(1),
                           pos_yx=state.pos_yx.reshape(1, 2),
                           rock_good=state.rock_good.reshape(1, -1),
                           reading=state.reading.reshape(1))
