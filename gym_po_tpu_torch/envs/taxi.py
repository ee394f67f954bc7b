"""Vectorizable Taxi / PO-Taxi, PyTorch port of :mod:`gym_po_tpu.envs.taxi`.

The step reduces to two small per-cell table lookups (``cell_move``,
``loc_at``) plus integer codec arithmetic on the encoded state.  The JAX
package routes those lookups through one-hot matmuls for the TPU's matrix
unit (``gym_po_tpu.ops.gather``); here they are native indexing.

The dynamics are factored into the same deterministic stages as the JAX
package (``advance``, ``apply_task_reset``, ``apply_full_reset``), which take
all randomness as arguments.  ``step_env`` / ``step_vec`` compose them with
draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..core import Discrete, Environment, EnvState
from ..maps.taxi_maps import (
    NUM_ACTIONS,
    TAXI_MAP,
    EXTENDED_TAXI_MAP,
    TaxiTables,
    compile_taxi_map,
)

__all__ = ["Taxi", "TaxiState", "TAXI_MAP", "EXTENDED_TAXI_MAP"]


@dataclasses.dataclass(frozen=True)
class TaxiState(EnvState):
    s: torch.Tensor  # int32 encoded (taxi row, taxi col, passenger, destination)
    completed: torch.Tensor  # int32 dropoffs completed this episode


def _decode(s: torch.Tensor, cols: int, nlocs: int):
    """Reference extended_taxi.py:84-94."""
    d = s % nlocs
    tmp = s // nlocs
    p = tmp % (nlocs + 1)
    tmp = tmp // (nlocs + 1)
    return tmp // cols, tmp % cols, p, d


def _encode(r, c, p, d, cols: int, nlocs: int):
    """Reference extended_taxi.py:97-99."""
    return ((r * cols + c) * (nlocs + 1) + p) * nlocs + d


class Taxi(Environment[TaxiState]):
    """Taxi / Hansen-PO-Taxi on 5x5 or extended 8x8 maps.

    Args mirror the JAX package's constructor, plus ``device``: the tables
    live there, and every state, action and generator handed to the env must
    be on it too.
    """

    def __init__(
        self,
        map: Sequence[str] = TAXI_MAP,
        hansen_obs: bool = False,
        num_passengers: int = 1,
        time_limit: int = 200,
        reward_goal: float = 1.0,
        reward_bad: float = -0.5,
        reward_any: float = -0.05,
        device: Any = "cpu",
    ):
        self.tables: TaxiTables = compile_taxi_map(map)
        t = self.tables
        self.name = "HansenTaxi-v4" if hansen_obs else "Taxi-v4"
        self.hansen = bool(hansen_obs)
        self.num_passengers = int(num_passengers)
        self.time_limit = int(time_limit)
        self.reward_goal = float(reward_goal)
        self.reward_bad = float(reward_bad)
        self.reward_any = float(reward_any)
        self.cols = t.cols
        self.nlocs = t.nlocs
        self.device = torch.device(device)

        def dev(x, dtype=torch.int32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        self._valid_init = dev(t.valid_init)
        # The full [ns, 5] transition table factors through the cell:
        # movement only changes (r, c) and pickup/dropoff only asks which
        # landmark is at (r, c), so two tiny tables plus codec arithmetic
        # replace it.
        ncells = t.rows * t.cols
        pd = (t.nlocs + 1) * t.nlocs
        s0 = np.arange(ncells, dtype=np.int64) * pd  # states with p=0, d=0
        self._cell_move = dev((t.next_s[s0][:, :4] // pd).reshape(-1))
        loc_at = np.full(ncells, t.nlocs, np.int64)  # sentinel: no landmark
        lm = t.np_locs[: t.nlocs]
        loc_at[lm[:, 0] * t.cols + lm[:, 1]] = np.arange(t.nlocs)
        self._loc_at = dev(loc_at)
        # Hansen obs = (wall_code[r,c]*(nlocs+1)+p)*nlocs+d, also cell-level
        self._hansen_cell = dev(t.hansen_grid.reshape(-1))
        self._pd = pd
        # when every cell is navigable, episode-start states are sampled
        # arithmetically by (r, c, p, d) components with no lookup
        self._all_cells_valid = bool((t.tgrid != "|").all())
        self._rewards = dev(
            [self.reward_goal, self.reward_bad, self.reward_any], torch.float32
        )

        self._obs_n = t.n_hansen_obs if hansen_obs else t.ns
        self._action_space = Discrete(NUM_ACTIONS)
        self._observation_space = Discrete(self._obs_n)

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self) -> Discrete:
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def advance(
        self, state: TaxiState, action: torch.Tensor
    ) -> Tuple[TaxiState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stage A: deterministic transition (reference extended_taxi.py:244-281).

        Returns (mid_state, reward, done, truncated, task_completed).
        """
        elapsed = state.elapsed + 1
        # decode cell / passenger / destination (reference :84-94)
        rc = state.s // self._pd
        rem = state.s % self._pd
        p = rem // self.nlocs
        d = rem % self.nlocs
        # movement actions 0-3 via the cell-level table
        rc_mv = self._cell_move[rc * 4 + torch.clamp(action, max=3)]
        # pickup/dropoff action 4 (reference :262-275)
        is_pd = action == NUM_ACTIONS - 1
        loc = self._loc_at[rc]
        goal = is_pd & (p == self.nlocs) & (loc == d)
        pickup = is_pd & (p < self.nlocs) & (loc == p)
        bad = is_pd & ~goal & ~pickup
        p2 = torch.where(pickup, self.nlocs, p)
        rc2 = torch.where(is_pd, rc, rc_mv)
        s2 = (rc2 * (self.nlocs + 1) + p2) * self.nlocs + d
        completed = state.completed + goal.to(torch.int32)
        r_goal, r_bad, r_any = self._rewards
        rew = torch.where(goal, r_goal, torch.where(bad, r_bad, r_any))
        done = completed == self.num_passengers
        trunc = elapsed > self.time_limit  # strict >, reference :279
        task_completed = goal & ~(done | trunc)  # reference :282
        return (
            state.replace(s=s2, completed=completed, elapsed=elapsed),
            rew,
            done,
            trunc,
            task_completed,
        )

    def apply_task_reset(
        self, state: TaxiState, mask: torch.Tensor, p_new: torch.Tensor,
        d_new: torch.Tensor,
    ) -> TaxiState:
        """Stage B1: re-place passenger & destination, keep taxi position
        (reference extended_taxi.py:354-364)."""
        r, c, _, _ = _decode(state.s, self.cols, self.nlocs)
        s_task = _encode(r, c, p_new, d_new, self.cols, self.nlocs)
        return state.replace(s=torch.where(mask, s_task, state.s))

    def apply_full_reset(
        self, state: TaxiState, mask: torch.Tensor, s_new: torch.Tensor
    ) -> TaxiState:
        """Stage B2: masked full episode reset (reference extended_taxi.py:344-352)."""
        return state.replace(
            s=torch.where(mask, s_new, state.s),
            elapsed=torch.where(mask, 0, state.elapsed),
            completed=torch.where(mask, 0, state.completed),
        )

    def observe(self, state: TaxiState) -> torch.Tensor:
        """Full state id, or Hansen-coded partial obs (reference :366-372)."""
        if self.hansen:
            rc = state.s // self._pd
            rem = state.s % self._pd
            h = self._hansen_cell[rc]
            return (h * (self.nlocs + 1) + rem // self.nlocs) * self.nlocs + (
                rem % self.nlocs
            )
        return state.s

    def observe_vec(self, state: TaxiState) -> torch.Tensor:
        return self.observe(state)  # elementwise over any leading axes

    # ------------------------------------------------------- random sampling
    def _randint(self, generator, n: int, shape) -> torch.Tensor:
        return torch.randint(0, n, shape, generator=generator,
                             device=self.device, dtype=torch.int32)

    def sample_init_state(self, generator: torch.Generator) -> torch.Tensor:
        """Uniform over valid initial states (perf mode; see the JAX
        package's note on the reference's multinomial tie-break)."""
        idx = self._randint(generator, self._valid_init.shape[0], ())
        return self._valid_init[idx]

    def sample_passenger_destination(
        self, generator: torch.Generator, shape=()
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """p uniform over nlocs, d uniform over nlocs-1 excluding p — the
        rejection-free equivalent of reference :360-363."""
        p = self._randint(generator, self.nlocs, shape)
        d0 = self._randint(generator, self.nlocs - 1, shape)
        return p, d0 + (d0 >= p)

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator) -> Tuple[torch.Tensor, TaxiState]:
        z = torch.zeros((), dtype=torch.int32, device=self.device)
        state = TaxiState(elapsed=z, s=self.sample_init_state(generator),
                          completed=z)
        return self.observe(state), state

    def step_env(
        self, generator: torch.Generator, state: TaxiState, action: torch.Tensor
    ) -> Tuple[torch.Tensor, TaxiState, torch.Tensor, torch.Tensor, torch.Tensor,
               Dict[str, Any]]:
        return self._step(generator, state, action,
                          lambda: self.sample_init_state(generator))

    # ------------------------------------------------------ batched fast path
    def _sample_init_vec(self, generator: torch.Generator, num: int) -> torch.Tensor:
        """[num] uniform valid episode-start states.

        When every cell is navigable (both shipped maps) the uniform product
        over (cells × p × d≠p) IS the valid-state distribution (reference
        extended_taxi.py:205-218), so sample r, c, p, d directly.
        """
        if not self._all_cells_valid:
            idx = self._randint(generator, self._valid_init.shape[0], (num,))
            return self._valid_init[idx]
        t = self.tables
        r = self._randint(generator, t.rows, (num,))
        c = self._randint(generator, t.cols, (num,))
        p, d = self.sample_passenger_destination(generator, (num,))
        return _encode(r, c, p, d, self.cols, self.nlocs)

    def reset_vec(self, generator: torch.Generator, num_envs: int):
        zeros = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        state = TaxiState(elapsed=zeros,
                          s=self._sample_init_vec(generator, num_envs),
                          completed=zeros)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: TaxiState,
                 action: torch.Tensor):
        return self._step(generator, state, action,
                          lambda: self._sample_init_vec(generator, action.shape[0]))

    def _step(self, generator, state, action, sample_init):
        mid, rew, done, trunc, task = self.advance(state, action)
        p, d = self.sample_passenger_destination(generator, action.shape)
        mid = self.apply_task_reset(mid, task, p, d)
        reset_mask = done | trunc
        new_state = self.apply_full_reset(mid, reset_mask, sample_init())
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info
