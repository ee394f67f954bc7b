"""The Taxi step that the port's fused Taxi kernels share, as a plain twin.

``csrc/taxi_step.cuh`` holds the device side: one env step of the
transition and rewards, the task reset (a new passenger after a dropoff
that does not end the episode) and the full episode reset, with the draw
sites in a fixed order.  :class:`TaxiDynamics` is its plain PyTorch twin,
vectorized over ``[B]``, together with the map constants and per-cell tables
the kernels take.  The rollout (:mod:`.fused_taxi`) and the tabular trainers
(:mod:`.fused_qlearning`, :mod:`.fused_double_q`) all step through it, so a
change to the dynamics or to the draw order is made once on each side.

Draw sites of one step, after the kernel's own (the action and so on):
task ``pn``, task ``d0``, full-reset cell (``rbits(rows)`` then
``rbits(cols)`` when every cell is navigable, else one ``rbits(n_valid)``),
reset ``pr``, reset ``dr0``: :attr:`TaxiDynamics.n_sites` of them, drawn
every step whatever the masks say.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .kernel_rng import KernelRNG, W

__all__ = ["TaxiDynamics", "TaxiStep"]


class TaxiStep(NamedTuple):
    """One env step, as ``gpt::TaxiStep`` in ``csrc/taxi_step.cuh``."""

    s_mid: torch.Tensor  # after the task reset, before the full reset
    s: torch.Tensor  # the next state, after the full reset
    rew: torch.Tensor
    done: torch.Tensor
    reset: torch.Tensor  # done or truncated: the episode ended
    ep_len: torch.Tensor  # elapsed at the end of the step, before a reset
    completed: torch.Tensor  # carried, zeroed at a reset
    elapsed: torch.Tensor  # carried, zeroed at a reset


class TaxiDynamics:
    """Map constants, per-cell tables on each device, and the twin's step
    of a Taxi env, as the fused kernels see them.  ``extra`` adds host
    tables of the caller's own (``tables_on`` moves them too)."""

    def __init__(self, env, extra: Optional[Dict[str, np.ndarray]] = None):
        t = env.tables
        self.nc = t.rows * t.cols
        if self.nc > W:
            raise ValueError(f"map has {self.nc} cells; the fused kernels "
                             f"support <= {W}")
        self.nlocs, self.rows, self.cols = t.nlocs, t.rows, t.cols
        self.pd = (t.nlocs + 1) * t.nlocs
        self.ns = self.nc * self.pd
        self.hansen = bool(env.hansen)
        self.all_valid = bool(env._all_cells_valid)
        self.n_pass, self.time_limit = env.num_passengers, env.time_limit
        self.rewards = (env.reward_goal, env.reward_bad, env.reward_any)
        self.host: Dict[str, np.ndarray] = {
            "cm": np.asarray(env._cell_move.cpu(), np.int32),  # [nc * 4]
            "la": np.asarray(env._loc_at.cpu(), np.int32),  # [nc]
            "hc": np.asarray(env._hansen_cell.cpu(), np.int32)[: self.nc],
            "vc": np.flatnonzero((t.tgrid != "|").reshape(-1)).astype(np.int32),
            **(extra or {}),
        }
        self.n_valid = int(self.host["vc"].size)
        # task pn, d0; reset cell (2 draws or 1); reset pr, dr0
        self.n_sites = 4 + (2 if self.all_valid else 1)
        self._tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables_on(self, device) -> Dict[str, torch.Tensor]:
        if device not in self._tables:
            tab = {k: torch.as_tensor(v, device=device)
                   for k, v in self.host.items()}
            tab["rew"] = torch.tensor(self.rewards, dtype=torch.float32,
                                      device=device)
            self._tables[device] = tab
        return self._tables[device]

    def obs_of(self, tab, s: torch.Tensor) -> torch.Tensor:
        """The index Q is kept by: the state, or its Hansen observation."""
        if not self.hansen:
            return s
        rem = s % self.pd
        return ((tab["hc"][s // self.pd] * (self.nlocs + 1) + rem // self.nlocs)
                * self.nlocs + rem % self.nlocs)

    def step(self, rng: KernelRNG, tab, s: torch.Tensor, a: torch.Tensor,
             completed: torch.Tensor, elapsed: torch.Tensor) -> TaxiStep:
        """One step of every env from state ``s`` under action ``a``
        (reference ``extended_taxi.py:244-287``), drawing this step's
        :attr:`n_sites` sites in order."""
        nlocs = self.nlocs
        rc = s // self.pd
        rem = s % self.pd
        p = rem // nlocs
        d = rem % nlocs
        moved = tab["cm"][rc * 4 + torch.clamp(a, max=3)]
        is_pd = a == 4
        loc = tab["la"][rc]
        goal = is_pd & (p == nlocs) & (loc == d)
        pickup = is_pd & (p < nlocs) & (loc == p)
        bad = is_pd & ~goal & ~pickup
        r_goal, r_bad, r_any = tab["rew"]
        rew = torch.where(goal, r_goal, torch.where(bad, r_bad, r_any))
        p2 = torch.where(pickup, nlocs, p)
        rc2 = torch.where(is_pd, rc, moved)
        completed = completed + goal.to(torch.int32)
        elapsed = elapsed + 1
        done = completed == self.n_pass
        trunc = elapsed > self.time_limit  # strict >, reference :279
        reset = done | trunc
        # task reset: a new passenger, rejection-free d != p
        task = goal & ~reset
        pn = rng.rbits(nlocs)
        d0 = rng.rbits(nlocs - 1)
        p3 = torch.where(task, pn, p2)
        d3 = torch.where(task, d0 + (d0 >= pn), d)
        s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3
        # full reset
        if self.all_valid:
            rr = rng.rbits(self.rows)
            rc_new = rr * self.cols + rng.rbits(self.cols)
        else:
            rc_new = tab["vc"][rng.rbits(self.n_valid)]
        pr = rng.rbits(nlocs)
        dr0 = rng.rbits(nlocs - 1)
        rc3 = torch.where(reset, rc_new, rc2)
        p4 = torch.where(reset, pr, p3)
        d4 = torch.where(reset, dr0 + (dr0 >= pr), d3)
        return TaxiStep(
            s_mid=s_mid, s=(rc3 * (nlocs + 1) + p4) * nlocs + d4, rew=rew,
            done=done, reset=reset, ep_len=elapsed,
            completed=torch.where(reset, 0, completed),
            elapsed=torch.where(reset, 0, elapsed))

