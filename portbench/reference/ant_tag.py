"""Plain reference of the articulated ant tag task, as the PPO cell's
collect check holds the program's transitions to it.

The task is gym-po's ``ant_tag.py:27-158``: the ant's physics for
``frame_skip`` RK4 steps with the clipped action held (the frozen engine
of :mod:`portbench.reference.ant`), then the target's flee of 0.5 {away,
the two orthogonals, stay}, cancelled at the ±4.5 cage edge, the tag
within 1.5 (+1, the episode ends), the time limit, and a fresh episode
(the standing pose at a uniform point of the cage, at rest, the target at
least 5.0 away) where one ended.  Observations: ``qpos[2:]``, ``qvel``,
and the target's xy where it lies within the visible radius, else zeros.

The flee's mode and a fresh episode's point are the program's draws: the
check asks that the target's new place be the flee of one of the four
modes, and that a fresh episode be one that the reset can draw.  The
physics is compared on a sample of env-steps drawn from the seed, by the
gap between the program's state after the step and the reference's from
the same state and action: per env the largest of the position's, the
velocity's and the warm start's distance over its own norm or 1; per
sampled step the gap that ``QUANTILE`` of its envs stay within, and over
all sampled envs the share whose gap exceeds ``OUTLIER_GAP``.  Not the
worst env: contact onsets make a few envs of every step chaotic, so that
the reference at float32 and at float64 differ there by O(1) too.
"""

from __future__ import annotations

import random
from typing import Dict

import torch

from portbench.reference.ant import ant_model, engine

CAGE = 4.5
TAG_RADIUS = 1.5
MIN_SPAWN_DIST = 5.0
TARGET_STEP = 0.5
STAND = (0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0)
# positions are compared to this (f32 rounding of the flee's arithmetic,
# within a cage of 4.5); a squared distance this near a radius's square
# may fall either side of it
POS_TOL = 1e-5
EDGE_TOL = 1e-4
#: the share of a sampled step's envs whose gap the physics check reads
QUANTILE = 0.9
#: an env whose gap exceeds this counts as an outlier: 14x the 99th
#: percentile of the reference's own float32 against float64 (5.3e-5-7.1e-5)
OUTLIER_GAP = 1e-3
#: envs in the aligned blocks that ``physics_block`` counts outliers in
BLOCK = 32


def flee(agent_xy, target_xy, mode: int):
    away = agent_xy - target_xy
    nrm = torch.sqrt((away * away).sum(-1, keepdim=True))
    safe = nrm > 1e-9
    away = torch.where(safe, away / torch.where(safe, nrm, 1.0), 0.0)
    ortho = torch.stack([away[..., 1], -away[..., 0]], -1)
    step = (-away, ortho, -ortho, torch.zeros_like(away))[mode]
    new = target_xy + step * TARGET_STEP
    oob = (new.abs() > CAGE).any(-1, keepdim=True)
    return torch.where(oob | ~safe, target_xy, new)


class PPOEnv:
    discrete, gaussian, n_act = False, True, 8

    def __init__(self, config: Dict, device, check: Dict):
        kw = config["env_kwargs"]
        self.time_limit = int(kw["time_limit"])
        self.frame_skip = int(kw["frame_skip"])
        self.iters, self.ls_iters = int(kw["solver_iters"]), int(kw["ls_iters"])
        self.visible = float(kw["visible_radius"])
        self.model = ant_model.make_ant_model(ant_model.TAG_WALLS)
        self.n_in = self.model.nq - 2 + self.model.nv + 2
        self.sample = check
        self.device = torch.device(device)
        self.stand = torch.tensor(STAND, device=self.device)

    def observe(self, st, seen=None) -> torch.Tensor:
        d = st["qpos"][..., :2] - st["target_xy"]
        if seen is None:
            seen = (d * d).sum(-1, keepdim=True) < self.visible ** 2
        tail = torch.where(seen, st["target_xy"], 0.0)
        return torch.cat([st["qpos"][..., 2:], st["qvel"], tail], -1)

    def mismatches(self, st, action, mid, nxt, rew, done, trunc, obs) -> int:
        """Env-steps whose task layer, observation, or next state differ
        from the reference's (the physics is :meth:`physics_gap`'s)."""
        d = st["qpos"][..., :2] - st["target_xy"]
        edge = ((d * d).sum(-1) - self.visible ** 2).abs() < EDGE_TOL
        ones = torch.ones_like(edge)[..., None]
        bad = (obs != self.observe(st)).any(-1) & ~(
            edge & ((obs == self.observe(st, ones)).all(-1)
                    | (obs == self.observe(st, ~ones)).all(-1)))
        xy = mid["qpos"][..., :2]
        fled = torch.zeros_like(bad)
        for mode in range(4):
            fled |= ((flee(xy, st["target_xy"], mode) - mid["target_xy"]).abs()
                     <= POS_TOL).all(-1)
        bad |= ~fled
        d = xy - mid["target_xy"]
        d2 = (d * d).sum(-1)
        done_r = d2 <= TAG_RADIUS ** 2
        done_r = torch.where((d2 - TAG_RADIUS ** 2).abs() < EDGE_TOL, done.bool(), done_r)
        el = st["elapsed"].long() + 1
        trunc_r = (el >= self.time_limit) & ~done_r
        bad |= (done.bool() != done_r) | (trunc.bool() != trunc_r) \
            | (rew.float() != done_r.float()) | (mid["elapsed"].long() != el)
        reset = done_r | trunc_r
        same = torch.ones_like(bad)
        for k in mid:
            a, b = nxt[k], mid[k]
            same &= (a == b).reshape(a.shape[0], -1).all(-1)
        q = nxt["qpos"]
        tgt = nxt["target_xy"]
        dt = tgt - q[..., :2]
        fresh = (nxt["elapsed"] == 0) & (q[..., :2].abs() <= CAGE).all(-1) \
            & (q[..., 2:] == self.stand).all(-1) & (nxt["qvel"] == 0).all(-1) \
            & (nxt["warm"] == 0).all(-1) & (tgt.abs() <= CAGE).all(-1) \
            & ((dt * dt).sum(-1) >= MIN_SPAWN_DIST ** 2)
        bad |= torch.where(reset, ~fresh, ~same)
        return int(bad.sum())

    def env_gaps(self, snaps, seed: int, control: bool = False):
        """Per sampled step (drawn from ``seed``), the gap of each of its
        envs: the largest of the position's, the velocity's and the warm
        start's distance over the reference's norm or 1, between the
        reference engine's state after the physics from the step's state
        and action and the program's, or with ``control`` the reference's
        with its state kept in bfloat16."""
        rng = random.Random(seed)
        pairs = [(k, t) for k in range(len(snaps)) for t in range(len(snaps[k]["steps"]))]
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        out = []
        for k, t in rng.sample(pairs, min(self.sample["steps"], len(pairs))):
            st, step = snaps[k]["states"][t], snaps[k]["steps"][t]
            state = engine.PhysicsState(*(st[f] for f in ("qpos", "qvel", "warm")))
            ctrl = step["action"].clamp(-1.0, 1.0)
            ref = self._physics(state, ctrl, False)
            if control:
                got = self._physics(state, ctrl, True)
            else:
                got = tuple(step["mid"][n] for n in ("qpos", "qvel", "warm"))
            per_env = torch.stack([
                (g.double() - r.double()).norm(dim=-1) / r.double().norm(dim=-1).clamp(min=1.0)
                for g, r in zip(got, ref)]).amax(0)
            out.append(torch.nan_to_num(per_env, nan=float("inf")))
        return out

    def physics_checks(self, snaps, seed: int, control: bool = False):
        """``physics_gap``: the largest over the sampled steps of the gap
        that ``QUANTILE`` of their envs stay within; ``physics_outliers``:
        the share (%) of the sampled steps' envs whose gap exceeds
        ``OUTLIER_GAP``; ``physics_block``: the most outliers in one
        aligned block of ``BLOCK`` envs of one step, so that a fault in a
        block of envs shows where the share does not.  With ``control``,
        the reference with its state in bfloat16 in the program's place."""
        gaps = self.env_gaps(snaps, seed, control)
        over = [g > OUTLIER_GAP for g in gaps]
        size = min(BLOCK, over[0].numel())
        block = max(int(o[:o.numel() // size * size].view(-1, size).sum(-1).max())
                    for o in over)
        return {"physics_gap": max(float(g.quantile(QUANTILE)) for g in gaps),
                "physics_outliers": 100.0 * float(torch.cat(over).double().mean()),
                "physics_block": block}

    def _physics(self, state, ctrl, bf16: bool):
        """``frame_skip`` RK4 steps; with ``bf16`` the state rounded to
        bfloat16 after each."""
        for _ in range(self.frame_skip):
            state = engine.rk4_step(self.model, state, ctrl, self.iters, self.ls_iters)
            if bf16:
                state = engine.PhysicsState(*(x.to(torch.bfloat16).float() for x in state))
        return state
