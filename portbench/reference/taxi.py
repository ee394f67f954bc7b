"""Plain reference of the Taxi family as the port's fused kernels run it.

Written from the environment's definition (gym-po-taxi's
``gym_po/envs/extended_taxi.py``: the map with its border, the movement
and collision rule, pickup and dropoff, the task reset after a dropoff
that does not end the episode, the episode reset) and from the kernels'
draw contract: counter-based Philox4x32-10 (Salmon et al., SC'11) keyed
on the 64-bit call seed and countered on ``(env, step, site // 4, 0)``,
site ``j`` taking word ``j % 4`` of its block, ``u % n`` for a draw in
``[0, n)`` and ``u >> 8`` for a 24-bit one.  It imports nothing of the
port: every table is compiled here from the configuration's map.

* :func:`rollout`: K steps of every env under uniform random actions,
  the reward summed in ``acc_dtype`` (float32 as the configuration states;
  the lower-precision control passes bfloat16).
* :func:`q_train`: K steps of epsilon-greedy one-step Q-learning over a
  shared table, each step's updates summed as int64 fixed point at scale
  2^32 and averaged over the envs that hit one entry (``q_dtype`` as
  above for the control).
* :func:`advance`: the deterministic part of one step, which the PPO
  cell's collect check holds the program's transitions to.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
FIX_SCALE = 2.0**32
# north, south, west, east (action 4 is pickup/dropoff)
MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))


# ------------------------------------------------------------------ the map
def compile_map(rows: Sequence[str]) -> Dict[str, np.ndarray]:
    """Per-cell tables of a taxi map: the cell each move leads to, the
    landmark at each cell (``nlocs`` where none), the 4-bit wall code
    (north 1, south 2, west 4, east 8) and the navigable cells."""
    desc = np.pad(np.array([list(r) for r in rows]), 1, constant_values="|")
    wall = desc == "|"
    if (desc == ":").any():  # pseudo-walls: cells on every other column
        grid = desc[1:-1, 1:-1:2]

        def at(r, c):
            return r + 1, 2 * c + 1
    else:
        grid = desc[1:-1, 1:-1]

        def at(r, c):
            return r + 1, c + 1
    n_r, n_c = grid.shape
    cell_move = np.zeros((n_r * n_c, 4), np.int64)
    hansen = np.zeros(n_r * n_c, np.int64)
    for r in range(n_r):
        for c in range(n_c):
            for a, (dy, dx) in enumerate(MOVES):
                rn, cn = min(max(r + dy, 0), n_r - 1), min(max(c + dx, 0), n_c - 1)
                br, bc = at(rn, cn)
                blocked = wall[br, bc] or (dx != 0 and wall[br, bc - dx])
                cell_move[r * n_c + c, a] = r * n_c + c if blocked else rn * n_c + cn
            br, bc = at(r, c)
            hansen[r * n_c + c] = (wall[br - 1, bc] + 2 * wall[br + 1, bc]
                                   + 4 * wall[br, bc - 1] + 8 * wall[br, bc + 1])
    marks = [(r, c) for r in range(n_r) for c in range(n_c)
             if grid[r, c] not in "| :"]
    nlocs = len(marks)
    loc_at = np.full(n_r * n_c, nlocs, np.int64)
    for i, (r, c) in enumerate(marks):
        loc_at[r * n_c + c] = i
    valid = np.array([r * n_c + c for r in range(n_r) for c in range(n_c)
                      if grid[r, c] != "|"], np.int64)
    return {"rows": n_r, "cols": n_c, "nlocs": nlocs, "cell_move": cell_move,
            "loc_at": loc_at, "hansen": hansen, "valid": valid}


class Taxi:
    """The tables and constants of one Taxi configuration on a device."""

    def __init__(self, config: Dict, device):
        t = compile_map(config["map"])
        self.rows, self.cols, self.nlocs = t["rows"], t["cols"], t["nlocs"]
        self.pd = (self.nlocs + 1) * self.nlocs
        self.ns = self.rows * self.cols * self.pd
        self.n_obs = 16 * self.pd if config["hansen_obs"] else self.ns
        self.hansen_obs = bool(config["hansen_obs"])
        kw = config["env_kwargs"]
        self.n_pass = int(kw["num_passengers"])
        self.time_limit = int(kw["time_limit"])
        self.rewards = [np.float32(kw[k]) for k in
                        ("reward_goal", "reward_bad", "reward_any")]
        self.all_valid = t["valid"].size == self.rows * self.cols
        dev = torch.device(device)
        self.cell_move = torch.as_tensor(t["cell_move"].reshape(-1), device=dev)
        self.loc_at = torch.as_tensor(t["loc_at"], device=dev)
        self.hansen = torch.as_tensor(t["hansen"], device=dev)
        self.valid = torch.as_tensor(t["valid"], device=dev)
        self.device = dev

    def observe(self, s: torch.Tensor) -> torch.Tensor:
        """The state, or its Hansen observation (wall code, passenger,
        destination)."""
        s = s.long()
        if not self.hansen_obs:
            return s
        rem = s % self.pd
        return (self.hansen[s // self.pd] * (self.nlocs + 1) + rem // self.nlocs) \
            * self.nlocs + rem % self.nlocs

    def start_states(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` episode-start states drawn uniformly (cell, passenger, a
        destination that differs from it), int32."""
        def draw(k):
            return torch.randint(0, k, (n,), generator=generator,
                                 device=self.device)
        cell = self.valid[draw(self.valid.numel())]
        p = draw(self.nlocs)
        d0 = draw(self.nlocs - 1)
        d = d0 + (d0 >= p).long()
        return ((cell * (self.nlocs + 1) + p) * self.nlocs + d).to(torch.int32)


# ---------------------------------------------------------------- the draws
def _mulhilo(m: int, x: torch.Tensor):
    lo16, hi16 = m * (x & 0xFFFF), m * (x >> 16)
    low = lo16 + ((hi16 & 0xFFFF) << 16)
    return ((hi16 >> 16) + (low >> 32)) & MASK32, low & MASK32


def philox(c0, c1, c2, c3, key):
    """Philox4x32-10 of int64 counter words; four int64 output words."""
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def step_words(seed: int, envs: torch.Tensor, step: int, n_sites: int):
    """The ``n_sites`` uint32 draws (int64) of each env at ``step``."""
    key = (seed & MASK32, (seed >> 32) & MASK32)
    t = torch.full_like(envs, step)
    z = torch.zeros_like(envs)
    words = []
    for blk in range(-(-n_sites // 4)):
        words += philox(envs, t, torch.full_like(envs, blk), z, key)
    return words[:n_sites]


# ------------------------------------------------------------ the dynamics
def advance(env: Taxi, s, a, completed, elapsed):
    """The deterministic part of a step: ``(s2, rew, done, trunc, goal,
    completed, elapsed)``, ``s2`` before any reset."""
    s, a = s.long(), a.long()
    nl = env.nlocs
    rc, rem = s // env.pd, s % env.pd
    p, d = rem // nl, rem % nl
    is_pd = a == 4
    loc = env.loc_at[rc]
    goal = is_pd & (p == nl) & (loc == d)
    pickup = is_pd & (p < nl) & (loc == p)
    bad = is_pd & ~goal & ~pickup
    r_goal, r_bad, r_any = (torch.tensor(r, device=s.device) for r in env.rewards)
    rew = torch.where(goal, r_goal, torch.where(bad, r_bad, r_any))
    rc2 = torch.where(is_pd, rc, env.cell_move[rc * 4 + a.clamp(max=3)])
    p2 = torch.where(pickup, nl, p)
    completed = completed.long() + goal.long()
    elapsed = elapsed.long() + 1
    done = completed == env.n_pass
    trunc = elapsed > env.time_limit
    s2 = (rc2 * (nl + 1) + p2) * nl + d
    return s2, rew, done, trunc, goal, completed, elapsed


def _step(env: Taxi, w, s, a, completed, elapsed):
    """One full step with its six draws ``w`` (task passenger and
    destination, reset cell, reset passenger and destination):
    ``(s_mid, s_next, rew, done, completed, elapsed)``."""
    nl = env.nlocs
    s2, rew, done, trunc, goal, completed, elapsed = advance(env, s, a, completed,
                                                             elapsed)
    reset = done | trunc
    rc2, rem2 = s2 // env.pd, s2 % env.pd
    p2, d2 = rem2 // nl, rem2 % nl
    task = goal & ~reset
    pn, d0 = w[0] % nl, w[1] % (nl - 1)
    p3 = torch.where(task, pn, p2)
    d3 = torch.where(task, d0 + (d0 >= pn).long(), d2)
    s_mid = (rc2 * (nl + 1) + p3) * nl + d3
    if env.all_valid:
        rc_new = (w[2] % env.rows) * env.cols + w[3] % env.cols
        w = w[4:]
    else:
        rc_new = env.valid[w[2] % env.valid.numel()]
        w = w[3:]
    pr, dr0 = w[0] % nl, w[1] % (nl - 1)
    rc3 = torch.where(reset, rc_new, rc2)
    p4 = torch.where(reset, pr, p3)
    d4 = torch.where(reset, dr0 + (dr0 >= pr).long(), d3)
    s_next = (rc3 * (nl + 1) + p4) * nl + d4
    zero = torch.zeros_like(completed)
    return (s_mid, s_next, rew, done, torch.where(reset, zero, completed),
            torch.where(reset, zero, elapsed))


def step_sites(env: Taxi) -> int:
    return 4 + (2 if env.all_valid else 1)


# ------------------------------------------------------------- the loops
def rollout(env: Taxi, seed: int, s: torch.Tensor, num_steps: int,
            acc_dtype=torch.float32):
    """K steps of every env of ``s`` (``[B]``, their batch indices the
    Philox counters) under uniform random actions, from zero counters:
    ``(s', reward sums)``."""
    s = s.reshape(-1).long()
    envs = torch.arange(s.numel(), device=s.device)
    completed = torch.zeros_like(s)
    elapsed = torch.zeros_like(s)
    racc = torch.zeros(s.numel(), dtype=acc_dtype, device=s.device)
    n_sites = 1 + step_sites(env)
    for t in range(num_steps):
        w = step_words(seed, envs, t, n_sites)
        a = w[0] % 5
        _, s, rew, _, completed, elapsed = _step(env, w[1:], s, a, completed, elapsed)
        racc = racc + rew.to(acc_dtype)
    return s.to(torch.int32), racc.float()


def q_geometry(n_obs: int, n_act: int = 5):
    """``(nsp, nq)``: the slots of one action's bank and of all banks, as
    the port's trainers lay out Q (entry ``(obs, a)`` at ``a * nsp + obs``,
    at least 4 banks of 128 per action, at least 32 banks, a multiple of
    8)."""
    nsb = max(4, -(-n_obs // 128))
    nb = max(32, -(-(n_act * nsb) // 8) * 8)
    return nsb * 128, nb * 128


def _first_max(vals):
    best_v, best_a = vals[0], torch.zeros_like(vals[0], dtype=torch.long)
    for a in range(1, vals.shape[0]):
        better = vals[a] > best_v
        best_v = torch.where(better, vals[a], best_v)
        best_a = torch.where(better, a, best_a)
    return best_a, best_v


def q_train(env: Taxi, seed: int, s: torch.Tensor, q: torch.Tensor,
            num_steps: int, lr: float, epsilon: float, gamma: float,
            average: bool, q_dtype=torch.float32):
    """K steps of epsilon-greedy Q-learning of every env of ``s`` on the
    flat banks ``q``: ``(s', q', reward sums)``.  Draw sites per step:
    the explore coin (24 bits below ``epsilon * 2^24``), the random
    action, the step's six."""
    s = s.reshape(-1).long()
    q = q.reshape(-1).float().clone()
    B = s.numel()
    envs = torch.arange(B, device=s.device)
    completed = torch.zeros_like(s)
    elapsed = torch.zeros_like(s)
    racc = torch.zeros(B, dtype=torch.float32, device=s.device)
    nsp, nq = q_geometry(env.n_obs)
    acts = (torch.arange(5, device=s.device) * nsp)[:, None]
    lr_f, g_f = (torch.tensor(np.float32(x), device=s.device) for x in (lr, gamma))
    eps24 = int(np.float32(epsilon) * np.float32(1 << 24))
    n_sites = 2 + step_sites(env)
    for t in range(num_steps):
        w = step_words(seed, envs, t, n_sites)
        obs = env.observe(s)
        vals = q[acts + obs]
        greedy, _ = _first_max(vals)
        a = torch.where((w[0] >> 8) < eps24, w[1] % 5, greedy)
        q_taken = vals.gather(0, a[None])[0]
        s_mid, s, rew, done, completed, elapsed = _step(env, w[2:], s, a,
                                                        completed, elapsed)
        _, next_v = _first_max(q[acts + env.observe(s_mid)])
        target = rew + g_f * next_v * torch.where(done, 0.0, 1.0)
        wd = lr_f * (target - q_taken)
        addr = a * nsp + obs
        fx = torch.round(wd.double() * FIX_SCALE).long()
        acc = torch.zeros(nq, dtype=torch.int64, device=s.device).index_add_(0, addr, fx)
        dq = (acc.double() / FIX_SCALE).float()
        if average:
            cnt = torch.zeros(nq, dtype=torch.int64, device=s.device)
            cnt.index_add_(0, addr, torch.ones_like(addr))
            dq = dq / cnt.clamp(min=1).float()
        q = (q + dq).to(q_dtype).float()
        racc = racc + rew
    return s.to(torch.int32), q, racc


class PPOEnv:
    """The Taxi configuration as the PPO cell's collect check sees it:
    what the network reads, and each program transition held to the
    reference's step."""

    discrete, gaussian, n_act = True, False, 5

    def __init__(self, config: Dict, device, check=None):
        self.env = Taxi(config, device)
        self.n_in = self.env.n_obs

    def observe(self, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.env.observe(state["s"])

    def mismatches(self, st, action, mid, nxt, rew, done, trunc, obs) -> int:
        """Env-steps at which the program's step from state ``st`` under
        ``action`` differs from the reference's: the observation it acted
        on, the reward, the end flags, the state before the episode reset
        (``mid``: a task reset keeps the cell and draws a passenger and a
        different destination) and the next state (``mid``, or a fresh
        episode start where the episode ended)."""
        env, nl = self.env, self.env.nlocs
        s2, rew_r, done_r, trunc_r, goal, comp_r, el_r = advance(
            env, st["s"], action, st["completed"], st["elapsed"])
        reset = done_r | trunc_r
        task = goal & ~reset
        bad = (obs.long() != env.observe(st["s"])) | (rew.float() != rew_r) \
            | (done.bool() != done_r) | (trunc.bool() != trunc_r)
        ms = mid["s"].long()
        mp, md = (ms % env.pd) // nl, ms % nl
        bad |= torch.where(task, (ms // env.pd != s2 // env.pd) | (mp >= nl) | (md == mp),
                           ms != s2)
        bad |= (mid["completed"].long() != comp_r) | (mid["elapsed"].long() != el_r)
        ns = nxt["s"].long()
        np_, nd = (ns % env.pd) // nl, ns % nl
        fresh = (nxt["elapsed"] == 0) & (nxt["completed"] == 0) & (np_ < nl) \
            & (nd != np_) & torch.isin(ns // env.pd, env.valid)
        same = (ns == ms) & (nxt["elapsed"].long() == el_r) \
            & (nxt["completed"].long() == comp_r)
        bad |= torch.where(reset, ~fresh, ~same)
        return int(bad.sum())
