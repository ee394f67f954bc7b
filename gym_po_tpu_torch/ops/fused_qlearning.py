"""Fused tabular Q-learning on Taxi, ROOMS and MultistoryFourRooms: a
hand-written CUDA kernel and its twin.

Port of the Pallas kernels
:func:`gym_po_tpu.ops.fused_qlearning.make_fused_q_trainer` (Taxi),
:func:`gym_po_tpu.ops.fused_qlearning.make_fused_q_trainer_rooms` (ROOMS
with a fixed goal) and
:func:`gym_po_tpu.ops.fused_qlearning.make_fused_q_trainer_msrooms`
(MultistoryFourRooms with a fixed goal): K steps of epsilon-greedy acting, the env step, the TD
target from the state before the reset (Taxi: after the task reset, before
the full reset), and the batched update ``Q[obs, a] += lr * td`` (summed or
averaged over duplicates) every step.  Every option of the JAX functions is
here: on Taxi the classic and extended maps, Q indexed by state or by
Hansen observation, Expected SARSA, and Watkins or Peng Q(lambda) over a
ring of the last ``trace_len`` table addresses; on ROOMS Q indexed through
a per-cell table of the env's own observation, the update on the
commanded action, and the same Q(lambda)
(:mod:`gym_po_tpu_torch.ops.fused_qlambda`); on MultistoryFourRooms the
same as on ROOMS over flat zyx cells with the stair transit, one-step.

The kernel (``csrc/fused_qlearning.cu``) is one persistent cooperative
launch per call, templated over the env; its source note says what bounds
it on the card and what the design does about that.  ``run.twin`` is the
plain PyTorch version of the same function.  Both add each step's contributions as int64 fixed point
at scale ``2**32`` (:func:`apply_update`), so the sums do not depend on
their order and the kernel equals the twin bit for bit.

``run(seed, lr, epsilon, s, q_banks, *tape) -> (s', q_banks', reward_sums)``
keeps the JAX package's contract: ``s`` int32 ``[B // 128, 128]``,
``q_banks`` f32 ``[nb, 128]``.  The banks are a reshape of the flat table:
entry ``(obs, a)`` sits at flat index ``a * nsb * 128 + obs``
(:func:`q_to_banks`, :func:`banks_to_q`).  On ROOMS ``s`` holds flat
agent cells (``y * W + x``), on MultistoryFourRooms ``z * H * W + y * W +
x``.  ``seed`` is an int (the Philox key).  On a CUDA tensor ``run`` launches the kernel (or raises); on a CPU
tensor it runs the twin.

As in the JAX kernels, ``completed``, ``elapsed`` and the trace start from
zero at every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._build import count_launch
from .kernel_rng import MASK32, KernelRNG, UDiv, W, check_batch
from .msrooms_dynamics import MSRoomsDynamics
from .rooms_dynamics import RoomsDynamics
from .taxi_dynamics import TaxiDynamics

__all__ = [
    "make_fused_q_trainer",
    "make_fused_q_trainer_rooms",
    "make_fused_q_trainer_msrooms",
    "bank_geometry",
    "fixed_point_sum",
    "q_to_banks",
    "banks_to_q",
    "apply_update",
]

NB = 32  # default Q bank rows: 5 actions x (512 / 128) obs banks, padded
NSB = 4  # default obs banks per action
MAX_TRACE = 64
FIX_SCALE = 2.0**32  # fixed point of the summed updates
MAX_TERM = 2.0**6  # largest |lr * td| one term may carry
# terms summed into one entry per step: at 2^24 terms of |w| <= 2^6 the
# int64 sum stays below 2^62
MAX_TERMS = 2**24


def bank_geometry(idx_n: int, n_act: int) -> Tuple[int, int]:
    """``(nsb, nb)``: obs banks per action and total bank rows (8-aligned,
    at least 32) for an ``idx_n``-entry index space."""
    nsb = max(NSB, -(-idx_n // W))
    nb = max(NB, -(-(n_act * nsb) // 8) * 8)
    return nsb, nb


def q_to_banks(q: np.ndarray, nsb: int = NSB) -> np.ndarray:
    """``[ns, na]`` table -> ``[nb, 128]`` banks (entry ``(s, a)`` at flat
    index ``a * nsb * 128 + s``)."""
    ns, na = q.shape
    if ns > nsb * W:
        raise ValueError(f"{ns} rows do not fit {nsb} banks per action")
    nb = max(NB, -(-(na * nsb) // 8) * 8)
    out = np.zeros(nb * W, np.float32)
    for a in range(na):
        out[a * nsb * W: a * nsb * W + ns] = q[:, a]
    return out.reshape(nb, W)


def banks_to_q(banks: np.ndarray, ns: int, na: int = 5,
               nsb: int = NSB) -> np.ndarray:
    """Inverse of :func:`q_to_banks`."""
    flat = np.asarray(banks, np.float32).reshape(-1)
    q = np.zeros((ns, na), np.float32)
    for a in range(na):
        q[:, a] = flat[a * nsb * W: a * nsb * W + ns]
    return q


def fixed_point_sum(n: int, addr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[n]`` f32 sums of ``w`` by ``addr``, as the kernels add them: each
    term rounded to int64 at scale 2^32 (half to even), the sum converted
    once.  Every ``|w|`` must be within ``MAX_TERM``."""
    fx = torch.round(w.double() * FIX_SCALE).long()
    acc = torch.zeros(n, dtype=torch.int64, device=w.device)
    return (acc.index_add_(0, addr, fx).double() / FIX_SCALE).float()


def apply_update(q: torch.Tensor, addr: torch.Tensor, w: torch.Tensor,
                 live: torch.Tensor, average: bool) -> torch.Tensor:
    """``q + dq`` with ``dq[i]`` the sum of the live ``w`` at ``addr == i``
    (divided by their count when ``average``), as the kernel computes it:
    each f32 ``w`` rounded to int64 at scale 2^32 (half to even), the int64
    sum converted once, then an f32 division.

    The fixed point holds ``|w| <= MAX_TERM`` per term.  An entry that takes
    a larger or non-finite term becomes NaN: a diverging run turns Q
    non-finite, as the JAX package's f32 sums do once they overflow, instead
    of wrapping round in int64."""
    over = live & ~(w.abs() <= MAX_TERM)
    ok = live & ~over
    addr = torch.where(live, addr, 0).long()
    dq = fixed_point_sum(q.numel(), addr, torch.where(ok, w, 0.0))
    if average:
        cnt = torch.zeros(q.numel(), dtype=torch.int32, device=q.device)
        cnt.index_add_(0, addr, ok.to(torch.int32))
        dq = dq / cnt.clamp(min=1).float()
    n_over = torch.zeros(q.numel(), dtype=torch.int32, device=q.device)
    n_over.index_add_(0, addr, over.to(torch.int32))
    return q + torch.where(n_over > 0, torch.nan, dq)




class _QParams(ctypes.Structure):
    """Mirror of ``QParams`` in ``csrc/fused_qlearning.cu``."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "num_envs", "num_steps", "rows_per_tile", "n_sites", "nlocs", "rows",
        "cols", "n_valid", "all_valid", "hansen", "n_pass", "time_limit",
        "nsp", "nq", "average", "expected_sarsa", "trace_len", "watkins_cut")]
    _fields_ += [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)]
    _fields_ += [(n, ctypes.c_float) for n in (
        "r_goal", "r_bad", "r_any", "gamma", "lr", "eps")]
    _fields_ += [("coefs", ctypes.c_float * MAX_TRACE)]
    _fields_ += [(n, ctypes.c_int32) for n in (
        "n_act", "goal", "fixed_agent", "pfail24", "floor_cells", "up_to",
        "down_to", "n_obs")]
    _fields_ += [("floor_div", UDiv)]


@functools.cache
def _launcher(name: str):
    from ._build import load_library

    fn = getattr(load_library("fused_qlearning"), name)
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.POINTER(_QParams)] + [p] * 15
    fn.restype = ctypes.c_int
    return fn


class QStep(NamedTuple):
    """What the trainers need of one env step (``QStep`` in the kernel)."""

    s_td: torch.Tensor  # the state the TD target bootstraps from
    s: torch.Tensor  # the next state, after a reset
    rew: torch.Tensor
    done: torch.Tensor  # cuts the bootstrap
    reset: torch.Tensor  # the episode ended: the trace dies
    carry: tuple  # the env's counters, zeroed at a reset


class _TrainerSpec:
    """The trainer kernels' launch and input checks, shared by the envs:
    each subclass adds its env's step, observation index and tables."""

    n_act: int
    ns: int  # input states outside [0, ns) take no part

    def _init_batch(self, num_envs: int, num_steps: int) -> None:
        if num_envs % W:
            raise ValueError("num_envs must be a multiple of 128")
        if (num_envs // W) % 8:
            raise ValueError("num_envs must be a multiple of 1024")
        self.num_envs, self.num_steps = num_envs, num_steps
        self.R = num_envs // W  # the JAX trainer is one tile of R rows

    def check(self, s: torch.Tensor, q: torch.Tensor, nq: int, rng_tape: bool,
              tape_shape, tape: Tuple[torch.Tensor, ...]) -> None:
        check_batch(s, self.R, rng_tape, tape_shape, tape)
        if (not isinstance(q, torch.Tensor) or q.dtype != torch.float32
                or tuple(q.shape) != (nq // W, W) or not q.is_contiguous()
                or q.device != s.device):
            raise ValueError(f"q banks must be a contiguous float32 tensor of "
                             f"shape {(nq // W, W)} on s's device")

    def launch(self, name: str, P: _QParams, s: torch.Tensor, q: torch.Tensor,
               tape: Optional[torch.Tensor], trace_len: int):
        """Launch ``name`` on ``s``'s CUDA device; returns ``(s', q',
        reward_sums, grid)``: ``grid`` is ``(blocks, envs_per_thread,
        side)``.  With a trace ``side`` is 1 when the trace ring was kept
        in shared memory and 0 when it went to its global buffer; one-step,
        1 when the update sums went through the block's shared-memory slab
        and 0 when each term went straight to the global accumulator."""
        if s.device.type != "cuda":
            raise ValueError(f"unsupported device {s.device}")
        tabs = self.kernel_tables(s.device)
        dev, B = s.device, self.num_envs
        s_out = torch.empty_like(s)
        rew = torch.empty(s.shape, dtype=torch.float32, device=dev)
        q_out = torch.empty_like(q)
        # three accumulators used in rotation, one a step (a bound on
        # their size: the kernel's compact index stays below q's)
        n_acc = 3 * q.numel()
        acc = torch.zeros(n_acc, dtype=torch.int64, device=dev)
        cnt = torch.zeros(n_acc, dtype=torch.int32, device=dev)
        # the trace ring's place when it does not fit in shared memory
        ring = (torch.empty(trace_len * B, dtype=torch.int32, device=dev)
                if trace_len > 1 else None)
        grid = (ctypes.c_int * 3)()

        def ptr(x):
            return None if x is None else x.data_ptr()

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launcher(name)(
                ctypes.byref(P), ptr(s), ptr(s_out), ptr(rew), ptr(q),
                ptr(q_out), ptr(acc), ptr(cnt), ptr(ring), *map(ptr, tabs),
                ptr(tape), grid, stream,
            )
        if err:
            raise RuntimeError(f"{name} failed: CUDA error {err}")
        return s_out, q_out, rew, tuple(grid)


class TaxiTrainerSpec(_TrainerSpec, TaxiDynamics):
    """The Taxi step as the Q trainers see it.  Shared by this module and
    :mod:`gym_po_tpu_torch.ops.fused_double_q`."""

    n_act = 5
    entry = "fused_q_launch"

    def __init__(self, env, num_envs: int, num_steps: int):
        TaxiDynamics.__init__(self, env)
        self._init_batch(num_envs, num_steps)
        self.n_obs = int(env.observation_space.n)

    def kernel_tables(self, device):
        tab = self.tables_on(device)
        return tab["cm"], tab["la"], tab["hc"], tab["vc"]

    def params(self, n_sites: int, nsp: int, nq: int, seed: int, lr: float,
               epsilon: float, gamma: float, average: bool) -> _QParams:
        P = _QParams(
            num_envs=self.num_envs, num_steps=self.num_steps,
            rows_per_tile=self.R, n_sites=n_sites, nlocs=self.nlocs,
            rows=self.rows, cols=self.cols, n_valid=self.n_valid,
            all_valid=int(self.all_valid), hansen=int(self.hansen),
            n_pass=self.n_pass, time_limit=self.time_limit, nsp=nsp, nq=nq,
            average=int(average), expected_sarsa=0, trace_len=1,
            watkins_cut=0, key0=seed & MASK32, key1=(seed >> 32) & MASK32,
            gamma=gamma, lr=lr, eps=epsilon, n_act=5, goal=-1, fixed_agent=-1,
        )
        P.r_goal, P.r_bad, P.r_any = self.rewards
        return P

    def carry0(self, s: torch.Tensor):
        return torch.zeros_like(s), torch.zeros_like(s)  # completed, elapsed

    def q_step(self, rng: KernelRNG, tab, s, a, carry) -> QStep:
        st = self.step(rng, tab, s, a, *carry)
        return QStep(st.s_mid, st.s, st.rew, st.done, st.reset,
                     (st.completed, st.elapsed))


class _CellTrainerSpec(_TrainerSpec):
    """The ROOMS-family step as the Q trainers see it, over flat cells: a
    fixed goal, Q indexed by the per-cell observation table, ``elapsed``
    carried, the failure coin ``r24() < int(p_fail * 2**24)`` and the
    alternative action, then the agent respawn at the last site
    (:meth:`respawn`).  A subclass also inherits its env's dynamics."""

    def _init_cells(self, dynamics, env, num_envs: int, num_steps: int,
                    fixed_goal, what: str) -> None:
        """Refuse what the kernel does not take, then set up ``dynamics``
        (the subclass's dynamics class) with the observation table."""
        from ..core import Discrete

        if not isinstance(env.observation_space, Discrete):
            raise ValueError(f"{what} needs a Discrete observation space")
        self.n_obs = int(env.observation_space.n)
        if self.n_obs > NSB * W:
            raise ValueError(f"n_obs={self.n_obs} > {NSB * W}: Q banks would "
                             f"exceed {NB} rows")
        if fixed_goal is None:
            raise ValueError(f"{what} requires a fixed goal")
        if int(env.num_actions) * NSB > NB:
            raise ValueError(f"{env.num_actions} actions exceed the {NB}-row "
                             "Q bank")
        dynamics.__init__(self, env, obs_table=True)
        self._init_batch(num_envs, num_steps)
        self.ns = self.ncells
        self.pfail24 = int(self.p_fail * (1 << 24))

    def obs_of(self, tab, s: torch.Tensor) -> torch.Tensor:
        return tab["obs"][s.long()]

    def carry0(self, s: torch.Tensor):
        return (torch.zeros_like(s),)  # elapsed

    def q_step(self, rng: KernelRNG, tab, s, a, carry) -> QStep:
        fail = rng.r24() < self.pfail24
        alt = rng.rbits(self.n_act - 1)
        mv = self.move(tab, s, self.goal, self.executed(fail, alt, a), carry[0])
        spawn = self.respawn(tab, rng)
        return QStep(mv.agent, torch.where(mv.reset, spawn, mv.agent), mv.rew,
                     mv.done, mv.reset, (mv.elapsed,))


class RoomsTrainerSpec(_CellTrainerSpec, RoomsDynamics):
    """The ROOMS step as the Q trainers see it: the agent respawn draws a
    walkable cell, or takes the fixed agent without a draw.  Shared by this
    module, :mod:`.fused_qlambda` and :mod:`.fused_ac`."""

    entry = "fused_q_rooms_launch"

    def __init__(self, env, num_envs: int, num_steps: int, what: str):
        self._init_cells(RoomsDynamics, env, num_envs, num_steps,
                         env.fixed_goal_yx, what)
        # draw sites of the step, after the trainer's own: failure coin,
        # alternative action, agent respawn (fixed spawn: no draw)
        self.n_sites = 2 + int(self.fixed_agent < 0)

    def kernel_tables(self, device):
        tab = self.tables_on(device)
        return tab["wall"], tab["valid"], tab["disp"], tab["obs"]

    def params(self, n_sites: int, nsp: int, nq: int, seed: int, lr: float,
               epsilon: float, gamma: float, average: bool) -> _QParams:
        P = _QParams(
            num_envs=self.num_envs, num_steps=self.num_steps,
            rows_per_tile=self.R, n_sites=n_sites, rows=self.H, cols=self.W,
            n_valid=self.n_valid, time_limit=self.time_limit, nsp=nsp, nq=nq,
            average=int(average), trace_len=1, key0=seed & MASK32,
            key1=(seed >> 32) & MASK32, gamma=gamma, lr=lr, eps=epsilon,
            n_act=self.n_act, goal=self.goal, fixed_agent=self.fixed_agent,
            pfail24=self.pfail24,
        )
        P.r_any, P.r_bad, P.r_goal = self.rewards  # step, wall, goal
        return P

    def respawn(self, tab, rng: KernelRNG):
        return self.spawn(tab, rng) if self.fixed_agent < 0 else self.fixed_agent


class MSRoomsTrainerSpec(_CellTrainerSpec, MSRoomsDynamics):
    """The MultistoryFourRooms step as the Q trainer sees it: the agent
    respawn draws a ground-floor cell, and takes it even where the env has
    a fixed agent, as the JAX kernel does (ROADMAP Queue 3)."""

    entry = "fused_q_msrooms_launch"
    n_sites = 3  # the step's: failure coin, alternative action, respawn

    def __init__(self, env, num_envs: int, num_steps: int):
        self._init_cells(MSRoomsDynamics, env, num_envs, num_steps,
                         env.fixed_goal_zyx, "msrooms Q trainer")

    def kernel_tables(self, device):
        tab = self.tables_on(device)
        return tab["cell"], tab["agent_bank"], tab["disp"], tab["obs"]

    def params(self, n_sites: int, nsp: int, nq: int, seed: int, lr: float,
               epsilon: float, gamma: float, average: bool) -> _QParams:
        P = _QParams(
            num_envs=self.num_envs, num_steps=self.num_steps,
            rows_per_tile=self.R, n_sites=n_sites, rows=self.Z * self.H,
            cols=self.W, n_valid=self.n_agent, time_limit=self.time_limit,
            nsp=nsp, nq=nq, average=int(average), trace_len=1,
            key0=seed & MASK32, key1=(seed >> 32) & MASK32, gamma=gamma,
            lr=lr, eps=epsilon, n_act=self.n_act, goal=self.goal,
            fixed_agent=-1, pfail24=self.pfail24, floor_cells=self.HW,
            up_to=self.up_to, down_to=self.down_to,
            floor_div=UDiv.of(self.HW),
        )
        P.r_any, P.r_bad, P.r_goal = self.rewards  # step, wall, goal
        return P

    def respawn(self, tab, rng: KernelRNG):
        return self.spawn_agent(tab, rng)


def first_argmax(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """First maximum (strict ``>``) over the leading axis of ``[A, B]``."""
    best_v = vals[0]
    best_a = torch.zeros_like(best_v, dtype=torch.int32)
    for a in range(1, vals.shape[0]):
        better = vals[a] > best_v
        best_v = torch.where(better, vals[a], best_v)
        best_a = torch.where(better, a, best_a)
    return best_a, best_v


def f32(x: float) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def trace_coefs(gamma: float, lam: float, trace_len: int):
    """``(γλ)^k`` in f32 for ``k < trace_len``, trimmed after the last
    nonzero one (so ``lam = 0`` keeps one term, the one-step update)."""
    if not 0.0 <= float(lam) <= 1.0:
        raise ValueError(f"lam={lam} out of range [0, 1]")
    if not 1 <= int(trace_len) <= MAX_TRACE:
        raise ValueError(f"trace_len={trace_len} out of range [1, {MAX_TRACE}]")
    coefs = [np.float32((float(gamma) * float(lam)) ** k)
             for k in range(int(trace_len))]
    L = max(k for k, c in enumerate(coefs) if float(c) != 0.0) + 1
    return coefs[:L]


def _make_trainer(spec, count_name: str, gamma: float, average: bool,
                  expected_sarsa: bool, coefs, use_trace: bool,
                  watkins_cut: bool, rng_tape: bool):
    """``run`` and its twin for one env's spec; ``coefs`` are the trace's
    ``(γλ)^k`` (one term without a trace)."""
    L = len(coefs) if use_trace else 1
    if spec.num_envs * L > MAX_TERMS:
        raise ValueError(f"num_envs * trace_len = {spec.num_envs * L} exceeds "
                         f"the fixed-point sum's {MAX_TERMS} terms per step")
    A = spec.n_act
    nsb, nb = bank_geometry(int(spec.n_obs), A)
    nsp, nq = nsb * W, nb * W
    # draw sites per step, in body order: explore r24, random action, then
    # the env step's
    n_sites = 2 + spec.n_sites
    tape_shape = (KernelRNG.tape_rows(n_sites, spec.num_steps, spec.R), W)
    B, K = spec.num_envs, spec.num_steps

    def twin(seed: int, lr: float, epsilon: float, s: torch.Tensor,
             q: torch.Tensor, *tape: torch.Tensor):
        """Plain PyTorch version of the kernel, on ``s``'s device."""
        spec.check(s, q, nq, rng_tape, tape_shape, tape)
        dev = s.device
        tab = spec.tables_on(dev)
        rng = KernelRNG(seed, B, K, n_sites, spec.R,
                        tape=tape[0] if rng_tape else None, device=dev)
        lr_f, eps_f, g_f = (f32(x).to(dev) for x in (lr, epsilon, gamma))
        eps24 = int(np.float32(epsilon) * np.float32(1 << 24))
        coef_f = [torch.tensor(c, device=dev) for c in coefs]
        s = s.reshape(-1)
        live = (s >= 0) & (s < spec.ns)  # out of range: inactive, s' = -1
        s = torch.where(live, s, 0)
        q = q.reshape(-1)
        acts = (torch.arange(A, device=dev) * nsp)[:, None]
        carry = spec.carry0(s)
        age = torch.zeros_like(s)
        racc = torch.zeros(B, dtype=torch.float32, device=dev)
        ring = torch.zeros((L, B), dtype=torch.int64, device=dev)
        n_terms = torch.zeros((), dtype=torch.int64, device=dev)
        for step in range(K):
            rng.begin_step(step)
            qidx = spec.obs_of(tab, s)
            vals = q[acts + qidx]
            greedy, best_v = first_argmax(vals)
            explore = rng.r24() < eps24
            a = torch.where(explore, rng.rbits(A), greedy)
            q_taken = vals.gather(0, a[None].long())[0]
            if use_trace and watkins_cut:
                age = torch.where(q_taken < best_v, 0, age)
            st = spec.q_step(rng, tab, s, a, carry)
            # TD target from the state before the reset
            vals2 = q[acts + spec.obs_of(tab, st.s_td)]
            _, next_v = first_argmax(vals2)
            if expected_sarsa:  # Taxi only: 0.2 = 1/5 actions
                ssum = vals2[0]
                for i in range(1, A):
                    ssum = ssum + vals2[i]
                next_v = (1.0 - eps_f) * next_v + (eps_f * f32(0.2)) * ssum
            target = st.rew + g_f * next_v * torch.where(st.done, 0.0, 1.0)
            wd = lr_f * (target - q_taken)
            addr = a.long() * nsp + qidx
            if use_trace:
                ring[step % L] = addr
                age = torch.clamp(age + 1, max=L)
                ks = range(L)
                terms = torch.cat([live & (k < age) for k in ks])
                q = apply_update(
                    q, torch.cat([ring[(step - k) % L] for k in ks]),
                    torch.cat([coef_f[k] * wd for k in ks]), terms, average)
            else:
                terms = live
                q = apply_update(q, addr, wd, live, average)
            n_terms = n_terms + terms.sum()
            s, carry = st.s, st.carry
            age = torch.where(st.reset, 0, age)  # the trace dies at resets
            racc = racc + st.rew
        rng.finalize(n_sites)
        twin.terms = n_terms  # update terms applied, for a count of the work
        return (torch.where(live, s, -1).reshape(spec.R, W),
                q.reshape(nb, W),
                torch.where(live, racc, torch.nan).reshape(spec.R, W))

    def run(seed: int, lr: float, epsilon: float, s: torch.Tensor,
            q: torch.Tensor, *tape: torch.Tensor):
        """One K-step training call: the CUDA kernel on a CUDA tensor, the
        twin on a CPU tensor.  An env whose input state lies outside
        ``[0, ns)`` takes no part (``s' = -1``, NaN reward sum)."""
        spec.check(s, q, nq, rng_tape, tape_shape, tape)
        if s.device.type == "cpu":
            return twin(seed, lr, epsilon, s, q, *tape)
        P = spec.params(n_sites, nsp, nq, seed, lr, epsilon, gamma, average)
        P.expected_sarsa = int(expected_sarsa)
        P.trace_len = L
        P.watkins_cut = int(watkins_cut)
        P.n_obs = int(spec.n_obs)
        for k, c in enumerate(coefs[:L]):
            P.coefs[k] = c
        *out, run.grid = spec.launch(spec.entry, P, s, q,
                                     tape[0] if rng_tape else None, L)
        count_launch(run, count_name)
        return tuple(out)

    run.twin = twin
    run.launches = 0
    # (blocks, envs per thread, side) of the last launch: with a trace the
    # ring's (1: in shared memory, 0: in global memory), one-step the update
    # sums' (1: the block's shared-memory slab, 0: the global accumulator)
    run.grid = None
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    run.trace_len = L
    return run


def make_fused_q_trainer(env, num_envs: int, num_steps: int,
                         gamma: float = 0.99,
                         average_duplicates: bool = False,
                         expected_sarsa: bool = False,
                         lam: float = 0.0,
                         trace_len: int = 8,
                         watkins_cut: bool = True,
                         rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, s, q_banks, *tape) -> (s', q_banks',
    reward_sums)`` for a Taxi env.

    ``expected_sarsa=True`` bootstraps from the expectation under the
    epsilon-greedy policy, ``(1-eps)·max_a Q + (eps·0.2)·Σ_a Q``.
    ``average_duplicates=False`` sums same-entry updates within a step (the
    effective step is then ``lr × B/ns``, which diverges for
    ``lr ≳ ns/B``); ``True`` divides each entry's sum by its count.  A
    term ``|lr·td|`` above ``MAX_TERM`` (2^6) is past the fixed-point sum's
    range and turns its entry NaN (:func:`apply_update`), so a diverging
    run goes non-finite, as it does in the JAX package.
    ``lam > 0`` switches to Q(λ): the last ``trace_len`` (obs, action)
    addresses per env, each updated with ``(γλ)^k · lr·td`` (the ring is
    trimmed to the nonzero weights); ``watkins_cut=True`` clears the trace
    before the update at a non-greedy-valued action (Watkins), ``False``
    keeps it (Peng).  The trace survives task resets and dies at full
    resets.  ``rng_tape=True`` makes ``run`` take a trailing int32 tape of
    ``run.tape_shape`` in place of Philox.
    """
    coefs = trace_coefs(gamma, lam, trace_len)
    if float(lam) > 0.0 and expected_sarsa:
        raise ValueError("lam > 0 requires the max bootstrap "
                         "(expected_sarsa=False)")
    spec = TaxiTrainerSpec(env, num_envs, num_steps)
    return _make_trainer(spec, "fused_qlearning", gamma, average_duplicates,
                         expected_sarsa, coefs,
                         float(lam) > 0.0 and len(coefs) > 1, watkins_cut,
                         rng_tape)


def make_rooms_trainer(env, num_envs: int, num_steps: int, gamma: float,
                       average_duplicates: bool, lam: float, trace_len: int,
                       watkins_cut: bool, rng_tape: bool, count_name: str,
                       what: str):
    """The ROOMS one-step and Q(λ) trainers: one kernel, one twin.  The
    trace ring is kept even when trimmed to one term, as in the JAX Q(λ)
    kernel (it then equals the one-step trainer bit for bit)."""
    coefs = trace_coefs(gamma, lam, trace_len)
    spec = RoomsTrainerSpec(env, num_envs, num_steps, what)
    return _make_trainer(spec, count_name, gamma, average_duplicates, False,
                         coefs, True, watkins_cut, rng_tape)


def make_fused_q_trainer_rooms(env, num_envs: int, num_steps: int,
                               gamma: float = 0.99,
                               average_duplicates: bool = False,
                               rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, agent, q_banks, *tape) -> (agent',
    q_banks', reward_sums)`` for a :class:`Rooms` env with a fixed goal.

    ``agent`` is the flat-cell tile ``[B // 128, 128]``; Q (``[32, 128]``
    banks, at most 512 observations and 8 actions) is indexed by the
    observation of the agent's cell, from the env's own observation
    function, and updated on the commanded action.  ``lr = epsilon = 0``
    evaluates the greedy policy of the supplied table.
    """
    return make_rooms_trainer(env, num_envs, num_steps, gamma,
                              average_duplicates, 0.0, 1, True, rng_tape,
                              "fused_q_rooms", "rooms Q trainer")


def make_fused_q_trainer_msrooms(env, num_envs: int, num_steps: int,
                                 gamma: float = 0.99,
                                 average_duplicates: bool = False,
                                 rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, agent, q_banks, *tape) -> (agent',
    q_banks', reward_sums)`` for a :class:`MultistoryFourRooms` env with a
    fixed goal.

    ``agent`` is the flat zyx cell tile ``[B // 128, 128]``; Q (``[32,
    128]`` banks, at most 512 observations, so at most 4 floors with mdp
    obs) is indexed by the observation of the agent's cell, from the env's
    own observation function, and updated on the commanded action.  The
    agent respawns from the ground-floor bank, as in the JAX kernel.
    """
    spec = MSRoomsTrainerSpec(env, num_envs, num_steps)
    return _make_trainer(spec, "fused_q_msrooms", gamma, average_duplicates,
                         False, trace_coefs(gamma, 0.0, 1), False, False,
                         rng_tape)
