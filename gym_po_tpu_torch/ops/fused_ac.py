"""Fused tabular actor-critic on ROOMS: a hand-written CUDA kernel and its twin.

Port of the Pallas kernel
:func:`gym_po_tpu.ops.fused_ac.make_fused_ac_trainer_rooms`: one-step
softmax actor-critic (Sutton & Barto ch. 13) trained inside one launch.
Per env and step, with ``obs`` the observation of the agent's cell::

    a      = argmax_a' (θ[obs, a'] - log(-log u_a')),  u = (r24 + 0.5)·2⁻²⁴
    δ      = r + γ·v[obs']·(1-done) - v[obs]
    v[obs]     += α_v · δ
    θ[obs, a'] += α_π · δ · (1[a'=a] - π(a'|obs))    for every action a'

each of the ``A + 1`` updates averaged over the envs that visited ``obs``
in the step.  The kernel (``csrc/fused_ac.cu``) is one persistent
cooperative launch per call; its source note says what bounds it.  Both
add the updates as int64 fixed point at scale ``2**32`` (as
:func:`~gym_po_tpu_torch.ops.fused_qlearning.apply_update` does), so the
sums do not depend on their order.  Against the JAX kernel, whose sums run
through f32 matrix products, the tables agree to a tolerance; the
transcendentals (``log``, ``exp``) come from each framework's own library.

``run(seed, alpha_pi, alpha_v, theta, v, agent, *tape) -> (theta', v',
agent', reward_sums)`` keeps the JAX contract: ``theta`` f32 ``[32, 128]``
banked logits (entry ``(obs, a)`` at flat index ``a * 512 + obs``), ``v``
f32 ``[32, 128]`` with the values in banks 0..3, ``agent`` the flat-cell
tile ``[B // 128, 128]``.  On a CUDA tensor ``run`` launches the kernel (or
raises); on a CPU tensor it runs the twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import count_launch
from .fused_qlearning import (
    MAX_TERM,
    MAX_TERMS,
    NB,
    NSB,
    RoomsTrainerSpec,
    f32,
    first_argmax,
    fixed_point_sum,
)
from .kernel_rng import MASK32, KernelRNG, W, check_batch

__all__ = ["make_fused_ac_trainer_rooms", "apply_ac_update"]


class _ACParams(ctypes.Structure):
    """Mirror of ``ACParams`` in ``csrc/fused_ac.cu``."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "num_envs", "num_steps", "rows_per_tile", "n_sites", "ncells",
        "n_valid", "n_act", "time_limit", "nsp", "nq", "goal", "fixed_agent",
        "pfail24")]
    _fields_ += [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)]
    _fields_ += [(n, ctypes.c_float) for n in (
        "r_step", "r_wall", "r_goal", "gamma", "alpha_pi", "alpha_v")]
    _fields_ += [("n_obs", ctypes.c_int32)]


@functools.cache
def _launcher():
    from ._build import load_library

    fn = load_library("fused_ac").fused_ac_launch
    fn.argtypes = [ctypes.POINTER(_ACParams)] + [ctypes.c_void_p] * 16
    fn.restype = ctypes.c_int
    return fn


def apply_ac_update(th: torch.Tensor, v: torch.Tensor, qidx: torch.Tensor,
                    w_th: torch.Tensor, w_v: torch.Tensor, live: torch.Tensor,
                    nsp: int):
    """``(th', v')``: the flat tables plus one step's averaged updates, as
    the kernel computes them.  ``w_th`` is ``[A, B]`` (the term for
    ``(qidx, a)``), ``w_v`` is ``[B]``.  Every update of an observation is
    divided by its count of live envs; an env with a term past the fixed
    point's range turns all ``A + 1`` entries of its observation NaN."""
    A = w_th.shape[0]
    ok_v = w_v.abs() <= MAX_TERM
    ok_th = w_th.abs() <= MAX_TERM
    over = live & ~(ok_v & ok_th.all(0))
    q = torch.where(live, qidx, 0).long()
    addr = (torch.arange(A, device=q.device)[:, None] * nsp + q).reshape(-1)
    dv = fixed_point_sum(nsp, q, torch.where(live & ok_v, w_v, 0.0))
    dth = fixed_point_sum(A * nsp, addr,
                          torch.where(live & ok_th, w_th, 0.0).reshape(-1))
    cnt = torch.zeros(nsp, dtype=torch.int32, device=q.device)
    cnt.index_add_(0, q, live.to(torch.int32))
    n_over = torch.zeros_like(cnt).index_add_(0, q, over.to(torch.int32))
    div = cnt.clamp(min=1).float()
    dv = torch.where(n_over > 0, torch.nan, dv / div)
    dth = torch.where(n_over > 0, torch.nan, dth.view(A, nsp) / div).reshape(-1)
    pad = torch.zeros(th.numel(), dtype=torch.float32, device=th.device)
    return (th + torch.cat([dth, pad[dth.numel():]]),
            v + torch.cat([dv, pad[nsp:]]))


def make_fused_ac_trainer_rooms(env, num_envs: int, num_steps: int,
                                gamma: float = 0.99, rng_tape: bool = False):
    """Build ``run(seed, alpha_pi, alpha_v, theta, v, agent, *tape) ->
    (theta', v', agent', reward_sums)`` for a :class:`Rooms` env with a
    fixed goal (at most 512 observations, 4 or 8 actions).
    ``rng_tape=True`` makes ``run`` take a trailing int32 tape of
    ``run.tape_shape`` in place of Philox.
    """
    spec = RoomsTrainerSpec(env, num_envs, num_steps, "AC trainer")
    if num_envs > MAX_TERMS:
        raise ValueError(f"num_envs exceeds the fixed-point sum's {MAX_TERMS} "
                         "terms per step")
    A = spec.n_act
    nsp, nq = NSB * W, NB * W
    # draw sites per step, in body order: A Gumbel uniforms, then the ROOMS
    # step's (failure coin, alternative action, agent respawn)
    n_sites = A + spec.n_sites
    tape_shape = (KernelRNG.tape_rows(n_sites, num_steps, spec.R), W)
    B, K = num_envs, num_steps

    def check(theta, v, agent, tape):
        check_batch(agent, spec.R, rng_tape, tape_shape, tape)
        for name, x in (("theta", theta), ("v", v)):
            if (not isinstance(x, torch.Tensor) or x.dtype != torch.float32
                    or tuple(x.shape) != (NB, W) or not x.is_contiguous()
                    or x.device != agent.device):
                raise ValueError(f"{name} banks must be a contiguous float32 "
                                 f"tensor of shape {(NB, W)} on agent's device")

    def twin(seed: int, alpha_pi: float, alpha_v: float, theta: torch.Tensor,
             v: torch.Tensor, agent: torch.Tensor, *tape: torch.Tensor):
        """Plain PyTorch version of the kernel, on ``agent``'s device."""
        check(theta, v, agent, tape)
        dev = agent.device
        tab = spec.tables_on(dev)
        rng = KernelRNG(seed, B, K, n_sites, spec.R,
                        tape=tape[0] if rng_tape else None, device=dev)
        api, apv, g_f = (f32(x).to(dev) for x in (alpha_pi, alpha_v, gamma))
        s = agent.reshape(-1)
        live = (s >= 0) & (s < spec.ncells)  # out of range: inactive
        s = torch.where(live, s, 0)
        th, vv = theta.reshape(-1), v.reshape(-1)
        acts = (torch.arange(A, device=dev) * nsp)[:, None]
        elapsed = torch.zeros_like(s)
        racc = torch.zeros(B, dtype=torch.float32, device=dev)
        for step in range(K):
            rng.begin_step(step)
            qidx = spec.obs_of(tab, s)
            logits = th[acts + qidx]  # [A, B]
            pert = []
            for a in range(A):  # Gumbel-max, strictly interior uniforms
                u = (rng.r24().to(torch.float32) + 0.5) * (2.0**-24)
                pert.append(logits[a] + (-torch.log(-torch.log(u))))
            a_cmd, _ = first_argmax(torch.stack(pert))
            _, mx = first_argmax(logits)
            ex = [torch.exp(logits[a] - mx) for a in range(A)]
            z = ex[0]
            for a in range(1, A):
                z = z + ex[a]
            st = spec.q_step(rng, tab, s, a_cmd, (elapsed,))
            v_next = vv[spec.obs_of(tab, st.s_td)]
            delta = (st.rew + g_f * v_next * torch.where(st.done, 0.0, 1.0)
                     - vv[qidx])
            ad = api * delta
            w_th = torch.stack([
                ad * (torch.where(a_cmd == a, 1.0, 0.0) - ex[a] / z)
                for a in range(A)])
            th, vv = apply_ac_update(th, vv, qidx, w_th, apv * delta, live, nsp)
            s, (elapsed,) = st.s, st.carry
            racc = racc + st.rew
        rng.finalize(n_sites)
        return (th.reshape(NB, W), vv.reshape(NB, W),
                torch.where(live, s, -1).reshape(spec.R, W),
                torch.where(live, racc, torch.nan).reshape(spec.R, W))

    def run(seed: int, alpha_pi: float, alpha_v: float, theta: torch.Tensor,
            v: torch.Tensor, agent: torch.Tensor, *tape: torch.Tensor):
        """One K-step training call: the CUDA kernel on a CUDA tensor, the
        twin on a CPU tensor.  An agent outside the grid takes no part
        (``agent' = -1``, NaN reward sum)."""
        check(theta, v, agent, tape)
        if agent.device.type == "cpu":
            return twin(seed, alpha_pi, alpha_v, theta, v, agent, *tape)
        if agent.device.type != "cuda":
            raise ValueError(f"unsupported device {agent.device}")
        dev = agent.device
        wall, valid, disp, obs = spec.kernel_tables(dev)
        agent_out = torch.empty_like(agent)
        rew = torch.empty(agent.shape, dtype=torch.float32, device=dev)
        th_out, v_out = torch.empty_like(theta), torch.empty_like(v)
        # three accumulators used in rotation, each A + 1 sums and a count
        # per observation (a bound on their size: nsp >= n_obs)
        acc = torch.zeros(3 * (A + 1) * nsp, dtype=torch.int64, device=dev)
        cnt = torch.zeros(3 * nsp, dtype=torch.int32, device=dev)
        grid = (ctypes.c_int * 2)()
        P = _ACParams(
            num_envs=B, num_steps=K, rows_per_tile=spec.R, n_sites=n_sites,
            ncells=spec.ncells, n_valid=spec.n_valid, n_act=A,
            time_limit=spec.time_limit, nsp=nsp, nq=nq, goal=spec.goal,
            fixed_agent=spec.fixed_agent, pfail24=spec.pfail24,
            key0=seed & MASK32, key1=(seed >> 32) & MASK32, gamma=gamma,
            alpha_pi=alpha_pi, alpha_v=alpha_v, n_obs=spec.n_obs)
        P.r_step, P.r_wall, P.r_goal = spec.rewards
        ptrs = [x.data_ptr() for x in (
            agent, agent_out, rew, theta, v, th_out, v_out, acc, cnt, wall,
            valid, disp, obs)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launcher()(ctypes.byref(P), *ptrs,
                              tape[0].data_ptr() if rng_tape else None, grid,
                              stream)
        if err:
            raise RuntimeError(f"fused_ac_launch failed: CUDA error {err}")
        run.grid = (grid[0], grid[1])
        count_launch(run, "fused_ac")
        return th_out, v_out, agent_out, rew

    run.twin = twin
    run.launches = 0
    run.grid = None  # (blocks, envs per thread) of the last launch
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
