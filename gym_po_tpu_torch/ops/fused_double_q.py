"""Fused double Q-learning on classic Taxi: a CUDA kernel and its twin.

Port of the Pallas kernel
:func:`gym_po_tpu.ops.fused_double_q.make_fused_double_q_trainer` (van
Hasselt 2010).  Two tables, A and B, stacked in one ``[2·nb, 128]`` array;
per env and step a coin ``c`` picks the table to update::

    a* = argmax_a Q_c(s', a)            (select with the updating table)
    td = r + γ·Q_{1-c}(s', a*) - Q_c(s, a)
    Q_c[s, a] += lr·td

Behaviour is epsilon-greedy on ``Q_A + Q_B``.  The kernel is the double-Q
entry point of ``csrc/fused_qlearning.cu`` (the same persistent cooperative
design and the same fixed-point update as
:func:`~gym_po_tpu_torch.ops.fused_qlearning.make_fused_q_trainer`, whose
contract this keeps on the stacked tables); ``run.twin`` is its plain
PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import count_launch
from .fused_qlearning import (
    W,
    TaxiTrainerSpec,
    apply_update,
    bank_geometry,
    f32,
    first_argmax,
)
from .kernel_rng import KernelRNG

__all__ = ["make_fused_double_q_trainer"]


def make_fused_double_q_trainer(env, num_envs: int, num_steps: int,
                                gamma: float = 0.99,
                                average_duplicates: bool = True,
                                rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, s, q2, *tape) -> (s', q2',
    reward_sums)``.

    ``q2`` is the stacked ``[2·nb, 128]`` pair of banked tables (A then B:
    ``np.concatenate([q_to_banks(qa), q_to_banks(qb)])``).  Classic map
    only, and Q is indexed by state (on the Hansen variant too), as in the
    JAX package.
    """
    t = env.tables
    if t.rows * t.cols * 4 > W:
        raise ValueError("double-Q trainer supports the classic map only")
    if not env._all_cells_valid:
        raise ValueError("double-Q trainer requires all cells navigable")
    spec = TaxiTrainerSpec(env, num_envs, num_steps)
    nsb, nb = bank_geometry(spec.ns, 5)
    nsp, nq1 = nsb * W, nb * W
    nq = 2 * nq1
    # draw sites per step, in body order: explore r24, random action, table
    # coin, then the Taxi step's (taxi_dynamics.py): 9 on the classic map
    n_sites = 3 + spec.n_sites
    tape_shape = (KernelRNG.tape_rows(n_sites, num_steps, spec.R), W)
    B = num_envs

    def twin(seed: int, lr: float, epsilon: float, s: torch.Tensor,
             q2: torch.Tensor, *tape: torch.Tensor):
        """Plain PyTorch version of the kernel, on ``s``'s device."""
        spec.check(s, q2, nq, rng_tape, tape_shape, tape)
        dev = s.device
        tab = spec.tables_on(dev)
        rng = KernelRNG(seed, B, num_steps, n_sites, spec.R,
                        tape=tape[0] if rng_tape else None, device=dev)
        lr_f, g_f = f32(lr).to(dev), f32(gamma).to(dev)
        eps24 = int(np.float32(epsilon) * np.float32(1 << 24))
        s = s.reshape(-1)
        live = (s >= 0) & (s < spec.ns)
        s = torch.where(live, s, 0)
        q = q2.reshape(-1)
        acts = (torch.arange(5, device=dev) * nsp)[:, None]
        completed = elapsed = torch.zeros_like(s)
        racc = torch.zeros(B, dtype=torch.float32, device=dev)
        for step in range(num_steps):
            rng.begin_step(step)
            va, vb = q[acts + s], q[nq1 + acts + s]
            greedy, _ = first_argmax(va + vb)
            explore = rng.r24() < eps24
            a = torch.where(explore, rng.rbits(5), greedy)
            coin = rng.rbits(2)  # 0: update A, 1: update B
            a_l = a[None].long()
            q_taken = torch.where(coin == 0, va.gather(0, a_l)[0],
                                  vb.gather(0, a_l)[0])
            st = spec.step(rng, tab, s, a, completed, elapsed)
            va2, vb2 = q[acts + st.s_mid], q[nq1 + acts + st.s_mid]
            sel_a, _ = first_argmax(va2)
            sel_b, _ = first_argmax(vb2)
            next_v = torch.where(coin == 0, vb2.gather(0, sel_a[None].long())[0],
                                 va2.gather(0, sel_b[None].long())[0])
            target = st.rew + g_f * next_v * torch.where(st.done, 0.0, 1.0)
            wd = lr_f * (target - q_taken)
            addr = coin.long() * nq1 + a.long() * nsp + s
            q = apply_update(q, addr, wd, live, average_duplicates)
            s, completed, elapsed = st.s, st.completed, st.elapsed
            racc = racc + st.rew
        rng.finalize(n_sites)
        return (torch.where(live, s, -1).reshape(spec.R, W),
                q.reshape(2 * nb, W),
                torch.where(live, racc, torch.nan).reshape(spec.R, W))

    def run(seed: int, lr: float, epsilon: float, s: torch.Tensor,
            q2: torch.Tensor, *tape: torch.Tensor):
        """One K-step training call: the CUDA kernel on a CUDA tensor, the
        twin on a CPU tensor."""
        spec.check(s, q2, nq, rng_tape, tape_shape, tape)
        if s.device.type == "cpu":
            return twin(seed, lr, epsilon, s, q2, *tape)
        P = spec.params(n_sites, nsp, nq, seed, lr, epsilon, gamma,
                        average_duplicates)
        P.n_obs = spec.ns  # both tables are indexed by state
        *out, run.grid = spec.launch("fused_double_q_launch", P, s, q2,
                                     tape[0] if rng_tape else None, 1)
        count_launch(run, "fused_double_q")
        return tuple(out)

    run.twin = twin
    run.launches = 0
    # (blocks, envs per thread, side) of the last launch; side 1: the
    # update sums went through the block's shared-memory slab, 0: straight
    # to the global accumulator
    run.grid = None
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
