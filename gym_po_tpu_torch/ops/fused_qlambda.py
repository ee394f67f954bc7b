"""Fused Watkins/Peng Q(λ) on ROOMS: the trainer kernel and its twin.

Port of the Pallas kernel
:func:`gym_po_tpu.ops.fused_qlambda.make_fused_qlambda_trainer_rooms`.
Backward-view TD(λ) with the trace truncated to the last ``L`` visited
(obs, action) addresses per env, kept as a ring::

    δ_t = r + γ·max_a Q(s',a)·(1-done) - Q(s_t,a_t)
    Q[s_{t-k}, a_{t-k}] += lr · (γλ)^k · δ_t      for k = 0..L-1

Watkins' variant cuts the trace before the update when the taken action is
not greedy-valued (a value compare: argmax ties count as greedy); Peng's
keeps it.  The trace dies at resets and restarts at every call.  The ring
is trimmed after the last nonzero ``(γλ)^k`` in f32, so ``lam = 0`` is the
one-step trainer bit for bit.

It is the ROOMS instantiation of the one trainer kernel in
``csrc/fused_qlearning.cu`` (:func:`.fused_qlearning.make_rooms_trainer`),
which adds the L terms of each env's step as int64 fixed point, summed per
block in shared memory, with one grid barrier per step; the TPU kernel's
combined ``[L·R, 128]`` MXU mask scatter is not carried over.
"""

from __future__ import annotations

from .fused_qlearning import make_rooms_trainer

__all__ = ["make_fused_qlambda_trainer_rooms"]


def make_fused_qlambda_trainer_rooms(env, num_envs: int, num_steps: int,
                                     gamma: float = 0.99,
                                     lam: float = 0.9,
                                     trace_len: int = 8,
                                     average_duplicates: bool = False,
                                     watkins_cut: bool = True,
                                     rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, agent, q_banks, *tape) -> (agent',
    q_banks', reward_sums)``: the contract of
    :func:`~gym_po_tpu_torch.ops.fused_qlearning.make_fused_q_trainer_rooms`.

    ``average_duplicates`` divides each entry's summed update by its count
    across all ``L·B`` trace terms of the step; the default sums, the
    textbook accumulating trace within each env.  ``run.trace_len`` is the
    trimmed ``L``.
    """
    return make_rooms_trainer(env, num_envs, num_steps, gamma,
                              average_duplicates, lam, trace_len, watkins_cut,
                              rng_tape, "fused_qlambda_rooms", "Q(λ) trainer")
