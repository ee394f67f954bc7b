"""One-step Q against Watkins Q(λ) on ROOMS layout '16', both packages, on
the CPU, at the schedule of the JAX package's hardware test
(``tests/test_fused_qlambda.py:260-300``: B = 1,024, two calls of K = 512 at
lr = epsilon = 0.3, duplicates averaged, γ = 0.99, λ = 0.9, L = 16).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/_rooms_one_step_vs_qlambda.py [jax-qlambda]

Each trainer is driven by a uniform random tape (``rng_tape=True``), the
same tape for both packages: the JAX Pallas kernel interpreted on the CPU
and the port's plain twin.  It prints each one's greedy goals per env over
1,024 envs x 512 steps (JAX's ``vector.rollout``, the test's measure) and
whether the two packages' final tables agree to rtol 1e-5: over 1,024
steps they need not, since a last-ulp difference between the two ways of
summing an update can flip a greedy tie, after which the runs part.  The
JAX Q(λ) kernel runs only when ``jax-qlambda`` is named: interpreted, it
takes minutes.  Run from the repository root with it on ``PYTHONPATH``.
Not a test.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import greedy_policy
from gym_po_tpu.ops.fused_qlambda import make_fused_qlambda_trainer_rooms as jql
from gym_po_tpu.ops.fused_qlearning import banks_to_q
from gym_po_tpu.ops.fused_qlearning import make_fused_q_trainer_rooms as jq1
from gym_po_tpu.vector import rollout
from gym_po_tpu_torch.ops import (
    make_fused_q_trainer_rooms,
    make_fused_qlambda_trainer_rooms,
)

from _tape import make_tape

B, K, W = 1024, 512, 128


def goals(env, q) -> float:
    traj, _ = jax.jit(lambda k: rollout(env, k, greedy_policy(jnp.asarray(q)),
                                        1024, 512))(jax.random.PRNGKey(9))
    return float((np.asarray(traj.reward) > 0.5).sum() / 1024)


def main(argv) -> int:
    je = gpt.make("Rooms-v0", layout="16")
    te = gpt_torch.make("Rooms-v0", layout="16", device="cpu")
    n_obs, A = int(je.observation_space.n), int(je.num_actions)
    GW = je.grid_np.shape[1]
    _, st = je.reset_vec(jax.random.PRNGKey(0), B)
    a0 = np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1],
                    np.int32).reshape(-1, W)
    trainers = [("one-step Q", jq1(je, B, K, 0.99, average_duplicates=True,
                                   interpret=True, rng_tape=True),
                 make_fused_q_trainer_rooms(te, B, K, 0.99,
                                            average_duplicates=True,
                                            rng_tape=True))]
    trainers.append(("Watkins Q(lambda=0.9, L=16)",
                     jql(je, B, K, 0.99, lam=0.9, trace_len=16,
                         average_duplicates=True, interpret=True, rng_tape=True)
                     if "jax-qlambda" in argv else None,
                     make_fused_qlambda_trainer_rooms(te, B, K, 0.99, lam=0.9,
                                                      trace_len=16,
                                                      average_duplicates=True,
                                                      rng_tape=True)))
    for name, jrun, trun in trainers:
        rng = np.random.default_rng(0)
        tapes = [make_tape(rng, trun.n_sites, K, B // W) for _ in range(2)]
        t0 = time.perf_counter()
        a, q = torch.tensor(a0), torch.zeros(32, W)
        for i, tape in enumerate(tapes):
            a, q, _ = trun(i + 1, 0.3, 0.3, a, q, torch.as_tensor(tape))
        tq = banks_to_q(q.numpy(), 512, na=A)[:n_obs]
        line = (f"{name}: port twin {goals(je, tq):.4f} goals/env "
                f"({time.perf_counter() - t0:.1f} s)")
        if jrun is not None:
            t0 = time.perf_counter()
            a, q = jnp.asarray(a0), jnp.zeros((32, W), jnp.float32)
            for i, tape in enumerate(tapes):
                a, q, _ = jrun(jnp.asarray([i + 1], jnp.int32), 0.3, 0.3, a, q,
                               jnp.asarray(tape))
            jqt = banks_to_q(np.asarray(q), 512, na=A)[:n_obs]
            line += (f"; JAX kernel interpreted {goals(je, jqt):.4f} goals/env "
                     f"({time.perf_counter() - t0:.1f} s); tables agree "
                     f"{np.allclose(tq, jqt, rtol=1e-5, atol=1e-6)}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
