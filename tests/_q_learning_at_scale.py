"""The step_vec ``q_learning`` of both packages at ``tests/test_qlearning.py``'s
schedule, at that test's batch and at a larger one, on the CPU.

    JAX_PLATFORMS=cpu python tests/_q_learning_at_scale.py [B ...]

For each batch size (default 512 and 4096) and each of two seeds it trains
with the test's schedule (eps 0.3 and lr 0.1 for 40 updates of 128 steps,
then eps 0.05 and lr 0.05 for 40 more) through ``gym_po_tpu``'s
``q_learning`` and through ``gym_po_tpu_torch``'s, and prints the test's
measures of the greedy policy over 256 envs x 200 steps: dropoffs per env
(the test asks > 2.0) and the share of bad moves (< 0.05).  The two
packages draw from different generators, so a run is compared with its
counterpart only in outcome.  Not a test: it runs for minutes.
"""

from __future__ import annotations

import sys
import time

import jax
import numpy as np
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import qlearning as jq
from gym_po_tpu.vector import rollout as jrollout
from gym_po_tpu_torch.agents import qlearning as tq
from gym_po_tpu_torch.vector import rollout as trollout

SCHEDULE = [(0.3, 0.1, 40), (0.05, 0.05, 40)]  # (eps, lr, updates of 128)


def measures(r: np.ndarray) -> tuple:
    return (r > 0.5).sum() / r.shape[1], (r < -0.4).mean()


def run_jax(B: int, seed: int) -> tuple:
    env = gpt.make("Taxi-v4")
    key = jax.random.PRNGKey(seed)
    q = None
    for eps, lr, n in SCHEDULE:
        cfg = jq.QConfig(num_envs=B, learning_rate=lr, epsilon=eps,
                         steps_per_update=128)
        q, hist = jq.q_learning(env, cfg, key, n, q_init=q)
    traj, _ = jax.jit(lambda k: jrollout(env, k, jq.greedy_policy(q), 256,
                                         200))(jax.random.PRNGKey(9))
    return measures(np.asarray(traj.reward)) + (hist[-1][0],)


def run_torch(B: int, seed: int) -> tuple:
    env = gpt_torch.make("Taxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(seed)
    q = None
    for eps, lr, n in SCHEDULE:
        cfg = tq.QConfig(num_envs=B, learning_rate=lr, epsilon=eps,
                         steps_per_update=128)
        q, hist = tq.q_learning(env, cfg, gen, n, q_init=q)
    traj, _ = trollout(env, torch.Generator().manual_seed(9),
                       tq.greedy_policy(q), 256, 200)
    return measures(traj.reward.numpy()) + (hist[-1][0],)


def main(sizes) -> None:
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    for B in sizes:
        for seed in (0, 1):
            for name, fn in (("gym_po_tpu", run_jax),
                             ("gym_po_tpu_torch", run_torch)):
                t0 = time.perf_counter()
                drops, bad, last = fn(B, seed)
                print(f"{name} q_learning B={B} seed={seed}: dropoffs/env "
                      f"{drops:.4f} (> 2.0), bad moves {bad:.6f} (< 0.05), "
                      f"last mean reward/step {last:.6f}, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main([int(b) for b in sys.argv[1:]] or [512, 4096])
