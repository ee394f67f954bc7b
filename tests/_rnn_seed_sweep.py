"""The recurrent learning checks of the JAX tests, per seed, in either
package, on the CPU.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 PYTHONPATH=. \\
        python tests/_rnn_seed_sweep.py {jax|torch} {hh|carflag|tag} [SEED,...]

``hh`` is tests/test_memory_learning.py's GRU run on the HeavenHell
surrogate (speed 0.75, time limit 150, B = 128, T = 32, hidden 32, lr
1e-3, entropy 0.01, 'none', 50 updates): it prints the last 10 updates'
heaven and hell rates p and n, the heaven share, the peaks, and whether
the test's criterion (p > 0.02, share > 0.9) held.  ``carflag`` and ``tag``
are tests/test_ppo_rnn.py's smoke runs (DiscreteCarFlag 25 updates,
TagContinuous 30; B = 64, T = 32, hidden 32): they print the mean reward
of the first and last 5 updates and whether the test's criterion (last >
first - 1e-4, and > first + 0.003) held.  Seeds default to 0-7.  The two
packages draw from different generators, so a seed's run is compared with
its counterpart only in outcome.  The port runs on one CPU thread: the
summation order of a multi-threaded matmul, and with it where a run ends,
depends on the thread count.  One JSON line per seed.  Not a test: a
sweep runs for minutes.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

RUNS = {
    "hh": ("HeavenHellContinuous-v0", dict(agent_speed=0.75, time_limit=150),
           dict(num_envs=128, rollout_steps=32, epochs=4, minibatches=4,
                learning_rate=1e-3, entropy_coef=0.01, shuffle="none"), 50),
    "carflag": ("DiscreteCarFlag-v0", dict(num_actions=3, time_limit=60),
                dict(num_envs=64, rollout_steps=32, epochs=4, minibatches=4,
                     learning_rate=1e-3, entropy_coef=0.003), 25),
    "tag": ("TagContinuous-v0", dict(time_limit=100, agent_speed=0.75),
            dict(num_envs=64, rollout_steps=32, epochs=4, minibatches=4,
                 learning_rate=1e-3, entropy_coef=0.003), 30),
}
SMOKE_MARGIN = {"carflag": -1e-4, "tag": 0.003}


def train_step(package: str, env_id: str, kw: dict, cfg_kw: dict, seed: int):
    """The package's recurrent train step and its first state."""
    if package == "jax":
        import jax

        import gym_po_tpu as gpt
        from gym_po_tpu.agents import PPOConfig, init_rnn_state, make_rnn_train_step

        env = gpt.make(env_id, **kw)
        net, ts = init_rnn_state(env, PPOConfig(**cfg_kw),
                                 jax.random.PRNGKey(seed), hidden=32)
        return make_rnn_train_step(env, net, PPOConfig(**cfg_kw)), ts
    import torch

    torch.set_num_threads(1)
    import gym_po_tpu_torch as gpt_torch
    from gym_po_tpu_torch.agents import PPOConfig, init_rnn_state, make_rnn_train_step

    env = gpt_torch.make(env_id, device="cpu", **kw)
    model, ts = init_rnn_state(env, PPOConfig(**cfg_kw),
                               torch.Generator().manual_seed(seed), hidden=32)
    return make_rnn_train_step(env, model, PPOConfig(**cfg_kw)), ts


def main(argv) -> None:
    package, run = argv[1], argv[2]
    seeds = [int(s) for s in argv[3].split(",")] if len(argv) > 3 else range(8)
    env_id, kw, cfg_kw, updates = RUNS[run]
    for seed in seeds:
        t0 = time.perf_counter()
        step, ts = train_step(package, env_id, kw, cfg_kw, seed)
        rows = []
        for _ in range(updates):
            ts, m = step(ts)
            rows.append([float(m[k]) for k in ("mean_reward", "pos_reward_rate",
                                               "neg_reward_rate")])
        r = np.asarray(rows)
        out = dict(package=package, run=run, seed=seed)
        if run == "hh":
            p, n = r[-10:, 1].mean(), r[-10:, 2].mean()
            share = p / max(p + n, 1e-12)
            out.update(p=p, n=n, share=share, peak_p=r[:, 1].max(),
                       peak_n=r[:, 2].max(), held=bool(p > 0.02 and share > 0.9))
        else:
            first, last = r[:5, 0].mean(), r[-5:, 0].mean()
            out.update(first5=first, last5=last,
                       held=bool(last > first + SMOKE_MARGIN[run]))
        out["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({k: (float(v) if isinstance(v, np.floating) else v)
                          for k, v in out.items()}), flush=True)


if __name__ == "__main__":
    main(sys.argv)
