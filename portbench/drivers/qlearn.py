"""Traffic kind ``qlearn``: the fused one-step Q trainer, one call of
``num_envs`` envs for ``num_steps`` train-steps a unit (epsilon-greedy
acting, the env step, the update of the shared table every step), each
call on a fresh Philox seed, the states and the table chained from call
to call.

Set-up makes the env from the configuration, the trainer from the
traffic, the first states on the device from the seed and a zero table,
and warms the call up twice.  The check runs the plain reference
(``reference/taxi.py``) from the input states and table of the window's
first call, its last, and one drawn from the seed, and compares the next
states (envs that differ), the tables and the reward sums (the largest
gaps), all exact.
"""

from __future__ import annotations

import importlib

import torch

from portbench import core


class Cell(core.KernelCell):
    def __init__(self, spec, seed: int, device: torch.device):
        import gym_po_tpu_torch as gp
        from gym_po_tpu_torch.ops.fused_qlearning import make_fused_q_trainer

        cfg, tr = spec["config"], spec["traffic"]
        self.ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
        self.ref_env = self.ref.Taxi(cfg, device)
        self.env = gp.make(cfg["env_id"], device=device, **cfg["env_kwargs"])
        self.B, self.K = int(tr["num_envs"]), int(tr["num_steps"])
        self.hyper = (float(tr["lr"]), float(tr["epsilon"]), float(tr["gamma"]),
                      bool(tr["average_duplicates"]))
        self.run = make_fused_q_trainer(self.env, self.B, self.K,
                                        gamma=self.hyper[2],
                                        average_duplicates=self.hyper[3])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.s = self.ref_env.start_states(self.B, gen).reshape(self.B // 128, 128)
        _, nq = self.ref.q_geometry(self.ref_env.n_obs)
        self.q = torch.zeros(nq // 128, 128, device=device)
        self.seed = seed
        self.unit_work = self.B * self.K
        self.limits = spec["own"]["limits"]
        self.i = 0
        self.warm_up(seed, device)

    def enqueue(self) -> int:
        seed_i = core.sub_seed(self.seed, self.i)
        lr, eps, _, _ = self.hyper
        s_in, q_in = self.s, self.q
        self.s, self.q, racc = self.run(seed_i, lr, eps, s_in, q_in)
        self.i += 1
        self.offer((seed_i, s_in, q_in, self.s, self.q, racc))
        return self.unit_work

    def release(self) -> None:
        self.run = self.env = self.s = self.q = None

    def reference(self, seed_i, s_in, q_in, q_dtype=torch.float32):
        lr, eps, gamma, average = self.hyper
        return self.ref.q_train(self.ref_env, seed_i, s_in, q_in, self.K, lr, eps,
                                gamma, average, q_dtype)

    def check(self, control: bool = False):
        mismatch, q_gap, r_gap = 0, 0.0, 0.0
        self.bad_units = 0
        for seed_i, s_in, q_in, s_out, q_out, racc in self.sampler.kept():
            if control:  # the reference in the program's place, Q in bfloat16
                s_out, q_out, racc = self.reference(seed_i, s_in, q_in, torch.bfloat16)
            ref_s, ref_q, ref_r = self.reference(seed_i, s_in, q_in)
            m = int((s_out.reshape(-1) != ref_s).sum())
            gq = core.max_gap(q_out, ref_q)
            gr = core.max_gap(racc, ref_r)
            mismatch += m
            q_gap, r_gap = max(q_gap, gq), max(r_gap, gr)
            self.bad_units += int(m > self.limits["state_mismatch"]
                                  or gq > self.limits["q_gap"]
                                  or gr > self.limits["reward_gap"])
        return [{"name": "state_mismatch", "value": mismatch,
                 "limit": self.limits["state_mismatch"]},
                {"name": "q_gap", "value": q_gap, "limit": self.limits["q_gap"]},
                {"name": "reward_gap", "value": r_gap,
                 "limit": self.limits["reward_gap"]}]
