"""Traffic kind ``rollout``: the fused Taxi rollout under uniform random
actions, one call of ``num_envs`` envs for ``num_steps`` steps a unit, each
call on a fresh Philox seed and the states chained from call to call.

Set-up makes the env from the configuration, the rollout from the
traffic, the first states on the device from the seed, and warms the call
up twice.  The check runs the plain reference (``reference/taxi.py``) over
the whole batch of the window's first call, its last, and one drawn from
the seed, from each call's own input states, and compares the next states
(envs that differ) and the reward sums (the largest gap), both exact.
"""

from __future__ import annotations

import importlib

import torch

from portbench import core


class Cell(core.KernelCell):
    def __init__(self, spec, seed: int, device: torch.device):
        import gym_po_tpu_torch as gp
        from gym_po_tpu_torch.ops.fused_taxi import make_fused_taxi_rollout

        cfg, tr = spec["config"], spec["traffic"]
        self.ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
        self.ref_env = self.ref.Taxi(cfg, device)
        self.env = gp.make(cfg["env_id"], device=device, **cfg["env_kwargs"])
        self.B, self.K = int(tr["num_envs"]), int(tr["num_steps"])
        self.run = make_fused_taxi_rollout(self.env, self.B, self.K)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.s = self.ref_env.start_states(self.B, gen).reshape(self.B // 128, 128)
        self.seed = seed
        self.unit_work = self.B * self.K
        self.limits = spec["own"]["limits"]
        self.i = 0
        self.warm_up(seed, device)

    def enqueue(self) -> int:
        seed_i = core.sub_seed(self.seed, self.i)
        s_in = self.s
        s_out, racc = self.run(seed_i, s_in)
        self.s = s_out
        self.i += 1
        self.offer((seed_i, s_in, s_out, racc))
        return self.unit_work

    def release(self) -> None:
        self.run = self.env = self.s = None

    def outputs(self, seed_i, s_in, s_out, racc, control: bool):
        """The outputs judged: the program's, or with ``control`` the
        reference's own at the precision below the configuration's."""
        if not control:
            return s_out.reshape(-1), racc.reshape(-1)
        return self.ref.rollout(self.ref_env, seed_i, s_in, self.K, torch.bfloat16)

    def check(self, control: bool = False):
        mismatch, gap = 0, 0.0
        self.bad_units = 0
        for seed_i, s_in, s_out, racc in self.sampler.kept():
            got_s, got_r = self.outputs(seed_i, s_in, s_out, racc, control)
            ref_s, ref_r = self.ref.rollout(self.ref_env, seed_i, s_in, self.K)
            m = int((got_s != ref_s).sum())
            g = core.max_gap(got_r, ref_r)
            mismatch += m
            gap = max(gap, g)
            self.bad_units += int(m > 0 or g > self.limits["reward_gap"])
        return [{"name": "state_mismatch", "value": mismatch,
                 "limit": self.limits["state_mismatch"]},
                {"name": "reward_gap", "value": gap,
                 "limit": self.limits["reward_gap"]}]
