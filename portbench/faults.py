"""Faults planted under the harness, to show that a cell's check catches
them: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest), and an answer altered where it is
produced.  (No cell spans chips, so none has an exchange to leave out.)
For PPO also: the step of the last block of ``BLOCK`` envs left out (on
the ant its physics alone), and the actions drawn greedily or at a
temperature of ``HOT``.

``plant(kind, fault)`` is a context manager that patches the program for
a cell of traffic kind ``kind`` and undoes it on exit.  The harness's
tests plant them at small sizes on the CPU, and ``control.py --fault``
at the cell's own size on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Tuple

FAULTS = ("unchanged", "half", "altered", "block", "greedy", "hot")
#: the faults a traffic kind can have
FAULTS_OF = {"rollout": FAULTS[:3], "qlearn": FAULTS[:3], "ppo": FAULTS}
#: envs in the block that the ``block`` fault leaves out
BLOCK = 32
#: the temperature of the ``hot`` fault's draws
HOT = 1.2


def _wrap_maker(module, attr: str, breaker: Callable):
    real = getattr(module, attr)

    def make(*a, **k):
        run = real(*a, **k)

        def broken(*args):
            return breaker(args, run(*args))
        return broken
    return make


# rollout: run(seed, s) -> (s', reward sums)
def _rollout(fault: str):
    def unchanged(args, out):
        return (args[1].clone(), *out[1:])

    def half(args, out):
        s = out[0].clone()
        s[s.shape[0] // 2:] = args[1][s.shape[0] // 2:]
        return (s, *out[1:])

    def altered(args, out):
        s = out[0].clone()
        s[0, 0] = (s[0, 0] + 1) % 2000
        return (s, *out[1:])

    from gym_po_tpu_torch.ops import fused_taxi

    breaker = {"unchanged": unchanged, "half": half, "altered": altered}[fault]
    return fused_taxi, "make_fused_taxi_rollout", _wrap_maker(
        fused_taxi, "make_fused_taxi_rollout", breaker)


# qlearn: run(seed, lr, eps, s, q) -> (s', q', reward sums)
def _qlearn(fault: str):
    def unchanged(args, out):
        return (args[3].clone(), args[4].clone(), out[2])

    def half(args, out):
        s = out[0].clone()
        s[s.shape[0] // 2:] = args[3][s.shape[0] // 2:]
        return (s, out[1], out[2])

    def altered(args, out):
        q = out[1].clone()
        q[0, 5] += 1e-3
        return (out[0], q, out[2])

    from gym_po_tpu_torch.ops import fused_qlearning

    breaker = {"unchanged": unchanged, "half": half, "altered": altered}[fault]
    return fused_qlearning, "make_fused_q_trainer", _wrap_maker(
        fused_qlearning, "make_fused_q_trainer", breaker)


def _ppo(fault: str):
    import gym_po_tpu_torch
    import torch
    from gym_po_tpu_torch.agents import ppo

    if fault == "unchanged":  # the optimizer step leaves the weights as they are
        return ppo, "adam_step", lambda *a, **k: None
    if fault == "half":  # each minibatch's loss over its first half of rows
        real_loss = ppo._loss_fn

        def half(model, batch, config):
            n = batch.obs.shape[0] // 2
            return real_loss(model, ppo.Batch(*(x[:n] for x in batch)), config)
        return ppo, "_loss_fn", half
    if fault in ("greedy", "hot"):
        return ppo, "sample_action", _sampler(ppo, fault)
    real_make = gym_po_tpu_torch.make

    def make(*a, **k):
        env = real_make(*a, **k)
        if fault == "block" and hasattr(env, "physics"):
            real_physics = env.physics

            def physics(qpos, qvel, warm, action):  # the tail block's left out
                out = [x.clone() for x in real_physics(qpos, qvel, warm, action)]
                for x, x0 in zip(out, (qpos, qvel, warm)):
                    x[-BLOCK:] = x0[-BLOCK:]
                return tuple(out)
            env.physics = physics
            return env
        real_step = env.step_vec

        def step_vec(generator, state, action):
            obs, st, rew, done, trunc, info = real_step(generator, state, action)
            if fault == "block":  # the tail block's state as it was
                st = dataclasses.replace(st, **{
                    f.name: torch.cat([getattr(st, f.name)[:-BLOCK],
                                       getattr(state, f.name)[-BLOCK:]])
                    for f in dataclasses.fields(st)})
                return env.observe_vec(st), st, rew, done, trunc, info
            rew = rew.clone()  # the reward of env 0 altered where it is made
            rew[0] += 1.0
            return obs, st, rew, done, trunc, info
        env.step_vec = step_vec
        return env
    return gym_po_tpu_torch, "make", make


def _sampler(ppo, fault: str):
    """The policy's draws taken greedily (the argmax, the mean), or at a
    temperature of ``HOT``; log-probabilities under the policy as it is."""
    import torch

    real = ppo.sample_action

    def sample_action(pi, generator):
        if fault == "hot":
            hot = dict(pi, **({"logits": pi["logits"] / HOT} if pi["kind"] == "categorical"
                              else {"log_std": pi["log_std"] + math.log(HOT)}))
            action, _ = real(hot, generator)
        elif pi["kind"] == "categorical":
            action = torch.argmax(pi["logits"], dim=-1)
        else:
            action = pi["mean"].clone()
        return action, ppo.log_prob(pi, action)
    return sample_action


PLANTERS: Dict[str, Callable[[str], Tuple]] = {
    "rollout": _rollout, "qlearn": _qlearn, "ppo": _ppo}


@contextlib.contextmanager
def plant(kind: str, fault: str):
    if fault not in FAULTS_OF[kind]:
        raise ValueError(f"no fault {fault!r} for traffic kind {kind!r}")
    module, attr, value = PLANTERS[kind](fault)
    real = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, real)
