"""The acting step on the flagship model, port of ``__graft_entry__.entry``.

An ``ActorCritic`` (hidden 64, 64, f32) over ``ExtendedHansenTaxi-v4``
observations, then ``sample_action``, then ``env.step_vec``: one step of B
envs.  Example::

    forward, (model, gen, obs, state) = entry(device="cuda", num_envs=4096)
    nobs, nstate, rew, value, logp = forward(model, gen, obs, state)
"""

from __future__ import annotations

from typing import Sequence

import torch

from .agents.networks import make_actor_critic, sample_action
from .registry import make

__all__ = ["entry", "ENV_ID"]

ENV_ID = "ExtendedHansenTaxi-v4"


def entry(device="cpu", num_envs: int = 256, hidden: Sequence[int] = (64, 64),
          seed: int = 0):
    """Return ``(forward, (model, generator, obs, state))``.

    The model's weights are random, made from ``seed``; so are the first
    observations.  ``forward(model, gen, obs, state)`` runs one acting step
    and returns ``(nobs, nstate, rew, value, logp)``.
    """
    env = make(ENV_ID, device=device)
    # the init draws from the global generator: seed it, then restore it
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = make_actor_critic(env, hidden).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    obs, state = env.reset_vec(gen, num_envs)

    @torch.no_grad()
    def forward(model, gen, obs, state):
        """One acting step: policy forward, sample, env step, B envs."""
        pi, value = model(obs)
        action, logp = sample_action(pi, gen)
        nobs, nstate, rew, done, trunc, _ = env.step_vec(gen, state, action)
        return nobs, nstate, rew, value, logp

    return forward, (model, gen, obs, state)
