"""Entry points, port of ``__graft_entry__``.

``entry()``: the acting step on the flagship model, an ``ActorCritic``
(hidden 64, 64, f32) over ``ExtendedHansenTaxi-v4`` observations, then
``sample_action``, then ``env.step_vec``: one step of B envs.  Example::

    forward, (model, gen, obs, state) = entry(device="cuda", num_envs=4096)
    nobs, nstate, rew, value, logp = forward(model, gen, obs, state)

``dryrun_multichip(n)``: both data-parallel learner families, one step each
on tiny shapes, over n ranks, and the same sharded PPO step on the
articulated ant.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .agents.networks import make_actor_critic, sample_action
from .registry import make

__all__ = ["entry", "dryrun_multichip", "ENV_ID"]

ENV_ID = "ExtendedHansenTaxi-v4"
# seconds for ``dryrun_multichip``'s ranks to start, run and exit
DRYRUN_TIMEOUT = 600.0


def entry(device="cuda", num_envs: int = 256, hidden: Sequence[int] = (64, 64),
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


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> list:
    """Run both data-parallel learner families over ``n_devices`` ranks, one
    step each on tiny shapes, and check them.

    Starts ``n_devices`` local processes (:class:`~.parallel.Ranks`); each
    runs ``fused_q_learning`` on ``Taxi-v4`` with ``num_envs = 1024·n``,
    ``chunk_steps = 8`` and the mesh (the fused Q trainer kernel chunk by
    chunk, the tables averaged after each; the kernel takes multiples of
    1,024 envs, as the JAX package's does, whose dryrun runs 128·n through
    its XLA stand-in), then one sharded PPO update on
    ``ExtendedHansenTaxi-v4`` (``num_envs = 4·n``, ``rollout_steps = 8``,
    two epochs of two minibatches, hidden (32, 32)), then one on
    ``AntTagPhysics-v0`` (frame_skip 1, one Newton iteration, Euler,
    ``num_envs = 2·n``, ``rollout_steps = 4``, one epoch of two
    minibatches, hidden (16, 16), the Gaussian head), as the JAX dryrun's
    third step.  Raises unless every result is finite and every rank
    reports the same losses; returns each rank's ``{"loss", "metrics",
    "ant_loss", "ant_metrics", "launches"}``.

    ``device`` is ``"cuda"`` (rank r on card r modulo the card count) or
    ``"cpu"``.  The backend defaults to NCCL on CUDA and gloo on the CPU;
    NCCL with more ranks than cards is refused (two ranks on one card go
    through ``backend="gloo"``).
    """
    from .parallel import Ranks

    n, dev_type = int(n_devices), torch.device(device).type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if backend == "nccl" and (dev_type != "cuda" or n > torch.cuda.device_count()):
        raise ValueError(f"NCCL takes one CUDA device per rank: {n} ranks on "
                         f"{torch.cuda.device_count()} card(s); pass "
                         "backend='gloo' to share one")
    if dev_type == "cuda":
        from .ops._build import load_library

        load_library("fused_qlearning")  # build once, before the ranks load it
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(n)]
    else:
        devices = [device] * n
    with Ranks(n, backend, DRYRUN_TIMEOUT) as ranks:
        results = ranks.run(_dryrun_rank, devices)
    for key in ("loss", "ant_loss"):
        losses = [r[key] for r in results]
        if not all(math.isfinite(x) for x in losses) or len(set(losses)) != 1:
            raise RuntimeError(f"the ranks' PPO {key}es differ or are not "
                               f"finite: {losses}")
    return results


def _dryrun_rank(devices) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    from .agents import (
        PPOConfig,
        fused_q_learning,
        init_train_state,
        make_train_step,
        shard_train_state,
    )
    from .ops._build import LAUNCHES
    from .parallel import make_mesh

    mesh = make_mesh(devices=devices)
    n, dev = mesh.size, mesh.device
    q, hist = fused_q_learning(make("Taxi-v4", device=dev), seed=0,
                               schedule=[(0.2, 0.3, 8)], num_envs=1024 * n,
                               chunk_steps=8, mesh=mesh)
    if not (np.isfinite(q).all() and np.isfinite(hist).all()):
        raise RuntimeError("fused_q_learning over the mesh: non-finite table")
    env = make(ENV_ID, device=dev)
    cfg = PPOConfig(num_envs=4 * n, rollout_steps=8, epochs=2, minibatches=2,
                    hidden=(32, 32))
    model, ts = init_train_state(env, cfg,
                                 torch.Generator(device=dev).manual_seed(0))
    ts = shard_train_state(ts, mesh)
    ts, metrics = make_train_step(env, model, cfg, mesh)(ts)
    metrics = {k: float(v) for k, v in metrics.items()}
    # the articulated ant through the same sharded step (Gaussian head)
    ant = make("AntTagPhysics-v0", frame_skip=1, solver_iters=1,
               integrator="euler", pipeline="array", device=dev)
    acfg = PPOConfig(num_envs=2 * n, rollout_steps=4, epochs=1, minibatches=2,
                     hidden=(16, 16))
    amodel, ats = init_train_state(ant, acfg,
                                   torch.Generator(device=dev).manual_seed(1))
    ats = shard_train_state(ats, mesh)
    ats, ametrics = make_train_step(ant, amodel, acfg, mesh)(ats)
    ametrics = {k: float(v) for k, v in ametrics.items()}
    return {"loss": metrics["loss"], "metrics": metrics,
            "ant_loss": ametrics["loss"], "ant_metrics": ametrics,
            "launches": dict(LAUNCHES)}
