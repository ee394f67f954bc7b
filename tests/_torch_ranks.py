"""Rank targets of the port's multi-process tests (not a test module).

Each function runs on every rank of a :class:`gym_po_tpu_torch.parallel.Ranks`
group: it builds the rank's mesh from ``devices`` and returns picklable
results.  The module imports torch, numpy and the port only, so the spawned
ranks never import jax; the tests pass their inputs in as numpy arrays or
tensors, one entry per rank where the ranks' inputs differ.
"""

import numpy as np
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.agents import ppo as tppo
from gym_po_tpu_torch.agents import ppo_rnn as trnn
from gym_po_tpu_torch.ops import make_fused_q_trainer
from gym_po_tpu_torch.parallel import (
    make_mesh,
    shard_batch,
    shard_fused_trainer,
    sharded_rollout,
)


def mesh_facts(devices):
    mesh = make_mesh(devices=devices)
    return mesh.shape, mesh.rank, mesh.size, str(mesh.device)


def rollout_shard(devices, env_id, seed, num_envs, num_steps):
    mesh = make_mesh(devices=devices)
    env = gpt_torch.make(env_id, device=mesh.device)
    traj, (obs, _) = sharded_rollout(env, mesh, seed, None, num_envs, num_steps)
    return traj.obs.numpy(), traj.reward.numpy(), obs.numpy()


def batch_rows(devices, tree):
    return shard_batch(make_mesh(devices=devices), tree)


def _fake_chunk(seed, lr, s, q):
    # per-shard work: the state advances, the "table" absorbs the seed
    return s + 1, q + lr * float(seed), s * 0


def dummy_chunk(devices, seeds, lr, s_global, q0):
    mesh = make_mesh(devices=devices)
    run = shard_fused_trainer(_fake_chunk, mesh, sharded_args=(1,),
                              averaged_outs=(1,), num_outs=3)
    return run(seeds, lr, shard_batch(mesh, s_global), q0)


def taxi_q_on_tapes(devices, env_id, time_limit, B, K, gamma, seeds, lr, eps,
                    s_global, qb0, tapes):
    """Chunks of the Taxi Q twin over the mesh, each rank on its rows and
    its own tape (``tapes[chunk][rank]``); returns each chunk's outputs."""
    mesh = make_mesh(devices=devices)
    env = gpt_torch.make(env_id, time_limit=time_limit, device=mesh.device)
    run = make_fused_q_trainer(env, B // mesh.size, K, gamma, rng_tape=True,
                               average_duplicates=True)
    # args after the seed: (lr, eps, s, q, tape); outs: (s, q, rew)
    run = shard_fused_trainer(run, mesh, sharded_args=(2, 4), averaged_outs=(1,),
                              num_outs=3)
    s, q, outs = shard_batch(mesh, s_global), torch.as_tensor(qb0), []
    for chunk_seeds, tape in zip(seeds, tapes):
        s, q, rew = run(chunk_seeds, lr, eps, s, q,
                        torch.as_tensor(tape[mesh.rank]))
        outs.append((s.clone(), q.clone(), rew))
    return outs


def _model(env, hidden, flat_params):
    model = tnet.make_actor_critic(env, hidden)
    flat = tnet.flatten_parameters(model)
    with torch.no_grad():
        flat.copy_(flat_params)
    return model, flat


def ppo_learn(devices, env_id, env_kw, cfg_fields, hidden, flat_params, opt,
              batches, orders, rewards):
    """The learn half over the mesh from the rank's batch and row orders,
    then the update's metrics averaged over the ranks."""
    mesh = make_mesh(devices=devices)
    r = mesh.rank
    env = gpt_torch.make(env_id, device=mesh.device, **env_kw)
    model, flat = _model(env, hidden, flat_params)
    cfg = tppo.PPOConfig(**cfg_fields)
    m = tppo.learn(model, flat, opt, cfg, batches[r], orders[r], mesh)
    m = tppo.mean_metrics({**m, **tppo._reward_metrics(rewards[r])}, mesh)
    return flat, {k: float(v) for k, v in m.items()}, int(opt.count)


def rnn_learn(devices, env_id, env_kw, cfg_fields, hidden, flat_params, opt,
              seqs, orders, rewards):
    mesh = make_mesh(devices=devices)
    r = mesh.rank
    env = gpt_torch.make(env_id, device=mesh.device, **env_kw)
    model = trnn.RecurrentActorCritic(env.observation_space, env.action_space,
                                      hidden)
    flat = tnet.flatten_parameters(model, trnn.rnn_parameter_list(model))
    with torch.no_grad():
        flat.copy_(flat_params)
    cfg = tppo.PPOConfig(**cfg_fields)
    m = trnn.learn_rnn(model, flat, opt, cfg, seqs[r], orders[r], mesh)
    m = tppo.mean_metrics({**m, **tppo._reward_metrics(rewards[r])}, mesh)
    return flat, {k: float(v) for k, v in m.items()}, int(opt.count)


def train_steps(devices, env_id, env_kw, cfg_fields, recurrent, updates):
    """``updates`` data-parallel updates from one seed's global state;
    returns each update's metrics, the parameters and the rank's env rows."""
    mesh = make_mesh(devices=devices)
    env = gpt_torch.make(env_id, device=mesh.device, **env_kw)
    cfg = tppo.PPOConfig(**cfg_fields)
    gen = torch.Generator(device=mesh.device).manual_seed(11)
    if recurrent:
        model, ts = trnn.init_rnn_state(env, cfg, gen, hidden=16)
        ts = trnn.shard_rnn_state(ts, mesh)
        step = trnn.make_rnn_train_step(env, model, cfg, mesh)
    else:
        model, ts = tppo.init_train_state(env, cfg, gen)
        ts = tppo.shard_train_state(ts, mesh)
        step = tppo.make_train_step(env, model, cfg, mesh)
    rows = ts.env_obs.shape[0]
    history = []
    for _ in range(updates):
        ts, m = step(ts)
        history.append({k: float(v) for k, v in m.items()})
    return history, ts.params.clone(), rows, np.asarray(ts.env_obs)


def fused_trainer_run(devices, trainer, env_id, env_kw, kw):
    """``fused_q_learning`` or ``fused_actor_critic`` over the mesh."""
    from gym_po_tpu_torch.agents import fused_actor_critic, fused_q_learning

    mesh = make_mesh(devices=devices)
    env = gpt_torch.make(env_id, device=mesh.device, **env_kw)
    fn = fused_q_learning if trainer == "q" else fused_actor_critic
    return fn(env, mesh=mesh, **kw)


def fail_on_rank(devices, bad_rank):
    mesh = make_mesh(devices=devices)
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {mesh.rank} fails on purpose")
    mesh.all_mean_(torch.ones(3))  # the other waits in a collective
    return mesh.rank
