"""Batched tabular Q-learning, PyTorch port of :mod:`gym_po_tpu.agents.qlearning`.

Two learners over the same table:

* :func:`q_learning` steps B envs in lockstep through ``env.step_vec`` and
  applies ``Q[obs, a] += lr * td`` every step, duplicate ``(obs, a)`` pairs
  within a batch summing (the standard vectorized-Q approximation, exact as
  lr -> 0).  Lookups are native gathers and the update is ``index_add_``;
  the JAX package's one-hot matmuls are a device of the TPU's matrix unit.
  The TD target bootstraps from the state before the autoreset
  (``info["terminal_state"]``); ``done`` cuts the bootstrap, truncation
  does not.
* :func:`fused_q_learning` runs the whole trainer inside the hand-written
  CUDA kernel of :mod:`gym_po_tpu_torch.ops.fused_qlearning` (Taxi, ROOMS
  and MultistoryFourRooms; Q(λ) on ROOMS through
  :mod:`~gym_po_tpu_torch.ops.fused_qlambda`; CRooms through
  :mod:`~gym_po_tpu_torch.ops.fused_q_crooms`), chunk by chunk, over an
  lr/epsilon schedule.

:func:`fused_actor_critic` trains a tabular softmax actor-critic on ROOMS
inside the kernel of :mod:`gym_po_tpu_torch.ops.fused_ac` the same way.

All run on the env's device.  Given a ``mesh``
(:func:`~gym_po_tpu_torch.parallel.make_mesh`), both fused trainers run the
chunk-synchronous data-parallel scheme of
:func:`~gym_po_tpu_torch.parallel.shard_fused_trainer` across its ranks.
Not ported: ``chunk_trainer="xla"`` (``make_xla_q_chunk_trainer``), the JAX
package's stand-in for its kernel on a CPU mesh: the twins run there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import Discrete

__all__ = ["QConfig", "q_learning", "td_update", "greedy_policy",
           "fused_q_learning", "fused_actor_critic"]


class QConfig(NamedTuple):
    num_envs: int = 4096
    learning_rate: float = 0.1
    gamma: float = 0.99
    epsilon: float = 0.1  # epsilon-greedy exploration
    steps_per_update: int = 128  # steps per history entry


def q_learning(env, config: QConfig, generator: torch.Generator,
               num_updates: int = 100, q_init=None):
    """Train a Q-table; returns ``(Q [n_obs, n_act], history)``.

    ``history`` holds one ``(mean reward, mean done)`` per update of
    ``config.steps_per_update`` steps.  Every draw comes from ``generator``,
    which lies on the env's device; so does the returned table.
    """
    if not isinstance(env.observation_space, Discrete) or not isinstance(
        env.action_space, Discrete
    ):
        raise ValueError("tabular Q-learning needs Discrete obs and actions")
    n_obs = int(env.observation_space.n)
    n_act = int(env.action_space.n)
    dev = env.device
    if q_init is None:
        q = torch.zeros((n_obs, n_act), dtype=torch.float32, device=dev)
    else:
        q = torch.as_tensor(q_init, dtype=torch.float32).to(dev).clone()
    B = config.num_envs
    lr, gamma, eps = (torch.tensor(np.float32(x), device=dev) for x in (
        config.learning_rate, config.gamma, config.epsilon))
    obs, state = env.reset_vec(generator, B)
    hist = []
    for _ in range(num_updates):
        rsum = torch.zeros((), dtype=torch.float32, device=dev)
        dsum = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(config.steps_per_update):
            q_rows = q[obs.long()]
            greedy = q_rows.argmax(-1).to(torch.int32)
            explore = torch.rand(B, generator=generator, device=dev) < eps
            random_a = torch.randint(0, n_act, (B,), generator=generator,
                                     device=dev, dtype=torch.int32)
            action = torch.where(explore, random_a, greedy)
            nobs, state, rew, done, _, info = env.step_vec(generator, state,
                                                           action)
            # bootstrap from the observation before the autoreset
            td_update(q, obs, action, rew, env.observe(info["terminal_state"]),
                      done, lr, gamma)
            rsum = rsum + rew.mean()
            dsum = dsum + done.to(torch.float32).mean()
            obs = nobs
        hist.append(torch.stack([rsum, dsum]) / config.steps_per_update)
    return q, [tuple(h) for h in torch.stack(hist).tolist()] if hist else []


def td_update(q: torch.Tensor, obs, action, rew, next_obs, done, lr,
              gamma) -> torch.Tensor:
    """One batched Q-learning update of ``q [n_obs, n_act]``, in place:
    ``Q[obs, a] += lr * (rew + gamma * max Q[next_obs] * (1 - done) -
    Q[obs, a])``, every target read from the table before the update and
    duplicate ``(obs, a)`` pairs summing.  Returns ``q``."""
    n_act = q.shape[1]
    obs, action = obs.long(), action.long()
    next_v = q[next_obs.long()].max(-1).values
    target = rew + gamma * next_v * (1.0 - done.to(torch.float32))
    td = target - q[obs, action]
    q.view(-1).index_add_(0, obs * n_act + action, lr * td)
    return q


def greedy_policy(q):
    """``(generator, obs[B]) -> argmax actions`` (first maximum on ties);
    plugs into ``vector.rollout`` and ``ops.state_policy_table``."""
    q = torch.as_tensor(q)

    def policy(generator, obs):
        return q.to(obs.device)[obs.long()].argmax(-1).to(torch.int32)

    return policy


def _flat_agents(env, st) -> torch.Tensor:
    """The flat-cell agent tile ``[B // 128, 128]`` of a Rooms state."""
    a = st.agent_yx.to(torch.int32)
    return (a[:, 0] * env.grid_np.shape[1] + a[:, 1]).reshape(-1, 128).contiguous()


def _flat_agents_zyx(env, st) -> torch.Tensor:
    """The flat-cell agent tile ``[B // 128, 128]`` of a
    MultistoryFourRooms state."""
    a = st.agent_zyx.to(torch.int32)
    _, H, GW = env.grid_np.shape
    return (a[:, 0] * H * GW + a[:, 1] * GW + a[:, 2]).reshape(-1, 128).contiguous()


def _chunks(seed: int, schedule, chunk_steps: int, ndev: int):
    """``(chunk seeds [ndev], step sizes)`` per chunk: each schedule phase
    runs ``ceil(num_steps / chunk_steps)`` chunks, chunk ``i`` (from 1)
    seeded :func:`~gym_po_tpu_torch.parallel.chunk_seeds` ``(seed, i,
    ndev)`` (``seed + i`` on one device)."""
    from ..parallel import chunk_seeds

    i = 0
    for *sizes, steps in schedule:
        for _ in range(-(-int(steps) // chunk_steps)):
            i += 1
            yield chunk_seeds(seed, i, ndev), [float(x) for x in sizes]


def _mesh_of(env, mesh, num_envs: int):
    """The mesh a fused trainer runs on (one rank with no group when none is
    given), checked against the global batch."""
    from ..parallel import local_mesh

    mesh = local_mesh(env.device) if mesh is None else mesh
    if num_envs % mesh.size:
        raise ValueError(f"global num_envs={num_envs} not divisible by the "
                         f"mesh's {mesh.size} ranks")
    return mesh


def _history(history, chunk_steps: int, mesh):
    """Each chunk's mean reward per step, averaged over the ranks (one
    collective for the run), as floats."""
    if not history:
        return []
    return [h / chunk_steps for h in mesh.all_mean_(torch.stack(history)).tolist()]


def fused_q_learning(env, seed: int, schedule, num_envs: int = 8192,
                     gamma: float = 0.99, chunk_steps: int = 4096,
                     q_init=None, average_duplicates: bool = True,
                     expected_sarsa: bool = False, lam: float = 0.0,
                     trace_len: int = 8, watkins_cut: bool = True, mesh=None):
    """Tabular Q-learning inside the fused CUDA trainer kernel, on Taxi,
    ROOMS, MultistoryFourRooms or CRooms with a discrete action type (each
    with a fixed goal).

    ``schedule`` is ``[(lr, epsilon, num_steps), ...]``; each phase runs
    ``ceil(num_steps / chunk_steps)`` chunks of ``chunk_steps`` steps, and
    chunk ``i`` (from 1) draws with seed ``seed + i``.  Returns
    ``(q [n_obs, n_act] float32 numpy, history)`` with one mean reward per
    step for each chunk.  Options are those of
    :func:`~gym_po_tpu_torch.ops.fused_qlearning.make_fused_q_trainer`;
    ``expected_sarsa`` is Taxi's alone, ``lam > 0`` on ROOMS runs
    :func:`~gym_po_tpu_torch.ops.fused_qlambda.make_fused_qlambda_trainer_rooms`,
    and MultistoryFourRooms and CRooms take neither, as in the JAX package.
    On CRooms the agents start at their reset positions with zero velocity,
    and four float tiles carry the state from chunk to chunk.
    As in the JAX package, ``completed``, ``elapsed`` and the trace restart
    at every chunk.

    With a ``mesh`` of n ranks each rank runs this on its own: ``num_envs``
    is the global batch, every rank resets all of it from ``seed`` and
    keeps its rows (its ``num_envs / n`` envs), chunk ``i`` draws with
    ``chunk_seeds(seed, i, n)[rank]``, and the Q banks are averaged over
    the ranks after every chunk
    (:func:`~gym_po_tpu_torch.parallel.shard_fused_trainer`); the history
    is averaged over the ranks.  Every rank returns the same table.  A
    one-rank mesh gives what no mesh gives, bit for bit.
    """
    from ..envs.crooms import CRooms
    from ..envs.msrooms import MultistoryFourRooms
    from ..envs.rooms import Rooms
    from ..envs.taxi import Taxi
    from ..ops import (
        make_fused_q_trainer,
        make_fused_q_trainer_crooms,
        make_fused_q_trainer_msrooms,
        make_fused_q_trainer_rooms,
        make_fused_qlambda_trainer_rooms,
    )
    from ..ops.fused_qlearning import bank_geometry, banks_to_q, q_to_banks
    from ..parallel import shard_batch, shard_fused_trainer

    if not isinstance(env, (Taxi, Rooms, MultistoryFourRooms, CRooms)):
        raise ValueError(
            f"no fused Q trainer for {type(env).__name__}: Taxi, Rooms, "
            "MultistoryFourRooms and CRooms have one")
    if expected_sarsa and not isinstance(env, Taxi):
        raise ValueError("expected_sarsa is Taxi-only")
    if lam > 0.0 and isinstance(env, (MultistoryFourRooms, CRooms)):
        raise ValueError("lam > 0 (Watkins Q(λ)) supports Taxi and Rooms")
    mesh = _mesh_of(env, mesh, num_envs)
    dev = env.device
    B = num_envs // mesh.size
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(seed),
                          num_envs)
    if isinstance(env, CRooms):
        run = make_fused_q_trainer_crooms(
            env, B, chunk_steps, gamma, average_duplicates=average_duplicates)
        z = torch.zeros((num_envs // 128, 128), dtype=torch.float32, device=dev)
        s = [st.agent_yx[:, 0].reshape(-1, 128), st.agent_yx[:, 1].reshape(-1, 128),
             z, z.clone()]
    elif isinstance(env, Taxi):
        run = make_fused_q_trainer(
            env, B, chunk_steps, gamma,
            average_duplicates=average_duplicates,
            expected_sarsa=expected_sarsa, lam=lam, trace_len=trace_len,
            watkins_cut=watkins_cut,
        )
        s = [st.s.reshape(-1, 128)]
    elif isinstance(env, MultistoryFourRooms):
        run = make_fused_q_trainer_msrooms(
            env, B, chunk_steps, gamma, average_duplicates=average_duplicates)
        s = [_flat_agents_zyx(env, st)]
    else:
        if lam > 0.0:
            run = make_fused_qlambda_trainer_rooms(
                env, B, chunk_steps, gamma, lam=lam,
                trace_len=trace_len, watkins_cut=watkins_cut,
                average_duplicates=average_duplicates)
        else:
            run = make_fused_q_trainer_rooms(
                env, B, chunk_steps, gamma,
                average_duplicates=average_duplicates)
        s = [_flat_agents(env, st)]
    # args after the seed: (lr, eps, *state tiles, q); outs: (*tiles, q, rew)
    n_s = len(s)
    run = shard_fused_trainer(run, mesh, sharded_args=range(2, 2 + n_s),
                              averaged_outs=(n_s,), num_outs=n_s + 2)
    s = shard_batch(mesh, s)
    n_obs = int(env.observation_space.n)
    n_act = int(env.action_space.n)
    nsb, _ = bank_geometry(n_obs, n_act)
    nsp = nsb * 128
    q0 = np.zeros((nsp, n_act), np.float32)
    if q_init is not None:
        q_init = torch.as_tensor(q_init, dtype=torch.float32).cpu().numpy()
        q0[: q_init.shape[0]] = q_init
    qb = torch.as_tensor(q_to_banks(q0, nsb), device=dev)
    history = []
    for seeds, (lr, eps) in _chunks(seed, schedule, chunk_steps, mesh.size):
        *s, qb, rew = run(seeds, lr, eps, *s, qb)
        history.append(rew.mean())  # read once at the end
    return (banks_to_q(qb.cpu().numpy(), nsp, na=n_act, nsb=nsb)[:n_obs],
            _history(history, chunk_steps, mesh))


def fused_actor_critic(env, seed: int, schedule, num_envs: int = 8192,
                       gamma: float = 0.99, chunk_steps: int = 4096,
                       mesh=None):
    """Softmax actor-critic inside the fused CUDA kernel, on ROOMS.

    ``schedule`` is ``[(alpha_pi, alpha_v, num_steps), ...]``, chunked and
    seeded as in :func:`fused_q_learning`; returns ``(logits [n_obs, A],
    v [n_obs], history)`` as float32 numpy, with one mean reward per step
    for each chunk.  See
    :func:`~gym_po_tpu_torch.ops.fused_ac.make_fused_ac_trainer_rooms`.
    With a ``mesh``, as :func:`fused_q_learning`: the policy-logit and the
    value banks are both averaged over the ranks after every chunk.
    """
    from ..envs.rooms import Rooms
    from ..ops import make_fused_ac_trainer_rooms
    from ..ops.fused_qlearning import banks_to_q, q_to_banks
    from ..parallel import shard_batch, shard_fused_trainer

    if not isinstance(env, Rooms):
        raise ValueError(f"no fused AC trainer for {type(env).__name__}: "
                         "Rooms only")
    mesh = _mesh_of(env, mesh, num_envs)
    dev = env.device
    _, st = env.reset_vec(torch.Generator(device=dev).manual_seed(seed),
                          num_envs)
    agent = shard_batch(mesh, _flat_agents(env, st))
    A = int(env.num_actions)
    n_obs = int(env.observation_space.n)
    run = make_fused_ac_trainer_rooms(env, num_envs // mesh.size, chunk_steps,
                                      gamma)
    # args after the seed: (api, apv, th, v, agent); outs: (th, v, agent, rew)
    run = shard_fused_trainer(run, mesh, sharded_args=(4,), averaged_outs=(0, 1),
                              num_outs=4)
    th = torch.as_tensor(q_to_banks(np.zeros((512, A), np.float32)), device=dev)
    v = torch.as_tensor(q_to_banks(np.zeros((512, 1), np.float32)), device=dev)
    history = []
    for seeds, (api, apv) in _chunks(seed, schedule, chunk_steps, mesh.size):
        th, v, agent, rew = run(seeds, api, apv, th, v, agent)
        history.append(rew.mean())
    return (banks_to_q(th.cpu().numpy(), 512, na=A)[:n_obs],
            banks_to_q(v.cpu().numpy(), 512, na=1)[:n_obs, 0],
            _history(history, chunk_steps, mesh))
