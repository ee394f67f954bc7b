"""The port's chunked batching (``gym_po_tpu_torch.vector.chunked`` and
``agents.ppo.make_chunked_train_step``), case by case as
``tests/test_chunked.py`` holds the JAX package's, on the CPU.

Chunk ``i`` of a chunked call draws from the ``i``-th generator of
``parallel.split_generator`` of the caller's (JAX: ``fold_in(key, i)``), so
a chunked rollout or step equals a hand-made loop over the chunks exactly.
The chunked train step collects its chunks in turn from the train state's
generator and learns once over their batches concatenated chunk-major;
against JAX, with ``shuffle="none"`` (each minibatch a fixed run of rows),
the port's ``learn`` over JAX's own chunk rollouts in that order ends at
the JAX chunked step's parameters within ``LEARN_ATOL`` (5e-7, as one
update's learn half), and the single collect's time-major order does not.
"""

import inspect
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import PPOConfig as JConfig
from gym_po_tpu.agents import init_train_state as j_init
from gym_po_tpu.agents import ppo as jppo
from gym_po_tpu.vector import chunked as jchunked
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.agents import ppo as tppo
from gym_po_tpu_torch.agents.ppo import Batch, PPOConfig, Rollout
from gym_po_tpu_torch.core import map_tensors
from gym_po_tpu_torch.parallel import split_generator
from gym_po_tpu_torch.vector import (DISPATCH_BATCH, chunked_rollout,
                                     make_chunked_step, rollout)
from test_torch_ppo import (LEARN_ATOL, _envs, _flat_flax, _jax_rollout,
                            _port_model, _t)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rows(tree, sl):
    return map_tensors(lambda x: x[sl], tree)


def test_api_mirrors_jax():
    assert DISPATCH_BATCH == jchunked.DISPATCH_BATCH == 4096
    for name in ("chunked_rollout", "make_chunked_step"):
        want = list(inspect.signature(getattr(jchunked, name)).parameters)
        got = list(inspect.signature(globals()[name]).parameters)
        assert got == [("generator" if p == "key" else p) for p in want], name
    want = list(inspect.signature(jppo.make_chunked_train_step).parameters)
    assert list(inspect.signature(tppo.make_chunked_train_step).parameters) == \
        [("model" if p == "net" else p) for p in want]
    from gym_po_tpu_torch import agents, vector

    assert agents.make_chunked_train_step is tppo.make_chunked_train_step
    assert {"chunked_rollout", "make_chunked_step", "DISPATCH_BATCH"} <= set(vector.__all__)


def test_chunked_rollout_shapes_and_exactness():
    env = gpt_torch.make("HansenTaxi-v4", device="cpu")
    B, Bc, T = 64, 16, 12
    obs, state = env.reset_vec(_gen(9), B)
    traj, (fobs, fstate) = chunked_rollout(env, _gen(3), None, B, T,
                                           dispatch_batch=Bc, init=(obs, state))
    assert traj.obs.shape[:2] == (T, B) and fobs.shape[0] == B
    # chunk i equals a plain rollout of its rows under the i-th split
    # generator: the chunked path adds no other draw
    for i, gen in enumerate(split_generator(_gen(3), B // Bc)):
        sl = slice(i * Bc, (i + 1) * Bc)
        traj_i, (fobs_i, fstate_i) = rollout(env, gen, None, Bc, T,
                                             init=_rows((obs, state), sl))
        assert torch.equal(traj.obs[:, sl], traj_i.obs)
        assert torch.equal(traj.reward[:, sl], traj_i.reward)
        assert torch.equal(fobs[sl], fobs_i)
        assert torch.equal(fstate.s[sl], fstate_i.s)


def test_chunked_rollout_small_batch_is_single_dispatch():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    traj, _ = chunked_rollout(env, _gen(0), None, 8, 5, dispatch_batch=4096)
    ref, _ = rollout(env, _gen(0), None, 8, 5)
    assert torch.equal(traj.obs, ref.obs) and torch.equal(traj.action, ref.action)


def test_chunked_rollout_rejects_ragged_batch():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    with pytest.raises(ValueError):
        chunked_rollout(env, _gen(0), None, 24, 4, dispatch_batch=16)


def test_make_chunked_step_matches_per_chunk_step():
    env = gpt_torch.make("CRooms-v0", device="cpu")
    B, Bc = 32, 8
    obs, state = env.reset_vec(_gen(2), B)
    actions = torch.rand(B, 2, generator=_gen(4)) * 2 - 1
    step = make_chunked_step(env, dispatch_batch=Bc)
    nobs, nstate, rew, done, trunc, info = step(_gen(1), state, actions)
    assert nobs.shape[0] == B and rew.shape == (B,)
    for i, gen in enumerate(split_generator(_gen(1), B // Bc)):
        sl = slice(i * Bc, (i + 1) * Bc)
        o_i, s_i, r_i, d_i, t_i, _ = env.step_vec(gen, _rows(state, sl), actions[sl])
        assert torch.equal(nobs[sl], o_i) and torch.equal(rew[sl], r_i)
        assert torch.equal(done[sl], d_i) and torch.equal(trunc[sl], t_i)
        for f in s_i.__dataclass_fields__:
            assert torch.equal(getattr(nstate, f)[sl], getattr(s_i, f)), f
    # one chunk's worth is the plain step from the caller's generator
    o1, *_ = make_chunked_step(env, dispatch_batch=B)(_gen(1), state, actions)
    assert torch.equal(o1, env.step_vec(_gen(1), state, actions)[0])
    with pytest.raises(ValueError):
        make_chunked_step(env, dispatch_batch=12)(_gen(1), state, actions)


def test_chunked_step_on_ant_physics_tiny():
    """The API's target env of the JAX package: one chunked step on a tiny
    ant batch (the batched engine, one iteration)."""
    env = gpt_torch.make("AntTagPhysics-v0", frame_skip=1, solver_iters=1,
                         integrator="euler", pipeline="array", device="cpu")
    B, Bc = 8, 4
    _, state = env.reset_vec(_gen(0), B)
    nobs, *_ = make_chunked_step(env, dispatch_batch=Bc)(
        _gen(1), state, torch.zeros(B, 8))
    assert nobs.shape == (B, 29) and torch.isfinite(nobs).all()


def test_chunked_train_step_runs_and_learns_shape():
    env = gpt_torch.make("HansenTaxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=64, rollout_steps=8, epochs=2, minibatches=2,
                    hidden=(16, 16))
    model, ts = tppo.init_train_state(env, cfg, _gen(0))
    step = tppo.make_chunked_train_step(env, model, cfg, dispatch_batch=16)
    before = ts.params.clone()
    ts, m = step(ts)
    ts, m = step(ts)
    assert ts.update_idx == 2 and ts.env_obs.shape[0] == 64
    assert set(m) == set(tppo.METRIC_NAMES)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.allclose(before, ts.params)
    assert int(ts.opt_state.count) == 2 * cfg.epochs * cfg.minibatches
    with pytest.raises(ValueError):
        tppo.make_chunked_train_step(env, model, cfg, dispatch_batch=24)


def test_chunked_train_step_collects_chunks_in_turn():
    """The step is the chunk collects in chunk order from the train state's
    generator, then the row orders and one learn over the chunk-major
    concatenation, the reward metrics averaged over the chunks."""
    env = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=48, rollout_steps=4, epochs=2, minibatches=3,
                    hidden=(16,))
    model, ts = tppo.init_train_state(env, cfg, _gen(1))
    got_ts, got = tppo.make_chunked_train_step(env, model, cfg, 16)(ts)
    model, ts = tppo.init_train_state(env, cfg, _gen(1))
    chunk_cfg = cfg._replace(num_envs=16)
    outs = [tppo.collect(env, model, chunk_cfg, ts.env_obs[sl], _rows(ts.env_state, sl),
                         ts.generator)
            for sl in (slice(0, 16), slice(16, 32), slice(32, 48))]
    batch = Batch(*(torch.cat(x) for x in zip(*(o[0] for o in outs))))
    orders = tppo.row_orders(cfg, batch.obs.shape[0], ts.generator)
    want = tppo.learn(model, ts.params, ts.opt_state, cfg, batch, orders)
    assert torch.equal(got_ts.params, ts.params)
    assert torch.equal(got_ts.env_obs, torch.cat([o[2] for o in outs]))
    assert torch.equal(got_ts.generator.get_state(), ts.generator.get_state())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    rates = torch.stack([o[1].reward.mean() for o in outs])
    assert torch.allclose(got["mean_reward"], rates.mean(), rtol=1e-6, atol=0)


def test_chunked_train_step_small_batch_is_plain_train_step():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=16, rollout_steps=4, epochs=1, minibatches=1,
                    hidden=(8,))
    out = []
    for make in (lambda m: tppo.make_chunked_train_step(env, m, cfg, 4096),
                 lambda m: tppo.make_train_step(env, m, cfg)):
        model, ts = tppo.init_train_state(env, cfg, _gen(0))
        out.append(make(model)(ts))
    (tc, mc), (tp, mp) = out
    assert torch.equal(tc.params, tp.params) and torch.equal(tc.env_obs, tp.env_obs)
    assert all(torch.equal(mc[k], mp[k]) for k in mp)


def test_chunked_learn_row_order_matches_jax():
    """JAX's chunked train step (four chunks of 16 envs, shuffle 'none');
    its chunk rollouts rebuilt from fold_in(key, i); the port's learn over
    their batches concatenated chunk-major ends at JAX's parameters."""
    je, te = _envs("ExtendedHansenTaxi-v4", time_limit=6)
    hidden, Bc, T = (16, 16), 16, 8
    fields = dict(num_envs=64, rollout_steps=T, epochs=2, minibatches=2,
                  hidden=hidden, shuffle="none")
    cfg_j, cfg_t = JConfig(**fields), PPOConfig(**fields)
    net, ts = j_init(je, cfg_j, jax.random.PRNGKey(6))
    ts2, jm = jppo.make_chunked_train_step(je, net, cfg_j, dispatch_batch=Bc)(ts)
    key, _ = jax.random.split(ts.key)
    batches = []
    for i in range(4):
        sl = slice(i * Bc, (i + 1) * Bc)
        chunk = SimpleNamespace(params=ts.params, env_obs=ts.env_obs[sl],
                                env_state=jax.tree.map(lambda x: x[sl], ts.env_state),
                                key=jax.random.fold_in(key, i))
        outs, obs_f, _, _ = _jax_rollout(je, net, cfg_j, chunk)
        np.testing.assert_array_equal(np.asarray(obs_f), np.asarray(ts2.env_obs[sl]))
        ro = Rollout(*(_t(x) for x in outs))
        batches.append(tppo.batch_from_rollout(ro._replace(action=ro.action.long()),
                                               cfg_t))
    chunk_major = Batch(*(torch.cat(x) for x in zip(*batches)))

    def learn(batch):
        model, flat = _port_model(je, te, jax.tree.map(np.asarray, ts.params), hidden)
        opt = tnet.adam_state_from_optax(jax.tree.map(np.asarray, ts.opt_state))
        return flat, tppo.learn(model, flat, opt, cfg_t, batch, [None] * cfg_t.epochs)

    got, tm = learn(chunk_major)
    want = _flat_flax(jax.tree.map(np.asarray, ts2.params))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LEARN_ATOL, rtol=0)
    for k, v in tm.items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    # the single collect's time-major rows (t·B + b) give other minibatches
    time_major = Batch(*(x.reshape(4, T, Bc, *x.shape[1:]).transpose(0, 1)
                         .reshape(x.shape) for x in chunk_major))
    other, _ = learn(time_major)
    assert float((other - want).abs().max()) > 100 * LEARN_ATOL
