"""The port's multi-update PPO step (``make_multi_train_step``, plain and
bounded, and ``train`` through it) against its single update and against
the JAX package's ``make_multi_train_step``, on the CPU.

On the CPU the multi step runs its updates eagerly; on the card it replays
one ``UpdateGraph`` (held to the eager updates bit for bit by
``tests/test_torch_cuda.py``).  Here:

* N updates of the multi step equal N calls of ``make_train_step``'s step
  bit for bit (parameters, Adam state, observations, env state, generator
  state, each metric row), and the bounded form equals the plain one at
  its limit, its rows past the limit NaN;
* ``train``'s history rows are those of a loop of single updates, with and
  without a ragged tail;
* against JAX: the port's ``learn`` carried over the JAX multi step's two
  rollouts and row orders (rebuilt from its key chain), from the JAX
  weights and Adam state, ends at the JAX parameters within
  ``LEARN_ATOL`` (5e-7, as one update's learn half) and gives each metric
  row to rtol 1e-5 + atol 1e-7, as there.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import PPOConfig as JConfig
from gym_po_tpu.agents import init_train_state as j_init
from gym_po_tpu.agents import make_train_step as j_step
from gym_po_tpu.agents import ppo as jppo
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.agents import ppo as tppo
from gym_po_tpu_torch.agents.ppo import PPOConfig, Rollout
from gym_po_tpu_torch.parallel import local_mesh
from test_torch_ppo import (LEARN_ATOL, _envs, _flat_flax, _jax_orders,
                            _jax_rollout, _port_model, _t)

CFG = PPOConfig(num_envs=16, rollout_steps=8, epochs=2, minibatches=2,
                hidden=(16, 16))


def _fresh(env, cfg=CFG, seed=0):
    return tppo.init_train_state(env, cfg, torch.Generator().manual_seed(seed))


def _assert_states_equal(a, b):
    assert a.update_idx == b.update_idx
    for x, y in ((a.params, b.params), (a.opt_state.count, b.opt_state.count),
                 (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
                 (a.env_obs, b.env_obs),
                 (a.generator.get_state(), b.generator.get_state())):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for f in a.env_state.__dataclass_fields__:
        assert torch.equal(getattr(a.env_state, f), getattr(b.env_state, f)), f


def _single_steps(env, n, cfg=CFG, seed=0):
    model, ts = _fresh(env, cfg, seed)
    step = tppo.make_train_step(env, model, cfg)
    rows = []
    for _ in range(n):
        ts, m = step(ts)
        rows.append(m)
    return ts, rows


@pytest.mark.parametrize("env_id", ["ExtendedHansenTaxi-v4", "CarFlag-v0"])
def test_multi_step_equals_single_steps(env_id):
    env = gpt_torch.make(env_id, device="cpu")
    model, ts = _fresh(env)
    multi = tppo.make_multi_train_step(env, model, CFG, 3)
    ts, got = multi(ts)
    want_ts, rows = _single_steps(env, 3)
    _assert_states_equal(ts, want_ts)
    assert multi.graph is None  # the CPU runs the updates eagerly
    assert tuple(got) == tppo.METRIC_NAMES
    for i, m in enumerate(rows):
        for k in tppo.METRIC_NAMES:
            assert got[k].shape == (3,) and torch.equal(got[k][i], m[k]), (i, k)


def test_bounded_equals_plain_at_the_limit():
    env = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    model, ts = _fresh(env)
    bounded = tppo.make_multi_train_step(env, model, CFG, 5, bounded=True)
    ts, got = bounded(ts, 3)
    model_p, ts_p = _fresh(env)
    ts_p, want = tppo.make_multi_train_step(env, model_p, CFG, 3)(ts_p)
    _assert_states_equal(ts, ts_p)
    for k in want:
        assert torch.equal(got[k][:3], want[k])
        assert torch.isnan(got[k][3:]).all()
    # at or past the limit no update is made
    params, gen = ts.params.clone(), ts.generator.get_state()
    for limit in (3, 1):
        ts2, rows = bounded(ts, limit)
        assert ts2.update_idx == 3 and torch.equal(ts2.params, params)
        assert torch.equal(ts2.generator.get_state(), gen)
        assert all(torch.isnan(v).all() for v in rows.values())


def test_multi_step_guards_and_signature():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tppo.make_multi_train_step(env, None, CFG, 0)
    with pytest.raises(ValueError, match="multiple of"):
        tppo.make_multi_train_step(env, None, PPOConfig(num_envs=5, rollout_steps=3), 2)
    names = list(inspect.signature(jppo.make_multi_train_step).parameters)
    names.remove("axis")  # a torch.distributed group has no axis name
    names[names.index("net")] = "model"
    assert list(inspect.signature(tppo.make_multi_train_step).parameters) == names
    from gym_po_tpu_torch import agents

    assert agents.make_multi_train_step is tppo.make_multi_train_step


def test_one_rank_mesh_without_a_group_equals_no_mesh():
    env = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    out = []
    for mesh in (None, local_mesh("cpu")):
        model, ts = _fresh(env)
        out.append(tppo.make_multi_train_step(env, model, CFG, 2, mesh)(ts))
    (ta, ma), (tb, mb) = out
    _assert_states_equal(ta, tb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("num_updates,log_every", [(5, 2), (4, 2), (3, 0)],
                         ids=["ragged", "even", "no-log"])
def test_train_history_rows_are_the_single_steps(num_updates, log_every, capsys):
    env = gpt_torch.make("Taxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=8, rollout_steps=4, epochs=1, minibatches=1,
                    hidden=(8,))
    _, ts, history = tppo.train(env, cfg, seed=0, num_updates=num_updates,
                                log_every=log_every)
    want_ts, rows = _single_steps(env, num_updates, cfg)
    _assert_states_equal(ts, want_ts)
    ends = [i for i in range(1, num_updates + 1)
            if log_every and (i % log_every == 0 or i == num_updates)]
    assert history == [{k: float(v) for k, v in rows[i - 1].items()} for i in ends]
    out = capsys.readouterr().out
    assert all(f"update {i}:" in out for i in ends)


@pytest.mark.parametrize("shuffle", ["permute", "roll"])
def test_learn_over_jax_multi_step_rollouts_matches_jax(shuffle):
    """JAX's make_multi_train_step(N = 2); each update's rollout and row
    orders rebuilt from its key chain; the port's learn carried over both
    from the JAX weights and Adam state."""
    je, te = _envs("ExtendedHansenTaxi-v4", time_limit=6)
    hidden = (16, 16)
    fields = dict(num_envs=16, rollout_steps=8, epochs=2, minibatches=2,
                  hidden=hidden, shuffle=shuffle)
    cfg_j, cfg_t = JConfig(**fields), PPOConfig(**fields)
    net, ts0 = j_init(je, cfg_j, jax.random.PRNGKey(5))
    ts2, jm = jppo.make_multi_train_step(je, net, cfg_j, 2)(ts0)
    # the second update's rollout runs with the first update's weights
    ts1, _ = j_step(je, net, cfg_j)(ts0)

    model, flat = _port_model(je, te, jax.tree.map(np.asarray, ts0.params), hidden)
    opt = tnet.adam_state_from_optax(jax.tree.map(np.asarray, ts0.opt_state))
    n = cfg_t.num_envs * cfg_t.rollout_steps
    for i, ts_i in enumerate((ts0, ts1)):
        outs, obs_f, est_f, key = _jax_rollout(je, net, cfg_j, ts_i)
        ro = Rollout(*(_t(x) for x in outs))
        ro = ro._replace(action=ro.action.long())
        tm = tppo.learn(model, flat, opt, cfg_t, tppo.batch_from_rollout(ro, cfg_t),
                        _jax_orders(cfg_t, n, key))
        tm.update(tppo._reward_metrics(ro.reward))
        for k, v in tm.items():
            np.testing.assert_allclose(float(v), float(jm[k][i]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} row {i}")
    # the rebuild is the multi step's own second update
    np.testing.assert_array_equal(np.asarray(obs_f), np.asarray(ts2.env_obs))
    for a, b in zip(jax.tree.leaves(est_f), jax.tree.leaves(ts2.env_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = _flat_flax(jax.tree.map(np.asarray, ts2.params))
    moved = float((want - _flat_flax(jax.tree.map(np.asarray, ts1.params))).abs().max())
    assert moved > 1e-4  # the second update moved the weights
    np.testing.assert_allclose(flat.numpy(), want.numpy(), atol=LEARN_ATOL, rtol=0)
    assert int(opt.count) == 2 * cfg_t.epochs * cfg_t.minibatches
