"""Data-parallel PPO and recurrent PPO of the port, and its process-group
bring-up, against the JAX package on the CPU.

* ``distributed_init`` keeps the JAX package's contract
  (``tests/test_distributed.py``): a bare call that fails warns and runs on
  one process, explicit arguments re-raise, ``allow_fallback=True`` opts in;
* the learn half of one JAX ``make_train_step`` update on a 2-device mesh
  of the virtual CPU devices against the port's on two gloo ranks: each
  rank gets the JAX shard's own batch (its rollout rebuilt with the shard's
  key splits) and row orders, as ``test_torch_ppo.py`` does for one
  device, and the gradient is averaged over the ranks; params to that
  test's tolerance (atol 5e-7), the averaged metrics to rtol 1e-5;
* the same for a recurrent update (``test_torch_ppo_rnn.py``'s tolerance);
* full data-parallel updates: both ranks hold the same parameters and
  report the same metrics;
* ``dryrun_multichip(2, device="cpu")``.

The ranks run the jax-free targets of ``_torch_ranks.py``.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import PPOConfig as JConfig
from gym_po_tpu.agents import init_train_state as j_init
from gym_po_tpu.agents import make_train_step as j_step
from gym_po_tpu.agents import ppo_rnn as jrnn
from gym_po_tpu.agents import shard_train_state as j_shard
from gym_po_tpu.parallel import make_mesh as j_make_mesh
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.agents import ppo as tppo
from gym_po_tpu_torch.agents import ppo_rnn as trnn
from gym_po_tpu_torch.agents.ppo import PPOConfig, Rollout
from gym_po_tpu_torch.entry import dryrun_multichip
from gym_po_tpu_torch.parallel import Ranks, distributed_init

import _torch_ranks
from test_torch_ppo import _jax_orders, _jax_rollout, _flat_flax
from test_torch_ppo_rnn import _jax_rnn_rollout

DEVICES = ["cpu", "cpu"]
LEARN_ATOL = 5e-7
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def ranks():
    with Ranks(2, "gloo", timeout=180) as r:
        yield r


@pytest.fixture(scope="module")
def jmesh2():
    return j_make_mesh(shape=(2,), devices=jax.devices()[:2])


def _t(x):
    t = torch.as_tensor(np.array(x))
    return t.long() if t.dtype == torch.int32 else t


# ------------------------------------------------------ distributed_init
def _boom(message):
    def init(**kw):
        raise RuntimeError(message)
    return init


def test_distributed_init_bare_call_warns_and_falls_back(monkeypatch):
    monkeypatch.setattr(dist, "init_process_group", _boom("no rendezvous"))
    with pytest.warns(RuntimeWarning, match="single-process"):
        distributed_init()  # bare: the environment gave no group -> local
    assert not dist.is_initialized()


def test_distributed_init_explicit_config_raises(monkeypatch):
    monkeypatch.setattr(dist, "init_process_group", _boom("bad rendezvous"))
    with pytest.raises(RuntimeError, match="bad rendezvous"):
        distributed_init(backend="gloo", init_method="tcp://example:1",
                         world_size=2, rank=0)


def test_distributed_init_explicit_fallback_opt_in(monkeypatch):
    monkeypatch.setattr(dist, "init_process_group", _boom("bad rendezvous"))
    with pytest.warns(RuntimeWarning, match="single-process"):
        distributed_init(allow_fallback=True, backend="gloo",
                         init_method="tcp://example:1", world_size=2, rank=0)


# ------------------------------------------------------------ learn half
def _jax_shard(ts, rows, key):
    """Shard ``rows`` of a global JAX train state, with its own key."""
    take = lambda x: x[rows]  # noqa: E731
    return ts.replace(env_obs=take(ts.env_obs),
                      env_state=jax.tree.map(take, ts.env_state), key=key)


def test_two_rank_ppo_learn_half_matches_jax_sharded_step(ranks, jmesh2):
    env_id, env_kw, hidden = "ExtendedHansenTaxi-v4", dict(time_limit=6), (32, 32)
    fields = dict(num_envs=32, rollout_steps=8, epochs=2, minibatches=2,
                  hidden=hidden, shuffle="permute")
    cfg_j, cfg_t = JConfig(**fields), PPOConfig(**fields)
    je, te = gpt.make(env_id, **env_kw), gpt_torch.make(env_id, device="cpu", **env_kw)
    net, ts = j_init(je, cfg_j, jax.random.PRNGKey(4))
    ts2, jm = j_step(je, net, cfg_j, jmesh2)(j_shard(ts, jmesh2))

    keys = jax.random.split(ts.key, 2)
    batches, orders, rewards = [], [], []
    for r in range(2):
        shard = _jax_shard(ts, slice(16 * r, 16 * (r + 1)), keys[r])
        outs, obs_f, _, key = _jax_rollout(je, net, cfg_j, shard)
        # the rebuild is the shard's own rollout
        np.testing.assert_array_equal(np.asarray(obs_f),
                                      np.asarray(ts2.env_obs)[16 * r:16 * (r + 1)])
        ro = Rollout(*(_t(x) for x in outs))
        batches.append(tppo.batch_from_rollout(ro, cfg_t))
        orders.append(_jax_orders(cfg_t, 16 * cfg_t.rollout_steps, key))
        rewards.append(ro.reward)
    params_np = jax.tree.map(np.asarray, ts.params)
    opt = tnet.adam_state_from_optax(jax.tree.map(np.asarray, ts.opt_state))
    got = ranks.run(_torch_ranks.ppo_learn, DEVICES, env_id, env_kw, fields,
                    hidden, _flat_flax(params_np), opt, batches, orders, rewards)

    want = _flat_flax(jax.tree.map(np.asarray, ts2.params))
    assert float((want - _flat_flax(params_np)).abs().max()) > 1e-4  # it moved
    (flat0, m0, n0), (flat1, m1, n1) = got
    assert torch.equal(flat0, flat1) and m0 == m1 and n0 == n1 == 4
    np.testing.assert_allclose(flat0.numpy(), want.numpy(), atol=LEARN_ATOL, rtol=0)
    for k in ("loss", "pg_loss", "v_loss", "entropy", "mean_reward"):
        np.testing.assert_allclose(m0[k], float(jm[k]), err_msg=k, **METRIC_TOL)
    # the shards' own losses differ: the average is not one rank's
    assert not np.array_equal(batches[0].obs.numpy(), batches[1].obs.numpy())


def test_two_rank_rnn_learn_half_matches_jax_sharded_step(ranks, jmesh2):
    """The second sharded JAX update (the hidden state carried from the
    first) against ``learn_rnn`` on two ranks."""
    env_id, env_kw, H = "ExtendedHansenTaxi-v4", dict(time_limit=3), 16
    fields = dict(num_envs=32, rollout_steps=8, epochs=2, minibatches=2)
    cfg_j, cfg_t = JConfig(**fields), PPOConfig(**fields)
    je = gpt.make(env_id, **env_kw)
    net, ts0 = jrnn.init_rnn_state(je, cfg_j, jax.random.PRNGKey(6), hidden=H)
    jstep = jrnn.make_rnn_train_step(je, net, cfg_j, jmesh2)
    ts, _ = jstep(jrnn.shard_rnn_state(ts0, jmesh2))
    ts2, jm = jstep(ts)

    host = jax.tree.map(np.asarray, ts)  # keys: one per shard, [2, 2]
    seqs, orders, rewards = [], [], []
    for r in range(2):
        rows = slice(16 * r, 16 * (r + 1))
        shard = host.replace(
            env_obs=host.env_obs[rows], hidden=host.hidden[rows],
            prev_reset=host.prev_reset[rows], key=host.key[r],
            env_state=jax.tree.map(lambda x: x[rows], host.env_state))
        (obs_f, _, _, _, key), outs = _jax_rnn_rollout(je, net, cfg_j, shard)
        np.testing.assert_array_equal(np.asarray(obs_f),
                                      np.asarray(ts2.env_obs)[rows])
        obs, action, logp, value, v_term, reset, done, rew, cont = map(_t, outs)
        adv, target = tppo._gae(rew, value, v_term, done, cont, cfg_t.gamma,
                                cfg_t.gae_lambda)
        seqs.append(trnn.Seq(obs, action, logp, value, reset, adv, target,
                             _t(shard.hidden)))
        perms = []
        for _ in range(cfg_j.epochs):
            key, kp = jax.random.split(key)
            perms.append(torch.as_tensor(np.array(jax.random.permutation(kp, 16)),
                                         dtype=torch.int64))
        orders.append(perms)
        rewards.append(rew)
    assert any(s.reset[1:].any() for s in seqs)  # episodes end inside

    def flat_of(tree):
        return torch.cat([t.reshape(-1) for t in trnn.rnn_params_from_flax(
            jax.tree.map(np.asarray, tree)).values()])

    opt = trnn.rnn_adam_state_from_optax(jax.tree.map(np.asarray, host.opt_state))
    got = ranks.run(_torch_ranks.rnn_learn, DEVICES, env_id, env_kw, fields, H,
                    flat_of(host.params), opt, seqs, orders, rewards)
    want = flat_of(ts2.params)
    assert float((want - flat_of(host.params)).abs().max()) > 1e-4
    (flat0, m0, n0), (flat1, m1, _) = got
    assert torch.equal(flat0, flat1) and m0 == m1 and n0 == 8
    np.testing.assert_allclose(flat0.numpy(), want.numpy(), atol=LEARN_ATOL, rtol=0)
    for k in ("loss", "pg_loss", "v_loss", "entropy", "mean_reward"):
        np.testing.assert_allclose(m0[k], float(jm[k]), err_msg=k, **METRIC_TOL)


# ----------------------------------------------------------- train steps
@pytest.mark.parametrize("recurrent", [False, True], ids=["ppo", "recurrent"])
def test_ranks_hold_the_same_parameters_and_metrics(ranks, recurrent):
    fields = dict(num_envs=16, rollout_steps=8, epochs=2, minibatches=2,
                  hidden=(16, 16))
    got = ranks.run(_torch_ranks.train_steps, DEVICES, "ExtendedHansenTaxi-v4",
                    dict(time_limit=6), fields, recurrent, 2)
    (h0, p0, rows0, obs0), (h1, p1, rows1, obs1) = got
    assert rows0 == rows1 == 8
    assert h0 == h1 and torch.equal(p0, p1)
    assert all(np.isfinite(v) for m in h0 for v in m.values())
    assert not np.array_equal(obs0, obs1)  # each rank stepped its own envs


def test_per_device_state_and_guards():
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)
    cfg = PPOConfig(num_envs=16, rollout_steps=4, minibatches=2, hidden=(8, 8))
    _, ts = tppo.init_train_state(te, cfg, gen, num_devices=4)
    assert ts.env_obs.shape == (4,)
    _, rs = trnn.init_rnn_state(te, cfg, gen, hidden=8, num_devices=4)
    assert rs.env_obs.shape == (4,) and rs.hidden.shape == (4, 8)
    assert rs.prev_reset.shape == (4,)
    with pytest.raises(ValueError, match="divisible"):
        tppo.init_train_state(te, cfg, gen, num_devices=3)
    with pytest.raises(ValueError, match="minibatches"):
        trnn.init_rnn_state(te, cfg, gen, num_devices=16)


def test_shard_state_refuses_a_state_off_the_mesh_device():
    """The parameters are broadcast in place: a state on another device
    than the mesh's is refused, not copied and left behind."""
    from gym_po_tpu_torch.parallel import Mesh

    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=8, rollout_steps=4, minibatches=2, hidden=(8, 8))
    elsewhere = Mesh(None, 0, 1, torch.device("meta"))
    _, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mesh's device"):
        tppo.shard_train_state(ts, elsewhere)
    _, rs = trnn.init_rnn_state(te, cfg, torch.Generator().manual_seed(0), hidden=8)
    with pytest.raises(ValueError, match="mesh's device"):
        trnn.shard_rnn_state(rs, elsewhere)
    here = Mesh(None, 0, 1, torch.device("cpu"))
    assert torch.equal(tppo.shard_train_state(ts, here).params, ts.params)


def test_dryrun_multichip_on_two_cpu_ranks():
    out = dryrun_multichip(2, device="cpu")
    assert len(out) == 2 and out[0]["metrics"] == out[1]["metrics"]
    assert np.isfinite(out[0]["loss"])
    assert out[0]["ant_metrics"] == out[1]["ant_metrics"]
    assert np.isfinite(out[0]["ant_loss"])


def test_dryrun_refuses_nccl_without_a_card_per_rank():
    with pytest.raises(ValueError, match="NCCL"):
        dryrun_multichip(torch.cuda.device_count() + 1, device="cuda")
    with pytest.raises(ValueError, match="NCCL"):
        dryrun_multichip(1, device="cpu", backend="nccl")
