"""The PPO learner of the PyTorch port (``gym_po_tpu_torch.agents.ppo``)
against the JAX package's (``gym_po_tpu.agents.ppo``), on the CPU.

Weights are carried across by ``params_from_flax``, Adam's state by
``adam_state_from_optax``; inputs are made from a seed with numpy.
Tolerances (f32):

* ``_gae``: rtol 1e-6 (the same operations in the same order);
* ``_loss_fn``: loss and its terms to rtol 1e-5, gradients to atol 5e-7 +
  rtol 1e-5 (measured: 6e-8 at most).  The two sum their products in
  different orders, and the port's first layer indexes weight columns,
  whose backward is a scatter-add where flax's one-hot product sums in
  another order;
* one clip-and-Adam step on the same gradients: the moments and the
  params to atol 1e-9 + rtol 1e-6 (the global norm is one sum in the port
  and a sum of per-leaf sums in optax, a last-bit difference);
* the whole learn half (E = M = 2) from the JAX update's own batch and row
  orders: params to atol 5e-7 (measured: 6e-8 at most; each of the four
  Adam steps moves a weight by up to lr = 2.5e-4, and the gradients differ
  in their last bits), the mean loss terms to rtol 1e-5 + atol 1e-7.

The rollout itself draws from each package's own generator, so the
collect half is held to its invariants (off a boundary ``v_term`` is
V(next obs); the stored logp is ``log_prob`` recomputed), and the learning
smoke tests to the JAX tests' criteria at the JAX tests' sizes.
"""

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import PPOConfig as JConfig
from gym_po_tpu.agents import init_train_state as j_init
from gym_po_tpu.agents import make_train_step as j_step
from gym_po_tpu.agents import networks as jnet
from gym_po_tpu.agents import ppo as jppo
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.agents import ppo as tppo
from gym_po_tpu_torch.agents.ppo import Batch, PPOConfig, Rollout
from gym_po_tpu_torch.utils.profiling import enable_spans, read_counters, spans_enabled, trace

GRAD_TOL = dict(atol=5e-7, rtol=1e-5)
ADAM_TOL = dict(atol=1e-9, rtol=1e-6)
LEARN_ATOL = 5e-7


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _np(t):
    return t.detach().cpu().numpy()


def _port_model(je, te, params_np, hidden):
    """The port's model, flat, holding the flax params."""
    model = tnet.make_actor_critic(te, hidden)
    flat = tnet.flatten_parameters(model)
    model.load_state_dict(tnet.params_from_flax(params_np))
    return model, flat


def _flat_flax(tree):
    return torch.cat([t.reshape(-1) for t in tnet.params_from_flax(tree).values()])


def _envs(env_id, **kw):
    return gpt.make(env_id, **kw), gpt_torch.make(env_id, device="cpu", **kw)


# ------------------------------------------------------------------ config
def test_config_defaults_match_jax():
    jf, tf = JConfig._fields, PPOConfig._fields
    assert jf == tf
    for name in jf:
        if name != "compute_dtype":
            assert getattr(PPOConfig(), name) == getattr(JConfig(), name), name
    assert PPOConfig().compute_dtype == torch.float32


def test_config_and_mesh_guards():
    te = gpt_torch.make("Taxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)
    # bfloat16 is accepted (the torso computes in it); float16 is refused
    model, _ = tppo.init_train_state(
        te, PPOConfig(num_envs=8, rollout_steps=4, compute_dtype=torch.bfloat16),
        gen)
    assert model.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32"):
        tppo.init_train_state(te, PPOConfig(compute_dtype=torch.float16), gen)
    with pytest.raises(ValueError, match="multiple of"):
        tppo.make_train_step(te, None, PPOConfig(num_envs=5, rollout_steps=3))
    # a mesh is taken; its ranks must split the batch
    from gym_po_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="divisible"):
        tppo.make_train_step(te, None, PPOConfig(),
                             mesh=Mesh(None, 0, 3, torch.device("cpu"), dims=(3,)))
    with pytest.raises(ValueError, match="shuffle"):
        tppo.make_train_step(te, None, PPOConfig(shuffle="bogus"))
    assert inspect.signature(tppo.train).parameters["mesh"].default is None


def test_init_draws_from_the_explicit_generator():
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=32, rollout_steps=4, hidden=(16, 16))
    before = torch.random.get_rng_state()
    m1, ts1 = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(7))
    assert torch.equal(before, torch.random.get_rng_state())  # global untouched
    m2, ts2 = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(7))
    assert torch.equal(ts1.params, ts2.params)
    assert torch.equal(ts1.env_obs, ts2.env_obs)
    # the model's parameters are views of the flat buffer
    for p in tnet.parameter_list(m1):
        assert p.untyped_storage().data_ptr() == ts1.params.untyped_storage().data_ptr()
    assert ts1.params.numel() == sum(p.numel() for p in m1.parameters())
    assert int(ts1.opt_state.count) == 0 and ts1.update_idx == 0


# --------------------------------------------------------------------- GAE
def test_gae_matches_jax_on_random_inputs():
    rng = np.random.default_rng(0)
    T, B = 37, 64
    rew = rng.normal(size=(T, B)).astype(np.float32)
    val = rng.normal(size=(T, B)).astype(np.float32)
    nxt = rng.normal(size=(T, B)).astype(np.float32)
    done = (rng.random((T, B)) < 0.1).astype(np.float32)
    trunc = rng.random((T, B)) < 0.1
    cont = 1.0 - np.maximum(done, trunc).astype(np.float32)
    assert (done.astype(bool) & trunc).any() and (trunc & ~done.astype(bool)).any()
    ja, jt = jppo._gae(*map(jnp.asarray, (rew, val, nxt, done, cont)), 0.99, 0.95)
    ta, tt = tppo._gae(*map(_t, (rew, val, nxt, done, cont)), 0.99, 0.95)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-6)


def test_gae_bootstraps_through_truncation():
    """The hand-checked case of tests/test_agents.py: a truncation at t = 1
    bootstraps gamma*V(terminal); a termination there cuts it."""
    g, lam = 0.9, 0.8
    rew = _t([[1.0], [1.0], [1.0]])
    val = _t([[0.5], [0.6], [0.7]])
    nxt = _t([[0.6], [2.0], [0.3]])
    cont = _t([[1.0], [0.0], [1.0]])
    done = _t([[0.0], [0.0], [0.0]])
    adv, target = tppo._gae(rew, val, nxt, done, cont, g, lam)
    d2 = 1.0 + g * 0.3 - 0.7
    d1 = 1.0 + g * 2.0 - 0.6
    d0 = 1.0 + g * 0.6 - 0.5
    exp = [d0 + g * lam * d1, d1, d2]
    np.testing.assert_allclose(_np(adv)[:, 0], exp, rtol=1e-6)
    np.testing.assert_allclose(_np(target)[:, 0], np.asarray(exp) + [0.5, 0.6, 0.7],
                               rtol=1e-6)
    done_t = _t([[0.0], [1.0], [0.0]])
    adv_t, _ = tppo._gae(rew, val, nxt, done_t, cont, g, lam)
    d1t = 1.0 - 0.6
    np.testing.assert_allclose(_np(adv_t)[:, 0], [d0 + g * lam * d1t, d1t, d2],
                               rtol=1e-6)


# -------------------------------------------------------------------- loss
def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(
            np.float32), params)


def _loss_case(env_id, seed):
    je, te = _envs(env_id)
    hidden = (32, 32)
    net = jnet.make_actor_critic(je, hidden)
    rng = np.random.default_rng(seed)
    n = 256
    if env_id == "CarFlag-v0":
        obs = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        action = rng.normal(size=(n, 1)).astype(np.float32)
    else:
        obs = rng.integers(0, je.observation_space.n, n).astype(np.int32)
        action = rng.integers(0, je.action_space.n, n).astype(np.int32)
    params = _perturbed(net.init(jax.random.PRNGKey(seed), jnp.asarray(obs[:1])), seed)
    pi, _ = net.apply(params, jnp.asarray(obs))
    # old log-probs near the current ones, so some ratios clip and some not
    logp = (np.asarray(jnet.log_prob(pi, jnp.asarray(action)))
            + rng.normal(0, 0.3, n)).astype(np.float32)
    value = rng.normal(size=n).astype(np.float32)
    adv = rng.normal(1.0, 2.0, n).astype(np.float32)
    target = (value + rng.normal(0, 0.5, n)).astype(np.float32)
    cols = (obs, action, logp, value, adv, target)
    return je, te, net, params, hidden, cols


@pytest.mark.parametrize("env_id", ["ExtendedHansenTaxi-v4", "CarFlag-v0"])
def test_loss_and_gradients_match_jax(env_id):
    je, te, net, params, hidden, cols = _loss_case(env_id, 3)
    cfg_j, cfg_t = JConfig(), PPOConfig()
    (jloss, jaux), jgrads = jax.value_and_grad(jppo._loss_fn, has_aux=True)(
        params, net, jppo._Batch(*map(jnp.asarray, cols)), cfg_j)
    model, _ = _port_model(je, te, params, hidden)
    tloss, taux = tppo._loss_fn(model, Batch(*map(_t, cols)), cfg_t)
    tgrads = torch.autograd.grad(tloss, tnet.parameter_list(model))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    want = tnet.params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert len(want) == len(tgrads)
    for (name, w), g in zip(want.items(), tgrads):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **GRAD_TOL)
    # the ratio clip and the value clip both bind somewhere in this batch
    ratio = np.exp(_np(tnet.log_prob(model(_t(cols[0]))[0], _t(cols[1]))) - cols[2])
    assert ((ratio > 1.2) | (ratio < 0.8)).any() and (abs(ratio - 1) < 0.2).any()


def test_loss_normalises_with_the_population_std():
    je, te, net, params, hidden, cols = _loss_case("ExtendedHansenTaxi-v4", 4)
    model, _ = _port_model(je, te, params, hidden)
    cols = list(cols)
    cols[4] = np.asarray([1.0, 3.0] * 128, np.float32)  # std 1 (pop.), 1.002 (sample)
    loss, aux = tppo._loss_fn(model, Batch(*map(_t, cols)), PPOConfig())
    jl, jaux = jppo._loss_fn(params, net, jppo._Batch(*map(jnp.asarray, cols)),
                             JConfig())
    np.testing.assert_allclose(float(aux["pg_loss"]), float(jaux["pg_loss"]),
                               rtol=1e-5)


# -------------------------------------------------------------------- Adam
@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_and_adam_step_match_optax(scale):
    """Three optax updates make a state with count 3; the port takes it over
    (``adam_state_from_optax``) and both make a fourth step on the same
    gradients, with a global norm below / above max_grad_norm."""
    je, te = _envs("CarFlag-v0")
    net = jnet.make_actor_critic(je, (16, 16))
    params = _perturbed(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 3))), 1)
    rng = np.random.default_rng(2)

    def grads_like(s):
        return jax.tree.map(lambda x: (s * rng.standard_normal(np.shape(x))).astype(
            np.float32), params)

    cfg_j, cfg_t = JConfig(), PPOConfig()
    tx = jppo._optimizer(cfg_j)
    opt = tx.init(params)
    p = jax.tree.map(jnp.asarray, params)
    for _ in range(3):
        upd, opt = tx.update(grads_like(1.0), opt, p)
        p = jax.tree.map(lambda a, u: a + u, p, upd)
    g = grads_like(scale / 30.0)
    norm = float(np.sqrt(sum(np.sum(np.square(x)) for x in jax.tree.leaves(g))))
    assert (norm < cfg_j.max_grad_norm) == (scale < 1)
    upd, opt2 = tx.update(g, opt, p)
    p2 = jax.tree.map(lambda a, u: a + u, p, upd)

    state = tnet.adam_state_from_optax(jax.tree.map(np.asarray, opt))
    assert int(state.count) == 3
    flat = _flat_flax(jax.tree.map(np.asarray, p))
    tppo.adam_step(flat, state, _flat_flax(jax.tree.map(np.asarray, g)), cfg_t)
    want = tnet.adam_state_from_optax(jax.tree.map(np.asarray, opt2))
    assert int(state.count) == int(want.count) == 4
    np.testing.assert_allclose(_np(state.mu), _np(want.mu), **ADAM_TOL)
    np.testing.assert_allclose(_np(state.nu), _np(want.nu), **ADAM_TOL)
    np.testing.assert_allclose(_np(flat), _np(_flat_flax(jax.tree.map(np.asarray, p2))),
                               **ADAM_TOL)


def test_adam_state_from_optax_layout():
    je = gpt.make("ExtendedHansenTaxi-v4")
    net = jnet.make_actor_critic(je, (8,))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros(1, jnp.int32))
    opt = jppo._optimizer(JConfig()).init(params)
    mu = jax.tree.map(lambda x: np.arange(x.size, dtype=np.float32).reshape(x.shape),
                      params)
    adam = opt[1][0]._replace(count=np.int32(5), mu=mu, nu=mu)
    state = tnet.adam_state_from_optax((opt[0], (adam, opt[1][1])))
    want = tnet.params_from_flax(mu)
    np.testing.assert_array_equal(_np(state.mu),
                                  np.concatenate([_np(w).ravel() for w in want.values()]))
    assert int(state.count) == 5 and state.count.dtype == torch.int32
    with pytest.raises(ValueError):
        tnet.adam_state_from_optax((1, 2))


# ----------------------------------------------------------------- learn
def _jax_rollout(env, net, cfg, ts):
    """The JAX update's rollout with its key splits (gym_po_tpu/agents/
    ppo.py, ``local_update``), jitted; returns the per-step records, the
    final obs and state, and the key the epochs split from."""

    @jax.jit
    def run(params, obs, est, key):
        def env_step(carry, _):
            obs, est, key = carry
            key, ka, ks = jax.random.split(key, 3)
            pi, value = net.apply(params, obs)
            action, logp = jnet.sample_action(pi, ka)
            nobs, nest, rew, done, trunc, info = env.step_vec(ks, est, action)
            _, v_term = net.apply(params, env.observe_vec(info["terminal_state"]))
            fin = (done | trunc).astype(jnp.float32)
            return (nobs, nest, key), (obs, action, logp, value, v_term,
                                       done.astype(jnp.float32),
                                       rew.astype(jnp.float32), 1.0 - fin)

        return jax.lax.scan(env_step, (obs, est, key), None,
                            length=cfg.rollout_steps)

    (obs_f, est_f, key), outs = run(ts.params, ts.env_obs, ts.env_state, ts.key)
    return outs, obs_f, est_f, key


def _jax_orders(cfg, n, key):
    orders = []
    for _ in range(cfg.epochs):
        key, kp = jax.random.split(key)
        if cfg.shuffle == "permute":
            orders.append(torch.as_tensor(np.array(jax.random.permutation(kp, n)),
                                          dtype=torch.int64))
        elif cfg.shuffle == "roll":
            shift = int(jax.random.randint(kp, (), 0, n))
            orders.append(torch.as_tensor(np.roll(np.arange(n), shift)))
        else:
            orders.append(None)
    return orders


LEARN_CASES = [("ExtendedHansenTaxi-v4", s) for s in ("none", "roll", "permute")] \
    + [("CarFlag-v0", "permute")]


@pytest.mark.parametrize("env_id,shuffle", LEARN_CASES)
def test_learn_half_matches_jax_train_step(env_id, shuffle):
    kw = dict(time_limit=6)
    je, te = _envs(env_id, **kw)
    hidden = (32, 32)
    fields = dict(num_envs=16, rollout_steps=8, epochs=2, minibatches=2,
                  hidden=hidden, shuffle=shuffle)
    cfg_j, cfg_t = JConfig(**fields), PPOConfig(**fields)
    net, ts = j_init(je, cfg_j, jax.random.PRNGKey(4))
    ts2, jm = j_step(je, net, cfg_j)(ts)

    outs, obs_f, est_f, key = _jax_rollout(je, net, cfg_j, ts)
    # the rebuild is the update's own rollout
    np.testing.assert_array_equal(np.asarray(obs_f), np.asarray(ts2.env_obs))
    for a, b in zip(jax.tree.leaves(est_f), jax.tree.leaves(ts2.env_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(outs[7]).min() == 0.0  # episodes ended inside it

    ro = Rollout(*(_t(x) for x in outs))
    ro = ro._replace(action=ro.action.long() if ro.action.dtype == torch.int32
                     else ro.action)
    batch = tppo.batch_from_rollout(ro, cfg_t)
    n = cfg_t.num_envs * cfg_t.rollout_steps
    assert batch.obs.shape[0] == n
    # row = t * B + b
    torch.testing.assert_close(batch.value.reshape(cfg_t.rollout_steps, -1), ro.value)

    params_np = jax.tree.map(np.asarray, ts.params)
    model, flat = _port_model(je, te, params_np, hidden)
    opt = tnet.adam_state_from_optax(jax.tree.map(np.asarray, ts.opt_state))
    tm = tppo.learn(model, flat, opt, cfg_t, batch, _jax_orders(cfg_t, n, key))

    want = _flat_flax(jax.tree.map(np.asarray, ts2.params))
    moved = float((want - _flat_flax(params_np)).abs().max())
    assert moved > 1e-4  # the update moved the weights
    np.testing.assert_allclose(_np(flat), _np(want), atol=LEARN_ATOL, rtol=0)
    assert int(opt.count) == cfg_t.epochs * cfg_t.minibatches
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_row_orders():
    n = 40
    for shuffle in ("permute", "roll", "none"):
        cfg = PPOConfig(epochs=3, shuffle=shuffle)
        orders = tppo.row_orders(cfg, n, torch.Generator().manual_seed(1))
        assert len(orders) == 3
        for o in orders:
            if shuffle == "none":
                assert o is None
                continue
            assert torch.equal(torch.sort(o).values, torch.arange(n))
            if shuffle == "roll":
                shift = int(o[0]) and n - int(o[0])
                x = torch.arange(n) * 3
                assert torch.equal(x[o], torch.roll(x, shift))


def test_minibatches_must_divide_the_batch():
    te = gpt_torch.make("Taxi-v4", device="cpu")
    with pytest.raises(ValueError):
        tppo.init_train_state(te, PPOConfig(num_envs=6, rollout_steps=3,
                                            minibatches=4),
                              torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- collect
def test_collect_feeds_terminal_value_and_logp():
    """Port of tests/test_agents.py's rollout check: off a boundary v_term
    is V(obs[t+1]); the stored logp is log_prob recomputed."""
    te = gpt_torch.make("HansenTaxi-v4", time_limit=8, device="cpu")
    cfg = PPOConfig(num_envs=16, rollout_steps=12, epochs=1, minibatches=1,
                    hidden=(16,))
    model, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(0))
    batch, ro, obs_f, _ = tppo.collect(te, model, cfg, ts.env_obs, ts.env_state,
                                       ts.generator)
    T = cfg.rollout_steps
    boundary = ro.cont == 0
    assert boundary.any() and (~boundary).any()
    inner = ~boundary[:-1]
    assert torch.equal(ro.v_term[:-1][inner], ro.value[1:][inner])
    with torch.no_grad():
        pi, value = model(ro.obs.reshape(-1))
        logp = tnet.log_prob(pi, ro.action.reshape(-1))
    torch.testing.assert_close(logp, ro.logp.reshape(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(value, ro.value.reshape(-1), rtol=1e-6, atol=1e-6)
    # truncation bootstraps: the batch's targets use v_term
    adv, target = tppo._gae(ro.reward, ro.value, ro.v_term, ro.done, ro.cont,
                            cfg.gamma, cfg.gae_lambda)
    assert torch.equal(batch.target, target.reshape(-1))
    assert obs_f.shape == (cfg.num_envs,) and ro.obs.shape == (T, cfg.num_envs)


# ----------------------------------------------------------- train steps
def test_train_step_updates_and_is_finite():
    te = gpt_torch.make("Taxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=16, rollout_steps=8, epochs=2, minibatches=2,
                    hidden=(16,))
    model, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(0))
    step = tppo.make_train_step(te, model, cfg)
    before = ts.params.clone()
    ts2, metrics = step(ts)
    assert ts2.update_idx == 1 and step.graph is None
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.allclose(before, ts2.params)
    assert ts2.params is ts.params  # updated in place
    assert int(ts2.opt_state.count) == 4
    assert set(metrics) == {"loss", "pg_loss", "v_loss", "entropy", "mean_reward",
                            "pos_reward_rate", "neg_reward_rate"}


# ---------------------------------------------------------------- spans
def _chrome_spans(path, names):
    """(name, start, end) of the Chrome trace's complete events named in
    ``names``, in time order (microseconds)."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("name") in names),
                  key=lambda x: x[1])


def test_update_trace_holds_the_collect_steps_then_learn(tmp_path):
    """Under trace(), one eager CPU update shows one ppo.collect holding
    its T env.step spans, then one ppo.learn."""
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=16, rollout_steps=6, epochs=1, minibatches=2,
                    hidden=(16,))
    model, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(0))
    step = tppo.make_train_step(te, model, cfg)
    with trace(str(tmp_path)):
        step(ts)
    assert not spans_enabled()
    spans = _chrome_spans(tmp_path / "trace.json", {"ppo.collect", "env.step", "ppo.learn"})
    assert [n for n, _, _ in spans] == ["ppo.collect"] + ["env.step"] * 6 + ["ppo.learn"]
    (_, c0, c1), *steps, (_, l0, _) = spans
    assert all(c0 <= a and b <= c1 for _, a, b in steps) and c1 <= l0


def test_ant_update_trace_holds_its_forwards_in_its_steps(tmp_path, monkeypatch):
    """One eager CPU ant update (RK4, frame_skip 2, T = 2; 2 Newton
    iterations of 2 bisections) under trace() holds T x frame_skip x 4
    ant.forward spans, each inside an env.step; the ant.active_rows
    counter gains the active rows of every forward's constraint rows."""
    from gym_po_tpu_torch.physics import engine

    te = gpt_torch.make("AntTagPhysics-v0", frame_skip=2, solver_iters=2, ls_iters=2,
                        device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_steps=2, epochs=1, minibatches=1,
                    hidden=(8,))
    model, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(0))
    step = tppo.make_train_step(te, model, cfg)
    active = []
    real = engine.constraint_rows

    def constraint_rows(*a, **k):
        rows = real(*a, **k)
        active.append(int((rows.active != 0).sum()))
        return rows
    monkeypatch.setattr(engine, "constraint_rows", constraint_rows)
    before = read_counters().get("ant.active_rows", 0)
    with trace(str(tmp_path)):
        step(ts)
    spans = _chrome_spans(tmp_path / "trace.json", {"env.step", "ant.forward"})
    steps = [(a, b) for n, a, b in spans if n == "env.step"]
    forwards = [(a, b) for n, a, b in spans if n == "ant.forward"]
    assert len(steps) == 2 and len(forwards) == 2 * 2 * 4 == len(active)
    assert all(any(s0 <= a and b <= s1 for s0, s1 in steps) for a, b in forwards)
    assert read_counters()["ant.active_rows"] - before == sum(active) > 0


def test_spans_leave_eager_updates_bit_for_bit():
    """Two eager updates with spans on equal two with spans off: the
    parameters, Adam's state and every metric, bit for bit."""
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=16, rollout_steps=6, epochs=2, minibatches=2,
                    hidden=(16,))
    out = []
    for on in (False, True):
        model, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(0))
        enable_spans(on)
        try:
            ts, metrics = tppo.make_multi_train_step(te, model, cfg, 2)(ts)
        finally:
            enable_spans(False)
        out.append((ts, metrics))
    (a, ma), (b, mb) = out
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.opt_state.count, b.opt_state.count),
                 *((ma[k], mb[k]) for k in tppo.METRIC_NAMES)):
        assert torch.equal(x, y)


def test_train_driver_history_rows(capsys):
    te = gpt_torch.make("Taxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=8, rollout_steps=4, epochs=1, minibatches=1,
                    hidden=(8,))
    model, ts, history = tppo.train(te, cfg, seed=0, num_updates=5, log_every=2)
    assert ts.update_idx == 5
    assert len(history) == 3
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "update 5:" in capsys.readouterr().out
    _, ts0, h0 = tppo.train(te, cfg, seed=0, num_updates=2)
    assert ts0.update_idx == 2 and h0 == []


def test_entry_points_default_to_the_card():
    for fn in (gpt_torch.envs.CarFlag, gpt_torch.envs.DiscreteCarFlag):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    te = gpt_torch.make("Taxi-v4", device="cpu")
    ts_fields = {f.name for f in dataclasses.fields(tppo.TrainState)}
    assert {"model", "opt_state", "env_obs", "env_state", "generator",
            "update_idx"} <= ts_fields
    _, ts = tppo.init_train_state(te, PPOConfig(num_envs=8, rollout_steps=4),
                                  torch.Generator().manual_seed(0))
    assert ts.params.device.type == "cpu"


# -------------------------------------------------------- learning smoke
def test_ppo_learns_carflag_smoke():
    """tests/test_agents.py's reward trend on DiscreteCarFlag, at its size."""
    te = gpt_torch.make("DiscreteCarFlag-v0", num_actions=3, time_limit=60,
                        device="cpu")
    cfg = PPOConfig(num_envs=64, rollout_steps=32, epochs=4, minibatches=4,
                    hidden=(32, 32), learning_rate=1e-3, entropy_coef=0.003)
    model, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(1))
    step = tppo.make_train_step(te, model, cfg)
    rewards = []
    for _ in range(30):
        ts, metrics = step(ts)
        rewards.append(float(metrics["mean_reward"]))
    assert np.mean(rewards[-5:]) > np.mean(rewards[:5]) - 1e-4, rewards


def test_feedforward_ppo_heaven_hell_surrogate():
    """tests/test_memory_learning.py's feedforward run: its surrogate, config,
    50 updates and seed number.  The loop runs, every metric stays finite,
    the rates are shares, and the policy reaches the terminals.

    Its ``p < 1e-3`` (no sustained heaven arrivals without memory) is not
    asserted: it holds by seed, in both packages.  Over seeds 0-15 it held
    for 10 JAX runs and 8 port runs, and 3 JAX and 5 port runs solved the
    surrogate with no memory (p 0.045-0.062, heaven share >= 0.96): a
    memoryless policy can keep the side in its position once it has moved
    away from the priest along the bar.  At seed 1 this run gives
    p = 0.059.
    """
    te = gpt_torch.make("HeavenHellContinuous-v0", agent_speed=0.75,
                        time_limit=150, device="cpu")
    cfg = PPOConfig(num_envs=128, rollout_steps=32, epochs=4, minibatches=4,
                    learning_rate=1e-3, entropy_coef=0.01)
    model, ts = tppo.init_train_state(te, cfg, torch.Generator().manual_seed(1))
    step = tppo.make_train_step(te, model, cfg)
    pos, neg = [], []
    for _ in range(50):
        ts, m = step(ts)
        assert all(np.isfinite(float(v)) for v in m.values()), m
        pos.append(float(m["pos_reward_rate"]))
        neg.append(float(m["neg_reward_rate"]))
    assert all(0.0 <= x <= 1.0 for x in pos + neg)
    assert max(pos) + max(neg) > 0  # terminals reached
