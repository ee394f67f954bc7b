"""Recurrent PPO of the PyTorch port (``gym_po_tpu_torch.agents.ppo_rnn``)
against the JAX package's (``gym_po_tpu.agents.ppo_rnn``), on the CPU.

Weights are carried across by ``rnn_params_from_flax``, Adam's state by
``rnn_adam_state_from_optax``; inputs are made from a seed with numpy.
Tolerances, with the largest error measured:

* one cell step, float32: the hidden state to atol 2e-6 (measured
  5.1e-7) and the heads to atol 1e-6 (measured 2.4e-7): torch's CPU
  ``tanh``/``sigmoid`` and XLA's differ in the last bit, and the matmuls
  sum in other orders;
* one cell step, bfloat16: the hidden state exactly (every product, bias
  add and gate op rounds to bfloat16 where XLA rounds flax's cell, the
  logistic as XLA expands it); the float32 heads on it to atol 1e-6
  (measured 2.4e-7);
* ``_replay`` over T = 12 steps with resets inside the sequences: float32
  to atol 1e-5 (measured 2.1e-7).  In bfloat16 the heads equal flax's
  cell applied step by step to atol 1e-6 (measured 6e-8); against the JAX
  ``_replay`` they hold atol 5e-3 (measured 2.1e-3; one bfloat16 rounding,
  2^-9 relative, of each hidden unit through the heads): inside its
  ``lax.scan`` XLA feeds the float32 heads the GRU's last add before its
  rounding to bfloat16 (excess precision), where a single ``apply`` and
  the port round it first;
* ``_rnn_loss``: loss and terms to rtol 1e-5 (measured 1.2e-7 absolute),
  gradients to atol 5e-7 + rtol 1e-5 (as the feedforward loss test's;
  measured 3.7e-8);
* the learn half of one JAX ``make_rnn_train_step`` update (E = M = 2,
  BPTT over T = 8) from its own rollout, hidden state and env
  permutations: params to atol 5e-7 (the feedforward test's
  ``LEARN_ATOL``; measured 3e-8), the mean loss terms to rtol 1e-5 + atol
  1e-7 (measured 6e-8).

The rollout draws from each package's own generator, so ``collect_rnn`` is
held to its invariants, and the learning smoke test to the JAX test's
criterion at its size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import PPOConfig as JConfig
from gym_po_tpu.agents import networks as jnet
from gym_po_tpu.agents import ppo_rnn as jrnn
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.agents import ppo as tppo
from gym_po_tpu_torch.agents import ppo_rnn as trnn
from gym_po_tpu_torch.agents.ppo import PPOConfig

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
CELL_ATOL_F32 = 2e-6
HEAD_ATOL = 1e-6
REPLAY_ATOL = 1e-5
REPLAY_ATOL_BF16 = 5e-3
GRAD_TOL = dict(atol=5e-7, rtol=1e-5)
LEARN_ATOL = 5e-7


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _np(t):
    return t.detach().float().cpu().numpy()


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _perturbed(params, seed):
    """flax params as numpy, every leaf (zero biases, log_std) moved off its
    initial value."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(
            np.float32), params)


def _random_obs(space, rng, shape):
    if hasattr(space, "n"):
        return rng.integers(0, space.n, shape).astype(np.int32)
    lo, hi = np.asarray(space.low), np.asarray(space.high)
    return rng.uniform(lo, hi, (*shape, *space.shape)).astype(np.float32)


def _random_action(space, rng, shape):
    if hasattr(space, "n"):
        return rng.integers(0, space.n, shape).astype(np.int32)
    return rng.normal(size=(*shape, *space.shape)).astype(np.float32)


def _pair(env_id, hidden, jdt=jnp.float32, tdt=torch.float32, seed=0, **kw):
    """The flax network with perturbed params and the port's holding them."""
    je = gpt.make(env_id, **kw)
    te = gpt_torch.make(env_id, device="cpu", **kw)
    net = jrnn.RecurrentActorCritic(obs_space=je.observation_space,
                                    action_space=je.action_space, hidden=hidden,
                                    compute_dtype=jdt)
    rng = np.random.default_rng(seed)
    obs = _random_obs(je.observation_space, rng, (2,))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, hidden), jdt),
                      jnp.asarray(obs), jnp.zeros(2, bool))
    params = _perturbed(params, seed + 1)
    model = trnn.RecurrentActorCritic(te.observation_space, te.action_space,
                                      hidden, tdt)
    flat = tnet.flatten_parameters(model, trnn.rnn_parameter_list(model))
    model.load_state_dict(trnn.rnn_params_from_flax(params))
    return je, te, net, params, model, flat


def _head(pi):
    return pi["logits"] if pi["kind"] == "categorical" else pi["mean"]


ENVS = ["ExtendedHansenTaxi-v4", "HeavenHellContinuous-v0"]


# ------------------------------------------------------------------- cell
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("env_id", ENVS)
def test_cell_step_matches_flax(env_id, jdt, tdt):
    H, B = 32, 256
    je, te, net, params, model, _ = _pair(env_id, H, jdt, tdt)
    rng = np.random.default_rng(2)
    obs = _random_obs(je.observation_space, rng, (B,))
    h = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    reset = rng.random(B) < 0.3
    hj = jnp.asarray(h).astype(jdt)
    h2j, pij, vj = net.apply(params, hj, jnp.asarray(obs), jnp.asarray(reset))
    with torch.no_grad():
        h2t, pit, vt = model(_t(h).to(tdt), _t(obs), _t(reset))
    assert h2t.dtype == tdt and pit["kind"] == pij["kind"]
    if tdt == torch.float32:
        np.testing.assert_allclose(_np(h2t), _f32(h2j), atol=CELL_ATOL_F32, rtol=0)
    else:
        np.testing.assert_array_equal(_np(h2t), _f32(h2j))
    np.testing.assert_allclose(_np(_head(pit)), np.asarray(_head(pij)),
                               atol=HEAD_ATOL, rtol=0)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=HEAD_ATOL, rtol=0)
    # a reset row starts from a zero hidden state (tests/test_ppo_rnn.py)
    with torch.no_grad():
        h2z, _, _ = model(torch.zeros(B, H, dtype=tdt), _t(obs),
                          torch.zeros(B, dtype=torch.bool))
    assert reset.any() and (~reset).any()
    assert torch.equal(h2t[_t(reset)], h2z[_t(reset)])
    assert not torch.equal(h2t[_t(~reset)], h2z[_t(~reset)])


def test_initial_state_and_init_distributions():
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)
    before = torch.random.get_rng_state()
    m = trnn.RecurrentActorCritic(te.observation_space, te.action_space, 128,
                                  torch.bfloat16, gen)
    assert torch.equal(before, torch.random.get_rng_state())  # global untouched
    h0 = m.initial_state(7)
    assert h0.dtype == torch.bfloat16 and h0.shape == (7, 128) and not h0.any()
    w = m.gru["ir"].weight
    std = np.sqrt(1 / 128) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7  # truncated at 2 sigma
    np.testing.assert_allclose(float(w.std()), np.sqrt(1 / 128), rtol=0.05)
    hr = m.gru["hr"].weight
    torch.testing.assert_close(hr @ hr.t(), torch.eye(128), atol=1e-5, rtol=0)
    assert m.gru["hr"].bias is None and m.gru["hz"].bias is None
    assert not m.gru["hn"].bias.any() and not m.embed.bias.any()
    for p in m.parameters():
        assert p.dtype == torch.float32  # parameters stay float32
    flax_names = {"embed.weight", "embed.bias", "pi_head.weight", "pi_head.bias",
                  "v_head.weight", "v_head.bias"}
    assert flax_names | {f"gru.{g}.weight" for g in trnn.GRU_GATES} <= set(
        dict(m.named_parameters()))


def test_rnn_params_from_flax_matches_by_name():
    je, te, net, params, model, flat = _pair("HeavenHellContinuous-v0", 8)
    p = params["params"]
    assert list(p)[-2:] == ["GRUCell_0", "log_std"]  # flax sorts by name
    sd = trnn.rnn_params_from_flax(params)
    np.testing.assert_array_equal(_np(sd["gru.hn.weight"]),
                                  np.asarray(p["GRUCell_0"]["hn"]["kernel"]).T)
    np.testing.assert_array_equal(_np(sd["v_head.bias"]),
                                  np.asarray(p["Dense_2"]["bias"]))
    named = dict(model.named_parameters())
    assert [id(q) for q in trnn.rnn_parameter_list(model)] == [
        id(named[n]) for n in sd]
    assert flat.numel() == sum(v.numel() for v in sd.values())
    torch.testing.assert_close(flat, torch.cat([v.reshape(-1) for v in sd.values()]))
    for q in trnn.rnn_parameter_list(model):
        assert q.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()


# ----------------------------------------------------------------- replay
def _seq_case(je, rng, T, B, H, jdt):
    obs = _random_obs(je.observation_space, rng, (T, B))
    reset = rng.random((T, B)) < 0.2
    reset[0, 0] = reset[T // 2, 1] = True  # at the start and inside
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    action = _random_action(je.action_space, rng, (T, B))
    return obs, reset, np.asarray(jnp.asarray(h0).astype(jdt).astype(jnp.float32)), action


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("env_id", ENVS)
def test_replay_matches_jax(env_id, jdt, tdt):
    T, B, H = 12, 8, 16
    je, te, net, params, model, _ = _pair(env_id, H, jdt, tdt, seed=3)
    obs, reset, h0, action = _seq_case(je, np.random.default_rng(4), T, B, H, jdt)
    zeros = np.zeros((T, B), np.float32)
    jseq = jrnn._Seq(jnp.asarray(obs), jnp.asarray(action), zeros, zeros,
                     jnp.asarray(reset), zeros, zeros, jnp.asarray(h0).astype(jdt))
    pij, vj = jrnn._replay(net, params, jseq)
    tseq = trnn.Seq(_t(obs), _t(action), _t(zeros), _t(zeros), _t(reset),
                    _t(zeros), _t(zeros), _t(h0).to(tdt))
    with torch.no_grad():
        pit, vt = trnn._replay(model, tseq)
    assert _head(pit).shape == _head(pij).shape and vt.shape == (T, B)
    atol = REPLAY_ATOL if tdt == torch.float32 else REPLAY_ATOL_BF16
    np.testing.assert_allclose(_np(_head(pit)), np.asarray(_head(pij)),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=atol, rtol=0)
    # step by step, flax's cell gives the port's replay
    h = jseq.h0
    for t in range(T):
        h, pi, v = net.apply(params, h, jseq.obs[t], jseq.reset[t])
        np.testing.assert_allclose(_np(_head(pit)[t]), np.asarray(_head(pi)),
                                   atol=REPLAY_ATOL if tdt == torch.float32
                                   else HEAD_ATOL, rtol=0)
    if pit["kind"] == "gaussian":
        assert pit["log_std"].shape == (2,)
        np.testing.assert_array_equal(_np(pit["log_std"]), np.asarray(pij["log_std"]))
    # the resets matter: without them the replay differs
    with torch.no_grad():
        _, v_no = trnn._replay(model, tseq._replace(reset=torch.zeros_like(tseq.reset)))
    assert not torch.equal(v_no, vt)


# ------------------------------------------------------------------- loss
def _loss_case(env_id, seed, T=8, B=16, H=16):
    je, te, net, params, model, _ = _pair(env_id, H, seed=seed)
    rng = np.random.default_rng(seed)
    obs, reset, h0, action = _seq_case(je, rng, T, B, H, jnp.float32)
    jseq0 = jrnn._Seq(jnp.asarray(obs), jnp.asarray(action), 0, 0,
                      jnp.asarray(reset), 0, 0, jnp.asarray(h0))
    pi, value = jrnn._replay(net, params, jseq0)
    # old log-probs near the current ones, so some ratios clip and some not
    logp = (np.asarray(jnet.log_prob(pi, jnp.asarray(action)))
            + rng.normal(0, 0.3, (T, B))).astype(np.float32)
    old_value = (np.asarray(value) + rng.normal(0, 0.3, (T, B))).astype(np.float32)
    adv = rng.normal(1.0, 2.0, (T, B)).astype(np.float32)
    target = (old_value + rng.normal(0, 0.5, (T, B))).astype(np.float32)
    cols = (obs, action, logp, old_value, reset, adv, target, h0)
    return net, params, model, cols


@pytest.mark.parametrize("env_id", ENVS)
def test_rnn_loss_and_gradients_match_jax(env_id):
    net, params, model, cols = _loss_case(env_id, 5)
    (jl, jaux), jg = jax.value_and_grad(jrnn._rnn_loss, has_aux=True)(
        params, net, jrnn._Seq(*map(jnp.asarray, cols)), JConfig())
    tl, taux = trnn._rnn_loss(model, trnn.Seq(*map(_t, cols)), PPOConfig())
    tg = torch.autograd.grad(tl, trnn.rnn_parameter_list(model))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    want = trnn.rnn_params_from_flax(jax.tree.map(np.asarray, jg))
    assert len(want) == len(tg)
    for (name, w), g in zip(want.items(), tg):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **GRAD_TOL)
    assert float(max(w.abs().max() for w in want.values())) > 1e-3
    # the advantage is normalised over the whole [T, mb] block, population std
    pi, _ = trnn._replay(model, trnn.Seq(*map(_t, cols)))
    ratio = np.exp(_np(tnet.log_prob(pi, _t(cols[1]))) - cols[2])
    assert ((ratio > 1.2) | (ratio < 0.8)).any() and (abs(ratio - 1) < 0.2).any()


# ------------------------------------------------------------ learn half
def _jax_rnn_rollout(env, net, cfg, ts):
    """The JAX update's rollout with its key splits (gym_po_tpu/agents/
    ppo_rnn.py, ``local_update``), jitted."""

    @jax.jit
    def run(params, obs, est, h, prev_reset, key):
        def env_step(carry, _):
            obs, est, h, prev_reset, key = carry
            key, ka, ks = jax.random.split(key, 3)
            h2, pi, value = net.apply(params, h, obs, prev_reset)
            action, logp = jnet.sample_action(pi, ka)
            nobs, nest, rew, done, trunc, info = env.step_vec(ks, est, action)
            _, _, v_term = net.apply(params, h2,
                                     env.observe_vec(info["terminal_state"]),
                                     jnp.zeros_like(done))
            fin = done | trunc
            return (nobs, nest, h2, fin, key), (
                obs, action, logp, value, v_term, prev_reset,
                done.astype(jnp.float32), rew.astype(jnp.float32),
                1.0 - fin.astype(jnp.float32))

        return jax.lax.scan(env_step, (obs, est, h, prev_reset, key), None,
                            length=cfg.rollout_steps)

    return run(ts.params, ts.env_obs, ts.env_state, ts.hidden, ts.prev_reset,
               ts.key)


@pytest.mark.parametrize("env_id", ENVS)
def test_learn_half_matches_jax_train_step(env_id):
    """The second JAX update (its hidden state carried from the first)
    against ``learn_rnn`` on the JAX rollout and permutations."""
    je, te = gpt.make(env_id, time_limit=3), gpt_torch.make(env_id, time_limit=3,
                                                           device="cpu")
    H = 16
    fields = dict(num_envs=16, rollout_steps=8, epochs=2, minibatches=2)
    cfg_j, cfg_t = JConfig(**fields), PPOConfig(**fields)
    net, ts0 = jrnn.init_rnn_state(je, cfg_j, jax.random.PRNGKey(6), hidden=H)
    jstep = jrnn.make_rnn_train_step(je, net, cfg_j)
    ts, _ = jstep(ts0)
    # episodes truncate together at the time limit: give half the envs a
    # reset flag, so the carried hidden state enters the other half
    ts = ts.replace(prev_reset=jnp.arange(16) % 2 == 0)
    ts2, jm = jstep(ts)

    (obs_f, est_f, h_f, reset_f, key), outs = _jax_rnn_rollout(je, net, cfg_j, ts)
    # the rebuild is the update's own rollout
    np.testing.assert_array_equal(np.asarray(obs_f), np.asarray(ts2.env_obs))
    np.testing.assert_array_equal(np.asarray(reset_f), np.asarray(ts2.prev_reset))
    np.testing.assert_allclose(np.asarray(h_f), np.asarray(ts2.hidden), atol=1e-6)
    assert np.asarray(ts.prev_reset).any() and np.abs(np.asarray(ts.hidden)).max() > 0.1
    obs, action, logp, value, v_term, reset, done, rew, cont = map(_t, outs)
    assert cont.min() == 0.0 and reset[1:].any()  # episodes end inside it
    adv, target = tppo._gae(rew, value, v_term, done, cont, cfg_t.gamma,
                            cfg_t.gae_lambda)
    if action.dtype == torch.int32:
        action = action.long()
    seq = trnn.Seq(obs, action, logp, value, reset, adv, target, _t(ts.hidden))

    orders = []
    for _ in range(cfg_j.epochs):
        key, kp = jax.random.split(key)
        orders.append(torch.as_tensor(np.array(jax.random.permutation(kp, 16)),
                                      dtype=torch.int64))
    params_np = jax.tree.map(np.asarray, ts.params)
    model = trnn.RecurrentActorCritic(te.observation_space, te.action_space, H)
    flat = tnet.flatten_parameters(model, trnn.rnn_parameter_list(model))
    model.load_state_dict(trnn.rnn_params_from_flax(params_np))
    opt = trnn.rnn_adam_state_from_optax(jax.tree.map(np.asarray, ts.opt_state))
    assert int(opt.count) == 4
    tm = trnn.learn_rnn(model, flat, opt, cfg_t, seq, orders)

    def flat_of(tree):
        return torch.cat([t.reshape(-1) for t in trnn.rnn_params_from_flax(
            jax.tree.map(np.asarray, tree)).values()])

    want = flat_of(ts2.params)
    assert float((want - flat_of(ts.params)).abs().max()) > 1e-4  # it moved
    np.testing.assert_allclose(_np(flat), _np(want), atol=LEARN_ATOL, rtol=0)
    assert int(opt.count) == 8
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_env_orders_permute_the_env_axis():
    cfg = PPOConfig(epochs=3, shuffle="none")  # shuffle is not read
    orders = trnn.env_orders(cfg, 10, torch.Generator().manual_seed(0))
    assert len(orders) == 3
    for o in orders:
        assert torch.equal(torch.sort(o).values, torch.arange(10))
    seq = trnn.Seq(*(torch.arange(30).reshape(3, 10) for _ in range(7)),
                   torch.arange(10)[:, None].expand(10, 4))
    picked = trnn._pick_envs(seq, orders[0])
    assert torch.equal(picked.obs[2], seq.obs[2][orders[0]])
    assert torch.equal(picked.h0[:, 0], orders[0])


# ---------------------------------------------------------------- collect
def test_collect_rnn_carries_hidden_resets_and_terminal_values():
    te = gpt_torch.make("HansenTaxi-v4", time_limit=5, device="cpu")
    cfg = PPOConfig(num_envs=16, rollout_steps=12, epochs=1, minibatches=1)
    model, ts = trnn.init_rnn_state(te, cfg, torch.Generator().manual_seed(0),
                                    hidden=16)
    ts.prev_reset[:3] = True
    ts.hidden.normal_(generator=torch.Generator().manual_seed(1))
    seq, ro, obs_f, state_f, h_f, reset_f = trnn.collect_rnn(
        te, model, cfg, ts.env_obs, ts.env_state, ts.generator, ts.hidden,
        ts.prev_reset)
    T, B = cfg.rollout_steps, cfg.num_envs
    assert seq.h0 is ts.hidden and seq.obs.shape == (T, B)
    # each step's reset flag is the previous step's done | truncated
    assert torch.equal(ro.reset[0], ts.prev_reset)
    assert torch.equal(ro.reset[1:], ro.cont[:-1] == 0)
    assert torch.equal(reset_f, ro.cont[-1] == 0)
    boundary = ro.cont == 0
    assert boundary.any() and (~boundary).any()
    # off a boundary v_term is the next step's value (same hidden, same obs)
    inner = ~boundary[:-1]
    assert torch.equal(ro.v_term[:-1][inner], ro.value[1:][inner])
    # replaying the stored sequence gives the final hidden, the values and
    # the log-probs
    h, logps, values = ts.hidden, [], []
    with torch.no_grad():
        for t in range(T):
            h, pi, v = model(h, ro.obs[t], ro.reset[t])
            logps.append(tnet.log_prob(pi, ro.action[t]))
            values.append(v)
    assert torch.equal(h, h_f)
    torch.testing.assert_close(torch.stack(values), ro.value, rtol=0, atol=0)
    torch.testing.assert_close(torch.stack(logps), ro.logp, rtol=1e-6, atol=1e-6)
    adv, target = tppo._gae(ro.reward, ro.value, ro.v_term, ro.done, ro.cont,
                            cfg.gamma, cfg.gae_lambda)
    assert torch.equal(seq.advantage, adv) and torch.equal(seq.target, target)
    assert obs_f.shape == (B,) and state_f.s.shape == (B,)


# -------------------------------------------------------------- the step
def test_train_step_updates_in_place():
    te = gpt_torch.make("HansenTaxi-v4", device="cpu")
    cfg = PPOConfig(num_envs=16, rollout_steps=8, epochs=2, minibatches=2)
    model, ts = trnn.init_rnn_state(te, cfg, torch.Generator().manual_seed(0),
                                    hidden=16)
    step = trnn.make_rnn_train_step(te, model, cfg)
    before = ts.params.clone()
    ts2, m = step(ts)
    assert ts2.update_idx == 1 and step.graph is None and step.events is None
    assert ts2.params is ts.params and not torch.equal(before, ts2.params)
    assert int(ts2.opt_state.count) == 4
    assert torch.isfinite(ts2.hidden).all() and ts2.hidden.abs().max() > 0
    assert set(m) == {"loss", "pg_loss", "v_loss", "entropy", "mean_reward",
                      "pos_reward_rate", "neg_reward_rate"}
    assert all(torch.isfinite(v) for v in m.values())


def test_bf16_train_step_is_finite_and_carries_bf16():
    te = gpt_torch.make("HeavenHellContinuous-v0", time_limit=10, device="cpu")
    cfg = PPOConfig(num_envs=8, rollout_steps=6, epochs=1, minibatches=2,
                    compute_dtype=torch.bfloat16)
    model, ts = trnn.init_rnn_state(te, cfg, torch.Generator().manual_seed(0),
                                    hidden=8)
    assert ts.hidden.dtype == torch.bfloat16 and ts.params.dtype == torch.float32
    ts2, m = trnn.make_rnn_train_step(te, model, cfg)(ts)
    assert ts2.hidden.dtype == torch.bfloat16
    assert all(torch.isfinite(v) for v in m.values()), m


def test_guards():
    te = gpt_torch.make("Taxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="minibatches"):
        trnn.init_rnn_state(te, PPOConfig(num_envs=6, minibatches=4), gen)
    with pytest.raises(ValueError, match="minibatches"):
        trnn.make_rnn_train_step(te, None, PPOConfig(num_envs=6, minibatches=4))
    # a mesh and several devices are taken; their ranks must split the batch
    from gym_po_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="divisible"):
        trnn.make_rnn_train_step(te, None, PPOConfig(),
                                 mesh=Mesh(None, 0, 3, torch.device("cpu"), dims=(3,)))
    with pytest.raises(ValueError, match="divisible"):
        trnn.init_rnn_state(te, PPOConfig(num_envs=8, minibatches=2), gen,
                            num_devices=3)
    _, ts = trnn.init_rnn_state(te, PPOConfig(num_envs=8, minibatches=2), gen,
                                hidden=4, num_devices=2)
    assert ts.hidden.shape == (4, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trnn.init_rnn_state(te, PPOConfig(num_envs=8, minibatches=2,
                                          compute_dtype=torch.float16), gen)
    # config.hidden is not read: the GRU's width is init_rnn_state's argument
    model, ts = trnn.init_rnn_state(
        te, PPOConfig(num_envs=8, minibatches=2, hidden=(4, 4)), gen)
    assert model.hidden == 128 and ts.hidden.shape == (8, 128)


# ---------------------------------------------------------------- learning
def test_rnn_learns_carflag_smoke():
    """tests/test_ppo_rnn.py's DiscreteCarFlag reward trend, at its size,
    config and seed number."""
    te = gpt_torch.make("DiscreteCarFlag-v0", num_actions=3, time_limit=60,
                        device="cpu")
    cfg = PPOConfig(num_envs=64, rollout_steps=32, epochs=4, minibatches=4,
                    learning_rate=1e-3, entropy_coef=0.003)
    model, ts = trnn.init_rnn_state(te, cfg, torch.Generator().manual_seed(1),
                                    hidden=32)
    step = trnn.make_rnn_train_step(te, model, cfg)
    rewards = []
    for _ in range(25):
        ts, m = step(ts)
        rewards.append(float(m["mean_reward"]))
    assert np.mean(rewards[-5:]) > np.mean(rewards[:5]) - 1e-4, rewards
