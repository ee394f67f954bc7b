"""The ported slice as a whole: the acting step on ``ExtendedHansenTaxi-v4``
(ActorCritic 64x64 forward, action, env step), 8 steps at B=256, against
the JAX package with the same weights, the same numpy actions and the same
stage draws.  Obs, state and reward must be exactly equal; value and logp
within 1e-5 (f32 matmul and transcendental differences, see
test_torch_networks.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import networks as jnet
from gym_po_tpu.envs.taxi import TaxiState as JTaxiState
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.entry import ENV_ID, entry
from gym_po_tpu_torch.envs.taxi import TaxiState as TTaxiState

B, STEPS = 256, 8


def _step(env, state, a, p, d0, s_new):
    """``step_vec`` with its draws given: the stages it composes."""
    mid, rew, done, trunc, task = env.advance(state, a)
    mid = env.apply_task_reset(mid, task, p, d0 + (d0 >= p))
    nxt = env.apply_full_reset(mid, done | trunc, s_new)
    return env.observe(nxt), nxt, rew


def test_acting_slice_matches_jax():
    je, te = gpt.make(ENV_ID, time_limit=5), gpt_torch.make(ENV_ID, time_limit=5)
    net = jnet.make_actor_critic(je, (64, 64))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    model = tnet.make_actor_critic(te, (64, 64))
    model.load_state_dict(tnet.params_from_flax(params))

    rng = np.random.default_rng(0)
    valid, nlocs = je.tables.valid_init, je.nlocs
    s0 = rng.choice(valid, B).astype(np.int32)
    z = np.zeros(B, np.int32)
    jst = JTaxiState(elapsed=jnp.asarray(z), s=jnp.asarray(s0), completed=jnp.asarray(z))
    tst = TTaxiState(elapsed=torch.as_tensor(z), s=torch.as_tensor(s0),
                     completed=torch.as_tensor(z))
    jobs, tobs = je.observe(jst), te.observe(tst)
    jstep = jax.jit(lambda *a: _step(je, *a))
    resets = 0
    for _ in range(STEPS):
        pi_j, v_j = net.apply(params, jobs)
        with torch.no_grad():
            pi_t, v_t = model(tobs)
        a = rng.integers(0, 5, B).astype(np.int32)
        lp_j = jnet.log_prob(pi_j, jnp.asarray(a))
        lp_t = tnet.log_prob(pi_t, torch.as_tensor(a))
        np.testing.assert_allclose(np.asarray(v_j), v_t.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(lp_j), lp_t.numpy(), atol=1e-5, rtol=1e-5)
        draws = (a, rng.integers(0, nlocs, B).astype(np.int32),
                 rng.integers(0, nlocs - 1, B).astype(np.int32),
                 rng.choice(valid, B).astype(np.int32))
        jobs, jst, jr = jstep(jst, *map(jnp.asarray, draws))
        tobs, tst, tr = _step(te, tst, *map(torch.as_tensor, draws))
        np.testing.assert_array_equal(np.asarray(jobs), tobs.numpy())
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        for f in ("s", "elapsed", "completed"):
            np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                          getattr(tst, f).numpy())
        resets += int((tst.elapsed == 0).sum())
    assert resets >= B  # time_limit=5: every env reset within 8 steps


def test_entry_forward_runs_and_is_deterministic():
    outs = []
    for _ in range(2):
        forward, (model, gen, obs, state) = entry(num_envs=B, seed=3)
        n_obs = model.obs_space.n
        for _ in range(STEPS):
            prev_obs = obs
            obs, state, rew, value, logp = forward(model, gen, obs, state)
            with torch.no_grad():
                pi, v = model(prev_obs)
            assert torch.equal(value, v)
            # logp is the log-softmax of some action
            lsm = torch.log_softmax(pi["logits"], -1)
            assert ((lsm - logp[:, None]).abs().min(-1).values == 0).all()
            assert torch.isfinite(value).all() and torch.isfinite(logp).all()
            assert ((obs >= 0) & (obs < n_obs)).all()
            assert np.isin(rew.numpy(), np.float32([1.0, -0.5, -0.05])).all()
        outs.append((obs, state.s, value))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
