"""ActorCritic of the PyTorch port against the JAX package's flax model,
with the flax weights carried across by ``params_from_flax``.

Tolerance: atol = rtol = 1e-5 on f32 outputs.  The two frameworks sum the
matmuls in different orders and use different tanh/exp/log code, so last-
bit differences are expected; a wrong weight layout or head would be off by
orders of magnitude more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.agents import networks as jnet
from gym_po_tpu.core import Box as JBox
from gym_po_tpu_torch.agents import networks as tnet
from gym_po_tpu_torch.core import Box as TBox

TOL = dict(atol=1e-5, rtol=1e-5)


def _perturbed(params, seed):
    """flax params as numpy, with every leaf (zero biases and log_std
    included) moved off its initial value, the same for both packages."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(
            np.float32), params)


def _both(obs_j, act_j, obs_t, act_t, hidden, seed):
    net = jnet.ActorCritic(obs_space=obs_j, action_space=act_j, hidden=hidden)
    sample = jnp.zeros((1, *obs_j.shape),
                       jnp.float32 if isinstance(obs_j, JBox) else jnp.int32)
    params = _perturbed(net.init(jax.random.PRNGKey(seed), sample), seed)
    model = tnet.ActorCritic(obs_t, act_t, hidden)
    model.load_state_dict(tnet.params_from_flax(params))
    return net, params, model


def _close(j, t, what):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), err_msg=what, **TOL)


@pytest.mark.parametrize("hidden", [(64, 64), (32,)])
def test_discrete_actor_critic_matches_flax(hidden):
    je = gpt.make("ExtendedHansenTaxi-v4")
    te = gpt_torch.make("ExtendedHansenTaxi-v4")
    net, params, model = _both(je.observation_space, je.action_space,
                               te.observation_space, te.action_space, hidden, 0)
    rng = np.random.default_rng(1)
    obs = rng.integers(0, je.observation_space.n, 512).astype(np.int32)
    pi_j, v_j = net.apply(params, jnp.asarray(obs))
    pi_t, v_t = model(torch.as_tensor(obs))
    assert pi_t["kind"] == "categorical" and v_t.shape == (512,)
    _close(pi_j["logits"], pi_t["logits"], "logits")
    _close(v_j, v_t, "value")
    a = rng.integers(0, 5, 512).astype(np.int32)
    _close(jnet.log_prob(pi_j, jnp.asarray(a)), tnet.log_prob(pi_t, torch.as_tensor(a)),
           "log_prob")
    _close(jnet.entropy(pi_j), tnet.entropy(pi_t), "entropy")
    # the indexed first layer equals one-hot x matmul exactly
    first = model.torso[0]
    onehot = tnet.encode_obs(te.observation_space, torch.as_tensor(obs))
    assert torch.equal(first.weight.t()[torch.as_tensor(obs).long()],
                       onehot @ first.weight.t())


def test_gaussian_actor_critic_matches_flax():
    net, params, model = _both(JBox(-1.0, 1.0, (6,)), JBox(-1.0, 1.0, (2,)),
                               TBox(-1.0, 1.0, (6,)), TBox(-1.0, 1.0, (2,)),
                               (16, 16), 2)
    rng = np.random.default_rng(3)
    obs = rng.uniform(-1, 1, (128, 6)).astype(np.float32)
    pi_j, v_j = net.apply(params, jnp.asarray(obs))
    pi_t, v_t = model(torch.as_tensor(obs))
    assert pi_t["kind"] == "gaussian"
    _close(pi_j["mean"], pi_t["mean"], "mean")
    _close(pi_j["log_std"], pi_t["log_std"], "log_std")
    _close(v_j, v_t, "value")
    a = rng.standard_normal((128, 2)).astype(np.float32)
    _close(jnet.log_prob(pi_j, jnp.asarray(a)), tnet.log_prob(pi_t, torch.as_tensor(a)),
           "log_prob")
    _close(jnet.entropy(pi_j), tnet.entropy(pi_t), "entropy")


def test_sample_action_and_init():
    te = gpt_torch.make("HansenTaxi-v4")
    torch.manual_seed(0)
    model = tnet.make_actor_critic(te, (64, 64))
    # orthogonal init with the JAX package's gains; zero biases
    w = model.torso[1].weight.detach()
    torch.testing.assert_close(w @ w.t(), 2.0 * torch.eye(64), atol=1e-4, rtol=0)
    assert (model.v_head.bias == 0).all()
    obs = torch.arange(256) % te.observation_space.n
    pi, _ = model(obs)
    gen = torch.Generator().manual_seed(1)
    a, logp = tnet.sample_action(pi, gen)
    assert a.shape == (256,) and ((a >= 0) & (a < 5)).all()
    torch.testing.assert_close(logp, tnet.log_prob(pi, a))
    # Gumbel-max samples the softmax distribution
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0, 0.5]]).expand(40_000, 5)
    a, _ = tnet.sample_action({"kind": "categorical", "logits": logits}, gen)
    freq = torch.bincount(a, minlength=5).double() / a.numel()
    torch.testing.assert_close(freq, torch.softmax(logits[0].double(), -1),
                               atol=0.01, rtol=0)
