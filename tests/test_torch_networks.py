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
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
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
    te = gpt_torch.make("HansenTaxi-v4", device="cpu")
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


BF16_TOL = dict(atol=1e-6, rtol=0)


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "gaussian"])
def test_bf16_actor_critic_matches_flax(discrete):
    """``compute_dtype=bfloat16`` against flax's: the torso rounds to
    bfloat16 where XLA rounds flax's ``Dense(dtype=bfloat16)`` (the product,
    then the bias add, then ``tanh``), so the float32 heads see the same
    torso output and agree to atol 1e-6 (measured 2.4e-7); both are 2e-3 or
    more away from the float32 network on the same weights."""
    if discrete:
        je = gpt.make("ExtendedHansenTaxi-v4")
        te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
        spaces = (je.observation_space, je.action_space, te.observation_space,
                  te.action_space)
        obs = np.random.default_rng(1).integers(0, je.observation_space.n,
                                                512).astype(np.int32)
    else:
        spaces = (JBox(-1.0, 1.0, (6,)), JBox(-1.0, 1.0, (2,)),
                  TBox(-1.0, 1.0, (6,)), TBox(-1.0, 1.0, (2,)))
        obs = np.random.default_rng(3).uniform(-1, 1, (512, 6)).astype(np.float32)
    net = jnet.ActorCritic(obs_space=spaces[0], action_space=spaces[1],
                           hidden=(64, 64), compute_dtype=jnp.bfloat16)
    params = _perturbed(net.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1])), 0)
    model = tnet.make_actor_critic(
        type("E", (), {"observation_space": spaces[2], "action_space": spaces[3]}),
        (64, 64), compute_dtype=torch.bfloat16)
    model.load_state_dict(tnet.params_from_flax(params))
    pi_j, v_j = net.apply(params, jnp.asarray(obs))
    pi_t, v_t = model(torch.as_tensor(obs))
    key = "logits" if discrete else "mean"
    assert pi_t[key].dtype == v_t.dtype == torch.float32
    np.testing.assert_allclose(pi_t[key].detach().numpy(), np.asarray(pi_j[key]),
                               **BF16_TOL)
    np.testing.assert_allclose(v_t.detach().numpy(), np.asarray(v_j), **BF16_TOL)
    for p in model.parameters():
        assert p.dtype == torch.float32
    model32 = tnet.ActorCritic(spaces[2], spaces[3], (64, 64))
    model32.load_state_dict(tnet.params_from_flax(params))
    _, v32 = model32(torch.as_tensor(obs))
    assert float((v32 - v_t).abs().max()) > 2e-3


def test_f32_forward_is_the_plain_layers():
    """The float32 path is ``Linear`` + ``tanh`` with the first layer an
    index, bit for bit: the dtype casts are no-ops there."""
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    model = tnet.make_actor_critic(te, (32, 32),
                                   torch.Generator().manual_seed(0))
    obs = torch.arange(300) % te.observation_space.n
    first = model.torso[0]
    x = torch.tanh(first.weight.t()[obs] + first.bias)
    x = torch.tanh(model.torso[1](x))
    pi, v = model(obs)
    assert torch.equal(pi["logits"], model.pi_head(x))
    assert torch.equal(v, model.v_head(x).squeeze(-1))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tnet.ActorCritic(te.observation_space, te.action_space,
                         compute_dtype=torch.float16)


# ------------------------------------------- the discrete first layer's backward
@pytest.fixture
def one_thread():
    """Autograd's CPU index backward adds in parallel, in an order that
    changes from run to run; on one thread it adds in row order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _embed_inputs(dtype, law, shape, n=320, H=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    layer = torch.nn.Linear(n, H)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(H, n, generator=gen))
        layer.bias.copy_(torch.randn(H, generator=gen))
    obs = (torch.randint(0, n, shape, generator=gen, dtype=torch.int32)
           if law == "random" else torch.full(shape, 7, dtype=torch.int32))
    return layer, obs, torch.randn(*shape, H, generator=gen).to(dtype)


@pytest.mark.parametrize("shape", [(512,), (12, 40)], ids=["flat", "sequence"])
@pytest.mark.parametrize("law", ["random", "equal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_embed_discrete_gradients_equal_the_index_expression(one_thread, dtype, law,
                                                             shape):
    """``embed_discrete`` (its backward the twin on the CPU) against the
    index expression it replaced, ``weight.to(dt).t()[obs] + bias.to(dt)``
    under autograd: the forward bit for bit; in float32 the weight's and
    the bias's gradients bit for bit.  In bfloat16 the bias's gradient bit
    for bit; the weight's is the float32 sum rounded once, within half a
    bfloat16 ulp (2^-8 relative) of the exact sum, where the expression's
    index backward rounds to bfloat16 after every row (here up to 35x off
    where a sum cancels)."""
    layer, obs, up = _embed_inputs(dtype, law, shape)
    w = layer.weight.detach().clone().requires_grad_()
    b = layer.bias.detach().clone().requires_grad_()
    old = w.to(dtype).t()[obs.long()] + b.to(dtype)
    old.backward(up)
    new = tnet.embed_discrete(layer, obs, dtype)
    new.backward(up)
    assert new.dtype == dtype and torch.equal(new, old)
    assert layer.weight.grad.shape == w.shape and torch.equal(layer.bias.grad, b.grad)
    if dtype == torch.float32:
        assert torch.equal(layer.weight.grad, w.grad)
    else:
        exact = torch.zeros(320, 64, dtype=torch.float64).index_add_(
            0, obs.reshape(-1).long(), up.reshape(-1, 64).double()).t()
        assert ((layer.weight.grad.double() - exact).abs()
                <= 2.0 ** -8 * exact.abs()).all()


@pytest.mark.parametrize("law", ["random", "equal"])
def test_embed_discrete_bf16_weight_gradient_equals_flax_one_hot(law):
    """In bfloat16 the weight's gradient equals the JAX package's first
    layer's (flax's ``Dense(dtype=bfloat16)`` on the one-hot observation)
    bit for bit."""
    import flax.linen as fnn

    layer, obs, up = _embed_inputs(torch.bfloat16, law, (2048,))
    dense = fnn.Dense(64, dtype=jnp.bfloat16)
    params = {"params": {"kernel": layer.weight.detach().t().numpy(),
                         "bias": layer.bias.detach().numpy()}}
    one_hot = jax.nn.one_hot(obs.numpy(), 320, dtype=jnp.bfloat16)
    _, vjp = jax.vjp(lambda p: dense.apply(p, one_hot), params)
    (grads,) = vjp(jnp.asarray(up.float().numpy()).astype(jnp.bfloat16))
    tnet.embed_discrete(layer, obs, torch.bfloat16).backward(up)
    np.testing.assert_array_equal(layer.weight.grad.t().numpy(),
                                  np.asarray(grads["params"]["kernel"]))


def test_actor_critic_and_gru_embed_go_through_embed_grad(monkeypatch):
    """The discrete ``ActorCritic``'s first layer and the recurrent model's
    embed take their gradients from ``embed_grad``, once a backward; a Box
    observation's first layer does not."""
    from gym_po_tpu_torch.agents import ppo_rnn as trnn
    from gym_po_tpu_torch.ops.embed import embed_grad_twin

    calls = []

    def spy(grad, idx, n):
        calls.append((tuple(grad.shape), n))
        return embed_grad_twin(grad, idx, n)

    monkeypatch.setattr(tnet, "embed_grad", spy)
    te = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    n = te.observation_space.n
    obs = torch.arange(300) % n
    model = tnet.make_actor_critic(te, (32, 32), torch.Generator().manual_seed(0))
    pi, v = model(obs)
    (pi["logits"].sum() + v.sum()).backward()
    assert calls == [((300, 32), n)]
    rnn = trnn.RecurrentActorCritic(te.observation_space, te.action_space, 16,
                                    torch.float32, torch.Generator().manual_seed(0))
    w_i, b_i, _, _ = rnn.gate_weights()
    rnn.inputs(obs.reshape(12, 25), w_i, b_i).sum().backward()
    assert calls[1:] == [((12, 25, 16), n)] and rnn.embed.weight.grad is not None
    box = tnet.ActorCritic(TBox(-1.0, 1.0, (6,)), te.action_space, (16,))
    box(torch.zeros(5, 6))[1].sum().backward()
    assert len(calls) == 2
