"""Potential-based shaping in the PyTorch port (``envs/shaping.py``) against
the JAX package's (``gym_po_tpu.envs.shaping``), on identical point-mass
states.

The wrapper must add exactly F = γΦ(s_mid)·(1−done) − Φ(s_prev) to the raw
reward (s_mid the pre-reset successor) and pass everything else through:
the shaped rewards equal the JAX wrapper's exactly when fed the JAX raw
step's outputs.  The potentials equal the JAX potentials exactly on the
same states (the tag distance's square root is correctly rounded in both).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs import shaping as jshape
from gym_po_tpu.envs.tag_jax import HeavenHellState as JHState, TagState as JTState
from gym_po_tpu_torch.envs import shaping as tshape
from gym_po_tpu_torch.envs.tag import HeavenHellState as THState, TagState as TTState


def _t(x):
    return torch.as_tensor(np.array(x))


def _hh(js):
    return THState(elapsed=_t(js.elapsed), agent_xy=_t(js.agent_xy),
                   heaven_right=_t(js.heaven_right))


@pytest.mark.parametrize("gamma", [0.99, 1.0])
def test_shaped_reward_is_raw_plus_exact_pbrs_term(gamma):
    """tests/test_shaping.py's first case: the port's wrapper, given the JAX
    raw step's outputs, gives the JAX wrapper's shaped reward."""
    jraw = gpt.make("HeavenHellContinuous-v0")
    traw = gpt_torch.make("HeavenHellContinuous-v0", device="cpu")
    jenv = jshape.PotentialShaped(jraw, jshape.heaven_hell_potential(0.1), gamma)
    tenv = tshape.PotentialShaped(traw, tshape.heaven_hell_potential(0.1), gamma)
    B = 64
    key = jax.random.PRNGKey(0)
    _, js = jenv.reset_vec(jax.random.PRNGKey(1), B)
    xy = np.asarray(js.agent_xy).copy()
    xy[:16] = [[4.0, 6.0], [-4.0, 6.0]] * 8  # a step or two from heaven or hell
    js = js.replace(agent_xy=jnp.asarray(xy))
    arrivals = 0
    for t in range(60):
        key, ka, ks = jax.random.split(key, 3)
        a = jax.random.uniform(ka, (B, 2), jnp.float32, -1, 1)
        ro, rstate, rrew, rdone, rtr, rinfo = jraw.step_vec(ks, js, a)
        so, sstate, srew, sdone, strr, _ = jenv.step_vec(ks, js, a)
        out = (_t(ro), _hh(rstate), _t(rrew), _t(rdone), _t(rtr),
               {"terminal_state": _hh(rinfo["terminal_state"])})
        tobs, _, trew, tdone, _, _ = tenv._shape(_hh(js), out)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(srew),
                                      err_msg=f"t={t}")
        assert torch.equal(tobs, _t(so)) and torch.equal(tdone, _t(sdone))
        arrivals += int(np.asarray(rdone).sum())
        js = sstate
    assert arrivals > 0  # the (1 - done) factor was exercised
    assert tenv.observation_space.shape == traw.observation_space.shape
    assert tenv.action_space.shape == traw.action_space.shape


def test_port_wrapper_step_vec_adds_the_term_to_its_raw_step():
    raw = gpt_torch.make("TagContinuous-v0", device="cpu")
    phi = tshape.tag_potential(0.2)
    env = tshape.PotentialShaped(raw, phi, gamma=0.99)
    B = 128
    _, state = env.reset_vec(torch.Generator().manual_seed(1), B)
    agen = torch.Generator().manual_seed(2)
    for t in range(8):
        a = torch.rand((B, 2), generator=agen) * 2 - 1
        ro, rstate, rrew, rdone, rtr, rinfo = raw.step_vec(
            torch.Generator().manual_seed(t), state, a)
        so, sstate, srew, sdone, strr, _ = env.step_vec(
            torch.Generator().manual_seed(t), state, a)
        f = (0.99 * phi(rinfo["terminal_state"]) * (1.0 - rdone.float())
             - phi(state))
        assert torch.equal(srew, rrew + f)
        assert torch.equal(so, ro) and torch.equal(sdone, rdone)
        state = sstate
    assert env.device == raw.device


def test_shaping_increments_stay_below_terminal_threshold():
    """|F| stays well under the 0.5 pos/neg-rate threshold, at the JAX
    test's γ and at the default γ = 1."""
    raw = gpt_torch.make("HeavenHellContinuous-v0", device="cpu")
    for env in (tshape.PotentialShaped(raw, tshape.heaven_hell_potential(0.1),
                                       gamma=0.99),
                tshape.PotentialShaped(raw, tshape.heaven_hell_potential(0.1))):
        B = 256
        gen = torch.Generator().manual_seed(3)
        obs, state = env.reset_vec(gen, B)
        for _ in range(20):
            a = torch.rand((B, 2), generator=gen) * 2 - 1
            obs, state, rew, done, trunc, _ = env.step_vec(gen, state, a)
            assert rew[~done].abs().max() < 0.3


def test_default_gamma_is_one():
    assert inspect.signature(tshape.PotentialShaped).parameters["gamma"].default == 1.0


def test_heaven_hell_potential_on_point_mass_states():
    """tests/test_shaping.py's geodesic checks, on point-mass states."""
    xy = np.asarray([[0.0, 0.0], [6.25, 6.0], [-6.25, 6.0], [0.0, 6.0]], np.float32)
    right = np.asarray([True, True, True, False])
    jst = JHState(elapsed=jnp.zeros(4, jnp.int32), agent_xy=jnp.asarray(xy),
                  heaven_right=jnp.asarray(right))
    v = tshape.heaven_hell_potential(0.1)(_hh(jst)).numpy()
    np.testing.assert_array_equal(v, np.asarray(jshape.heaven_hell_potential(0.1)(jst)))
    np.testing.assert_allclose(v[1], 0.0, atol=1e-6)
    assert v[0] < v[3] < v[1]
    np.testing.assert_allclose(v[2], -0.1 * 12.5, atol=1e-5)


def test_tag_potential_tracks_target_distance():
    jenv = gpt.make("TagContinuous-v0")
    _, js = jenv.reset_vec(jax.random.PRNGKey(0), 64)
    ts = TTState(elapsed=_t(js.elapsed), agent_xy=_t(js.agent_xy),
                 target_xy=_t(js.target_xy))
    v = tshape.tag_potential(0.2)(ts).numpy()
    np.testing.assert_array_equal(v, np.asarray(jshape.tag_potential(0.2)(js)))
    d = np.sqrt(((np.asarray(js.agent_xy) - np.asarray(js.target_xy)) ** 2).sum(-1))
    np.testing.assert_allclose(v, -0.2 * d, rtol=1e-4)
    assert isinstance(js, JTState)
