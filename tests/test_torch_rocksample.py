"""RockSample in the PyTorch port against the JAX package, on identical
inputs.

The rock layouts (drawn from ``layout_seed`` with numpy) and the spaces must
be equal; the env's deterministic stages must give exactly equal ints,
bools and f32 rewards on the same numpy states, actions and draws.  The
sensor accuracy ``eta = 0.5 * (1 + 2^(-d/d0))`` is held to ``rtol=1e-6``:
torch's and XLA's ``exp2`` and ``sqrt`` may round differently in the last
ulp; so a CHECK reading (``u < eta``) must be equal wherever
``|u - eta| > 1e-6``, and every other output exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs import rocksample as jrs
from gym_po_tpu.envs.rocksample import RockSampleState as JState
from gym_po_tpu_torch.envs import rocksample as trs
from gym_po_tpu_torch.envs.rocksample import RockSampleState as TState

ETA_RTOL = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(), err_msg=what)


SIZES = [((5, 5), 5), ((7, 7), 8), ((11, 11), 11)]


def _pair(map_size, k, **kw):
    return (gpt.make("RockSample-v0", map_size=map_size, num_rocks=k, **kw),
            gpt_torch.make("RockSample-v0", map_size=map_size, num_rocks=k,
                           device="cpu", **kw))


@pytest.mark.parametrize("map_size,k", SIZES)
@pytest.mark.parametrize("obs_type", ["discrete", "vector"])
def test_layout_and_spaces_equal_jax(map_size, k, obs_type):
    for seed in (0, 7):
        je, te = _pair(map_size, k, obs_type=obs_type, layout_seed=seed)
        np.testing.assert_array_equal(te.rock_positions_np, je.rock_positions_np)
        assert len({tuple(p) for p in te.rock_positions_np}) == k
    np.testing.assert_array_equal(te.init_pos_np, np.asarray(je._init_pos))
    assert te.name == je.name and te.num_actions == je.num_actions == 5 + k
    assert te.action_space.n == je.action_space.n
    js, ts = je.observation_space, te.observation_space
    assert type(js).__name__ == type(ts).__name__
    if obs_type == "vector":
        assert tuple(js.shape) == tuple(ts.shape) == (3,)
        np.testing.assert_array_equal(js.low, ts.low_arr)
        np.testing.assert_array_equal(js.high, ts.high_arr)
    else:
        assert js.n == ts.n == map_size[0] * map_size[1] * 3 + 3


def test_constants_equal_jax():
    for name in ("OBS_NULL", "OBS_GOOD", "OBS_BAD", "A_SAMPLE", "GOOD_REWARD",
                 "BAD_PENALTY", "EXIT_REWARD", "ILLEGAL_SAMPLE_PENALTY"):
        assert getattr(trs, name) == getattr(jrs, name)
    np.testing.assert_array_equal(trs._MOVES_YX, jrs._MOVES_YX)
    te = gpt_torch.make("RockSample-v0", device="cpu")
    assert (te.rows, te.cols, te.k, te.time_limit, te.d0) == (5, 5, 5, 200, 20.0)


def _jax_eta(je, pos, action):
    """The sensor accuracy as the JAX env's ``advance`` computes it."""
    def eta(p, a):
        ksel = jax.nn.one_hot(jnp.clip(a - 5, 0, je.k - 1), je.k,
                              dtype=jnp.float32)
        rpos = jnp.matmul(ksel, je._rocks.astype(jnp.float32))
        diff = p.astype(jnp.float32) - rpos
        dist = jnp.sqrt((diff * diff).sum())
        return 0.5 * (1.0 + jnp.exp2(-dist / je.d0))
    return np.asarray(jax.vmap(eta)(jnp.asarray(pos), jnp.asarray(action)))


@pytest.mark.parametrize("map_size,k", SIZES)
@pytest.mark.parametrize("obs_type", ["discrete", "vector"])
def test_stages_equal_jax_on_identical_draws(map_size, k, obs_type):
    """K steps of advance, apply_reset and observe, fed the same numpy
    actions, sensor uniforms and rock qualities, on both packages."""
    je, te = _pair(map_size, k, obs_type=obs_type, time_limit=15,
                   half_efficiency_distance=4.0)
    B, K = 512, 40
    rng = np.random.default_rng(sum(map_size) + k)
    rows, cols = map_size
    rocks = je.rock_positions_np
    # a third of the rovers start on a rock, so that samples hit rocks
    pos = np.stack([rng.integers(0, rows, B), rng.integers(0, cols, B)], -1)
    on = rng.random(B) < 0.33
    pos[on] = rocks[rng.integers(0, k, int(on.sum()))]
    pos = pos.astype(np.int32)
    good = rng.random((B, k)) < 0.5
    elapsed = rng.integers(0, 10, B).astype(np.int32)
    reading = rng.integers(0, 3, B).astype(np.int32)
    js = JState(elapsed=jnp.asarray(elapsed), pos_yx=jnp.asarray(pos),
                rock_good=jnp.asarray(good), reading=jnp.asarray(reading))
    ts = TState(elapsed=_t(elapsed), pos_yx=_t(pos), rock_good=_t(good),
                reading=_t(reading))
    _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs0")
    n_close = n_exit = n_good = 0
    for _ in range(K):
        # actions biased to SAMPLE and CHECK so that every branch runs
        a = np.where(rng.random(B) < 0.3, 4,
                     rng.integers(0, 5 + k, B)).astype(np.int32)
        u = rng.random(B).astype(np.float32)
        jeta = _jax_eta(je, np.asarray(js.pos_yx), a)
        teta = te.sensor_accuracy(ts.pos_yx, _t(a))
        np.testing.assert_allclose(teta.numpy(), jeta, rtol=ETA_RTOL, atol=0)
        jmid, jrew, jdone, jtrunc = jax.vmap(je.advance)(js, jnp.asarray(a),
                                                        jnp.asarray(u))
        tmid, trew, tdone, ttrunc = te.advance(ts, _t(a), _t(u))
        for j, tt, what in ((jmid.pos_yx, tmid.pos_yx, "pos"),
                            (jmid.rock_good, tmid.rock_good, "rock_good"),
                            (jmid.elapsed, tmid.elapsed, "elapsed"),
                            (jrew, trew, "reward"), (jdone, tdone, "done"),
                            (jtrunc, ttrunc, "trunc")):
            _eq(j, tt, what)
        far = np.abs(u - jeta) > ETA_RTOL
        _eq(np.asarray(jmid.reading)[far], tmid.reading[_t(far)], "reading")
        n_close += int((~far).sum())
        n_exit += int(np.asarray(jdone).sum())
        n_good += int((np.asarray(jrew) == jrs.GOOD_REWARD).sum())
        mask = np.asarray(jdone | jtrunc)
        new_good = rng.random((B, k)) < 0.5
        js = jax.vmap(je.apply_reset)(jmid, jnp.asarray(mask),
                                      jnp.asarray(new_good))
        tmid = tmid.replace(reading=_t(np.asarray(jmid.reading)))
        ts = te.apply_reset(tmid, _t(mask), _t(new_good))
        for j, tt, what in ((js.pos_yx, ts.pos_yx, "pos'"),
                            (js.rock_good, ts.rock_good, "rock_good'"),
                            (js.elapsed, ts.elapsed, "elapsed'"),
                            (js.reading, ts.reading, "reading'")):
            _eq(j, tt, what)
        _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs")
    assert n_exit > 0 and n_good > 0  # the exit and good-sample branches ran
    assert n_close < B * K // 1000  # readings compared almost everywhere


def test_step_vec_composes_its_stages():
    """``step_vec`` is advance, apply_reset and observe on the generator's
    draws in the JAX package's order (sensor uniform, rock qualities)."""
    te = gpt_torch.make("RockSample-v0", map_size=(7, 7), num_rocks=8,
                        time_limit=10, device="cpu")
    B = 512
    gen = torch.Generator().manual_seed(4)
    obs, st = te.reset_vec(gen, B)
    assert obs.shape == (B,) and st.rock_good.shape == (B, 8)
    assert (st.pos_yx == torch.tensor([1, 1], dtype=torch.int32)).all()
    assert 0.4 < st.rock_good.double().mean().item() < 0.6
    for _ in range(12):
        a = torch.randint(0, te.num_actions, (B,), dtype=torch.int32)
        replay = torch.Generator().manual_seed(0)
        replay.set_state(gen.get_state())
        obs, st2, rew, done, trunc, info = te.step_vec(gen, st, a)
        u = torch.rand(B, generator=replay)
        mid, r2, d2, t2 = te.advance(st, a, u)
        want = te.apply_reset(mid, d2 | t2,
                              torch.rand((B, 8), generator=replay) < 0.5)
        for x, y in ((st2.pos_yx, want.pos_yx), (st2.rock_good, want.rock_good),
                     (st2.elapsed, want.elapsed), (st2.reading, want.reading),
                     (rew, r2), (done, d2), (trunc, t2),
                     (obs, te.observe(want)),
                     (info["terminal_state"].pos_yx, mid.pos_yx),
                     (info["reset_mask"], d2 | t2)):
            assert torch.equal(x, y)
        st = st2
        assert te.observation_space.contains(obs.numpy())


def test_single_env_protocol():
    te = gpt_torch.make("RockSample-v0", obs_type="vector", device="cpu")
    gen = torch.Generator().manual_seed(1)
    obs, st = te.reset(gen)
    assert obs.shape == (3,) and st.rock_good.shape == (5,)
    for a in (4, 5, 1, 1, 1, 1, 9):
        obs, st, rew, done, trunc, info = te.step(
            gen, st, torch.tensor(a, dtype=torch.int32))
        assert obs.shape == (3,) and rew.dtype == torch.float32
        assert info["terminal_state"].pos_yx.shape == (2,)
        assert te.observation_space.contains(obs.numpy())
