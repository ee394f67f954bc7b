"""The fused Tag and HeavenHell rollouts of the PyTorch port: their plain twins
against the JAX Pallas kernels (interpreted) on the same tape, bit for bit.

Neither kernel calls a transcendental (Tag's one square root is correctly
rounded on every device), so no libm seam is needed here.  The CUDA kernels
against the twins on the card are in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import make_fused_heavenhell_rollout as jax_hh
from gym_po_tpu.ops import make_fused_tag_rollout as jax_tag
from gym_po_tpu_torch.envs.tag import BAR, CAGE, STEM
from gym_po_tpu_torch.ops import (
    make_fused_heavenhell_rollout,
    make_fused_tag_rollout,
)

from _tape import make_tape

W = 128
SEED0 = jnp.asarray([3], jnp.int32)


def _tag_state(je, B, key=5):
    _, st = je.reset_vec(jax.random.PRNGKey(key), B)
    cols = (st.agent_xy[:, 0], st.agent_xy[:, 1], st.target_xy[:, 0],
            st.target_xy[:, 1])
    return [np.array(c, np.float32).reshape(-1, W) for c in cols]


def _hh_state(je, B, key=6):
    _, st = je.reset_vec(jax.random.PRNGKey(key), B)
    return [np.array(st.agent_xy[:, 0], np.float32).reshape(-1, W),
            np.array(st.agent_xy[:, 1], np.float32).reshape(-1, W),
            np.array(st.heaven_right, np.int32).reshape(-1, W)]


def _both(env_id, jax_make, torch_make, state_fn, kw, B, K, rows_per_tile,
          stats, tape_seed):
    je = gpt.make(env_id, **kw)
    te = gpt_torch.make(env_id, device="cpu", **kw)
    jrun = jax_make(je, B, K, rows_per_tile=rows_per_tile, interpret=True,
                    episode_stats=stats, rng_tape=True)
    trun = torch_make(te, B, K, rows_per_tile=rows_per_tile,
                      episode_stats=stats, rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape and trun.n_sites == jrun.n_sites
    R = min(rows_per_tile, B // W)
    tape = make_tape(np.random.default_rng(tape_seed), jrun.n_sites, K, R,
                     grid=B // W // R)
    state = state_fn(je, B)
    jout = [np.asarray(x) for x in
            jrun(SEED0, *map(jnp.asarray, state), jnp.asarray(tape))]
    tout = trun(3, *map(torch.as_tensor, state), torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    return jout, tout, state


# env kwargs, rows_per_tile (1: two tiles at B = 256), episode stats
CASES = [
    (dict(time_limit=25), 128, False),
    (dict(time_limit=25), 1, True),
    (dict(time_limit=40, agent_speed=0.6), 128, True),
]


@pytest.mark.parametrize("kw,rows_per_tile,stats", CASES)
def test_tag_twin_equals_jax_kernel(kw, rows_per_tile, stats):
    """At the JAX tape test's shape (B = 256, K = 60): every output bit for
    bit, dtypes held."""
    B, K = 256, 60
    jout, tout, s4 = _both("TagContinuous-v0", jax_tag,
                           make_fused_tag_rollout, _tag_state, kw, B, K,
                           rows_per_tile, stats, 23)
    names = "a0 a1 t0 t1 racc ep_ret ep_len ep_cnt".split()
    assert len(tout) == len(jout) == (8 if stats else 5)
    for name, j, t in zip(names, jout, tout):
        assert t.dtype == torch.float32 and t.shape == (B // W, W), name
        np.testing.assert_array_equal(j, t.numpy(), err_msg=name)
    assert (jout[2] != s4[2]).mean() > 0.5  # the targets fled or respawned
    if stats:
        assert (tout[7] >= 1).all()


@pytest.mark.parametrize("kw,rows_per_tile,stats", CASES)
def test_heavenhell_twin_equals_jax_kernel(kw, rows_per_tile, stats):
    B, K = 256, 60
    jout, tout, _ = _both("HeavenHellContinuous-v0", jax_hh,
                          make_fused_heavenhell_rollout, _hh_state, kw, B, K,
                          rows_per_tile, stats, 29)
    names = "x y heaven racc ep_ret ep_len ep_cnt".split()
    assert len(tout) == len(jout) == (7 if stats else 4)
    for name, j, t in zip(names, jout, tout):
        want = torch.int32 if name == "heaven" else torch.float32
        assert t.dtype == want and t.shape == (B // W, W), name
        np.testing.assert_array_equal(j, t.numpy(), err_msg=name)
    assert set(np.unique(tout[2].numpy())) == {0, 1}  # both coin sides


@pytest.mark.parametrize("which", ["tag", "heavenhell"])
def test_rollouts_refuse_what_the_kernels_do_not_take(which):
    env_id, make, n = (("TagContinuous-v0", make_fused_tag_rollout, 4)
                       if which == "tag" else
                       ("HeavenHellContinuous-v0", make_fused_heavenhell_rollout, 3))
    env = gpt_torch.make(env_id, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        make(env, 100, 8)
    with pytest.raises(ValueError):
        make(env, 384, 8, rows_per_tile=2)
    run = make(env, 256, 8, rng_tape=True)
    f = torch.zeros(2, W)
    state = [f] * (n - 1) + [f if which == "tag" else f.int()]
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="tape must have shape"):
        run(0, *state, tape[:8])
    with pytest.raises(ValueError, match="tape argument"):
        run(0, *state)
    with pytest.raises(ValueError, match="state tile"):
        run(0, *state[:-1], f.double(), tape)
    with pytest.raises(ValueError, match="state tiles"):
        make(env, 256, 8)(0, *state[:-1])
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, *(x.to("meta") for x in state), tape.to("meta"))


def test_philox_rollouts_stay_valid_and_ignore_the_tiling():
    """Perf mode: agents and targets stay in the cage, HeavenHell agents in
    the T-maze's free space with a 0/1 heaven; the draws do not depend on the
    tiles."""
    B, K = 1024, 64
    gen = torch.Generator().manual_seed(4)
    te = gpt_torch.make("TagContinuous-v0", time_limit=30, device="cpu")
    _, st = te.reset_vec(gen, B)
    s4 = [c.reshape(-1, W).contiguous() for c in (
        st.agent_xy[:, 0], st.agent_xy[:, 1], st.target_xy[:, 0],
        st.target_xy[:, 1])]
    out = make_fused_tag_rollout(te, B, K, episode_stats=True)(7, *s4)
    assert all((x.abs() <= CAGE).all() for x in out[:4])
    assert (out[7] >= 1).all() and (out[4] >= 0).all()
    again = make_fused_tag_rollout(te, B, K, rows_per_tile=1,
                                   episode_stats=True)(7, *s4)
    assert all(torch.equal(x, y) for x, y in zip(out, again))

    he = gpt_torch.make("HeavenHellContinuous-v0", time_limit=30, device="cpu")
    _, st = he.reset_vec(gen, B)
    s3 = [st.agent_xy[:, 0].reshape(-1, W).contiguous(),
          st.agent_xy[:, 1].reshape(-1, W).contiguous(),
          st.heaven_right.to(torch.int32).reshape(-1, W)]
    out = make_fused_heavenhell_rollout(he, B, K, episode_stats=True)(7, *s3)
    x, y = out[0], out[1]
    stem = (x >= STEM[0]) & (x <= STEM[1]) & (y >= STEM[2]) & (y <= STEM[3])
    bar = (x >= BAR[0]) & (x <= BAR[1]) & (y >= BAR[2]) & (y <= BAR[3])
    assert (stem | bar).all()
    assert out[2].dtype == torch.int32 and set(out[2].unique().tolist()) <= {0, 1}
    assert (out[4].abs() <= out[6]).all()  # one ±1 at most per episode
    again = make_fused_heavenhell_rollout(he, B, K, rows_per_tile=2,
                                          episode_stats=True)(7, *s3)
    assert all(torch.equal(x, y) for x, y in zip(out, again))


@pytest.mark.parametrize("time_limit", [500, 1])
def test_heavenhell_spawn_draws_are_discarded_where_no_env_resets(time_limit):
    """The HeavenHell kernel draws the spawn (sites 2-4) only where an env
    resets.  From the spawn region (y <= 1, |x| <= 1) an agent moving at
    most 0.25 a step per axis stays more than 2 from both sites at
    (±6.25, 6) for K = 8 steps, and the default time limit (500) is past K:
    no env resets, and two tapes that differ only at sites 2-4 give the JAX
    kernel (interpreted) and the twin the same outputs, each equal to the
    other.  At time limit 1 every env resets every step, and the same change
    moves the outputs (the control)."""
    B, K, R = 256, 8, 1
    kw = dict(time_limit=time_limit)
    je = gpt.make("HeavenHellContinuous-v0", **kw)
    te = gpt_torch.make("HeavenHellContinuous-v0", device="cpu", **kw)
    jrun = jax_hh(je, B, K, rows_per_tile=R, interpret=True,
                  episode_stats=True, rng_tape=True)
    trun = make_fused_heavenhell_rollout(te, B, K, rows_per_tile=R,
                                         episode_stats=True, rng_tape=True)
    assert trun.n_sites == jrun.n_sites == 5
    grid = B // W // R
    tape = make_tape(np.random.default_rng(41), 5, K, R, grid=grid)
    t5 = tape.copy().reshape(grid, 5, K, R, W)
    rng = np.random.default_rng(42)
    for j in (2, 3, 4):  # the spawn sites, at every step
        t5[:, j] = rng.integers(-2**31, 2**31, t5[:, j].shape).astype(np.int32)
    other = t5.reshape(tape.shape)
    assert (other != tape).mean() > 0.5 * 3 / 5
    state = _hh_state(je, B)
    assert (state[1] <= 1).all() and (np.abs(state[0]) <= 1).all()
    outs = []
    for t in (tape, other):
        jout = [np.asarray(x) for x in
                jrun(SEED0, *map(jnp.asarray, state), jnp.asarray(t))]
        tout = [x.numpy() for x in
                trun(3, *map(torch.as_tensor, state), torch.as_tensor(t))]
        for j, o in zip(jout, tout):
            np.testing.assert_array_equal(j, o)
        outs.append(tout)
    ep_cnt = outs[0][6]
    if time_limit == 500:
        assert (ep_cnt == 0).all()
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    else:
        assert (ep_cnt == K).all()
        assert not np.array_equal(outs[0][0], outs[1][0])
        assert not np.array_equal(outs[0][2], outs[1][2])
