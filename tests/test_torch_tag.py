"""Point-mass TagContinuous and HeavenHellContinuous in the PyTorch port
against the JAX package (``gym_po_tpu.envs.tag_jax``).

The constants must be equal; the port's stages, fed the draws that the JAX
package's ``step_vec`` takes from its key (the flee modes, the respawn
agents and their 8 target candidates; the spawn uniforms and heaven coins),
must reproduce that ``step_vec`` exactly: observations, states, rewards,
dones, truncations and the pre-reset state.  The port's own ``step_vec`` is
held to its stages by replaying its generator.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs import tag_jax as jtag
from gym_po_tpu.envs.tag_jax import HeavenHellState as JHState, TagState as JTState
from gym_po_tpu_torch.envs import tag as ttag
from gym_po_tpu_torch.envs.tag import HeavenHellState as THState, TagState as TTState


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(), err_msg=what)


def test_constants_equal_jax():
    for name in ("CAGE", "VISIBLE_RADIUS", "TAG_RADIUS", "MIN_SPAWN_DIST",
                 "TARGET_STEP", "AGENT_SPEED", "HH_RADIUS", "STEM", "BAR"):
        assert getattr(ttag, name) == getattr(jtag, name), name
    np.testing.assert_array_equal(ttag.HH_SITES, jtag.HH_SITES)
    assert ttag.HH_SITES.dtype == jtag.HH_SITES.dtype
    for cls in (ttag.TagContinuous, ttag.HeavenHellContinuous):
        assert inspect.signature(cls).parameters["device"].default == "cuda"


@pytest.mark.parametrize("kw", [{}, dict(visible_radius=1.5, agent_speed=0.4)])
def test_tag_stages_reproduce_jax_step_vec(kw):
    """The port's advance, spawn_target, apply_reset and observe on the JAX
    key stream's draws give JAX's step_vec, step by step."""
    je = gpt.make("TagContinuous-v0", time_limit=12, **kw)
    te = gpt_torch.make("TagContinuous-v0", time_limit=12, device="cpu", **kw)
    _space = (je.observation_space, te.observation_space)
    np.testing.assert_array_equal(_space[0].low_arr, _space[1].low_arr)
    B = 512
    key = jax.random.PRNGKey(3)
    obs, js = je.reset_vec(key, B)
    # start a third of the targets near their agents, some at the same point
    rng = np.random.default_rng(1)
    agent = np.asarray(js.agent_xy)
    target = np.asarray(js.target_xy).copy()
    near = rng.random(B) < 0.33
    target[near] = np.clip(agent[near] + rng.uniform(-1.2, 1.2, (near.sum(), 2)),
                           -4.5, 4.5).astype(np.float32)
    target[:8] = agent[:8]  # zero distance: the flee guard
    js = js.replace(target_xy=jnp.asarray(target))
    ts = TTState(elapsed=_t(js.elapsed), agent_xy=_t(js.agent_xy),
                 target_xy=_t(js.target_xy))
    _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs")
    n_done = n_vis = 0
    for t in range(20):
        key, ka, ks = jax.random.split(key, 3)
        a = jax.random.uniform(ka, (B, 2), jnp.float32, -1.3, 1.3)
        jobs, js2, jrew, jdone, jtrunc, jinfo = je.step_vec(ks, js, a)
        # the draws step_vec takes from its key
        km, kr = jax.random.split(ks)
        mode = jax.random.randint(km, (B,), 0, 4)
        k_a, k_t = jax.random.split(kr)
        na = jax.random.uniform(k_a, (B, 2), jnp.float32, -jtag.CAGE, jtag.CAGE)
        cands = jax.random.uniform(k_t, (B, 8, 2), jnp.float32, -jtag.CAGE,
                                   jtag.CAGE)
        mid, rew, done, trunc = te.advance(ts, _t(a), _t(mode).to(torch.int32))
        nt = te.spawn_target(_t(na), _t(cands))
        ts = te.apply_reset(mid, done | trunc, _t(na), nt)
        for j, tt, what in (
                (jobs, te.observe(ts), "obs"), (js2.agent_xy, ts.agent_xy, "agent"),
                (js2.target_xy, ts.target_xy, "target"),
                (js2.elapsed, ts.elapsed, "elapsed"), (jrew, rew, "rew"),
                (jdone, done, "done"), (jtrunc, trunc, "trunc"),
                (jinfo["terminal_state"].target_xy, mid.target_xy, "mid"),
                (jinfo["reset_mask"], done | trunc, "reset")):
            _eq(j, tt, what)
        assert rew.dtype == torch.float32
        js = js2
        n_done += int(done.sum())
        n_vis += int(te.observe(ts)[:, 4].sum())
    assert n_done > 0
    # with visible_radius 1.5 a visible target is tagged within the step
    assert n_vis > 0 or kw


def test_tag_spawn_target_falls_back_to_the_farthest_corner():
    te = gpt_torch.make("TagContinuous-v0", device="cpu")
    agent = torch.tensor([[0.0, 0.0], [4.0, 4.0], [-4.0, 3.0]])
    cands = agent[:, None, :].repeat(1, 8, 1) + 0.5  # within 5.0 of the agent
    cands[1, 5] = torch.tensor([-4.0, -4.0])  # the only far one
    cands[2, 2] = cands[2, 6] = torch.tensor([4.0, -4.0])  # the first wins
    got = te.spawn_target(agent, cands)
    want = torch.tensor([[-4.5, -4.5], [-4.0, -4.0], [4.0, -4.0]])
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [{}, dict(agent_speed=1.0)])
def test_heavenhell_stages_reproduce_jax_step_vec(kw):
    je = gpt.make("HeavenHellContinuous-v0", time_limit=15, **kw)
    te = gpt_torch.make("HeavenHellContinuous-v0", time_limit=15, device="cpu",
                        **kw)
    B = 512
    key = jax.random.PRNGKey(4)
    _, js = je.reset_vec(key, B)
    # start a third in the bar near the sites and the priest
    rng = np.random.default_rng(2)
    xy = np.asarray(js.agent_xy).copy()
    bar = rng.random(B) < 0.4
    xy[bar] = np.stack([rng.uniform(-7.9, 7.9, bar.sum()),
                        rng.uniform(4.1, 7.9, bar.sum())], -1).astype(np.float32)
    js = js.replace(agent_xy=jnp.asarray(xy))
    ts = THState(elapsed=_t(js.elapsed), agent_xy=_t(js.agent_xy),
                 heaven_right=_t(js.heaven_right))
    _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs")
    seen = set()
    for t in range(20):
        key, ka, ks = jax.random.split(key, 3)
        a = jax.random.uniform(ka, (B, 2), jnp.float32, -1.3, 1.3)
        jobs, js2, jrew, jdone, jtrunc, jinfo = je.step_vec(ks, js, a)
        kx, kh = jax.random.split(ks)
        u = jax.random.uniform(kx, (B, 2), jnp.float32)
        heaven = jax.random.bernoulli(kh, shape=(B,))
        mid, rew, done, trunc = te.advance(ts, _t(a))
        ts = te.apply_reset(mid, done | trunc, te.spawn_xy(_t(u)), _t(heaven))
        for j, tt, what in (
                (jobs, te.observe(ts), "obs"), (js2.agent_xy, ts.agent_xy, "xy"),
                (js2.heaven_right, ts.heaven_right, "heaven"),
                (js2.elapsed, ts.elapsed, "elapsed"), (jrew, rew, "rew"),
                (jdone, done, "done"), (jtrunc, trunc, "trunc"),
                (jinfo["terminal_state"].agent_xy, mid.agent_xy, "mid")):
            _eq(j, tt, what)
        assert rew.dtype == torch.float32 and ts.heaven_right.dtype == torch.bool
        js = js2
        seen |= set(rew.tolist())
        seen |= {2.0} if (te.observe(ts)[:, 2] != 0).any() else set()
    assert {1.0, -1.0, 2.0} <= seen  # heaven, hell and the priest's reveal


@pytest.mark.parametrize("env_id", ["TagContinuous-v0", "HeavenHellContinuous-v0"])
def test_step_vec_composes_its_stages(env_id):
    te = gpt_torch.make(env_id, time_limit=5, device="cpu")
    B = 256
    gen = torch.Generator().manual_seed(6)
    obs, st = te.reset_vec(gen, B)
    assert obs.shape == (B, *te.observation_space.shape)
    for _ in range(6):
        a = te.action_space.sample_vec(gen, B)
        replay = torch.Generator().manual_seed(0)
        replay.set_state(gen.get_state())
        obs, st2, rew, done, trunc, info = te.step_vec(gen, st, a)
        if env_id.startswith("Tag"):
            mode = torch.randint(0, 4, (B,), generator=replay, dtype=torch.int32)
            mid, r2, d2, t2 = te.advance(st, a, mode)
        else:
            mid, r2, d2, t2 = te.advance(st, a)
        want = te.apply_reset(mid, d2 | t2, *te._sample_spawn_vec(replay, B))
        for x, y in ((obs, te.observe(want)), (rew, r2), (done, d2), (trunc, t2),
                     (info["reset_mask"], d2 | t2), (st2.elapsed, want.elapsed),
                     (st2.agent_xy, want.agent_xy)):
            assert torch.equal(x, y)
        st = st2
    assert (st.agent_xy.abs() <= 8.0).all()


@pytest.mark.parametrize("env_id", ["TagContinuous-v0", "HeavenHellContinuous-v0"])
def test_single_env_protocol(env_id):
    te = gpt_torch.make(env_id, device="cpu")
    gen = torch.Generator().manual_seed(1)
    obs, st = te.reset(gen)
    assert obs.shape == te.observation_space.shape and st.agent_xy.shape == (2,)
    for _ in range(4):
        obs, st, rew, done, trunc, info = te.step(gen, st, torch.tensor([0.3, -1.0]))
        assert rew.shape == () and info["terminal_state"].agent_xy.shape == (2,)
