"""The articulated ant's task envs in the PyTorch port
(``gym_po_tpu_torch.envs.ant_physics``) against the JAX package's
(``gym_po_tpu.envs.ant_physics``), at float32 on the CPU.

The port's step is stages that take their draws as arguments.  Fed the
draws the JAX package takes from its keys (the flee modes, the spawn
uniforms, the target's 257 candidates rebuilt from its rejection loop's
split chain, the heaven coins) and the JAX step's physics output, each
stage must give the JAX ``step_vec``'s values: ints and bools exactly,
floats to 1e-6.  The physics stage itself (f32, one Euler substep, one
Newton iteration here) is held loosely: f32 rounding differs between the
packages and the contact solve amplifies it (``test_torch_physics*.py``
hold the engine at f64).  Then the spawn distribution, reward shaping's
ant branch, PPO and recurrent PPO train steps and the dryrun's ant step.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs import ant_physics as jant
from gym_po_tpu.envs import shaping as jshaping
from gym_po_tpu_torch.envs import ant_physics as tant
from gym_po_tpu_torch.envs import shaping as tshaping

from test_torch_physics import one_thread  # noqa: F401

KNOBS = dict(frame_skip=1, solver_iters=1, integrator="euler", time_limit=5)
PHYSICS_ATOL = 1e-4  # f32, one substep: the packages round differently


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(j, t, what=""):
    j, t = np.asarray(j), t.cpu().numpy()
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


def _eq_state(js, ts, what=""):
    for name in ts.__dataclass_fields__:
        _eq(getattr(js, name), getattr(ts, name), f"{what}.{name}")


def _jax_candidates(key):
    """The JAX target spawn's 257 candidates in draw order: its first draw
    and the 256 redraws of its loop, from the same split chain."""
    k, kd = jax.random.split(key)
    x0 = jax.random.uniform(kd, (2,), jnp.float32, -jant.CAGE, jant.CAGE)

    def body(k, _):
        k, kd = jax.random.split(k)
        return k, jax.random.uniform(kd, (2,), jnp.float32, -jant.CAGE, jant.CAGE)

    _, rest = jax.lax.scan(body, k, None, length=256)
    return jnp.concatenate([x0[None], rest])


def _jax_fresh_draws(key, num, tag: bool):
    """The uniforms behind the JAX ``_fresh_vec(key, num)``: the ant's xy
    in [0, 1) and, for tag, each env's 257 target candidates in [0, 1) (the
    same split chain as :func:`_jax_candidates`); for heaven-hell the
    coins."""
    ka, kb = jax.random.split(key)
    u_xy = jax.random.uniform(ka, (num, 2), jnp.float32)
    if not tag:
        return u_xy, jax.random.bernoulli(kb, shape=(num,))

    def unit(key):
        k, kd = jax.random.split(key)
        x0 = jax.random.uniform(kd, (2,), jnp.float32)

        def body(k, _):
            k, kd = jax.random.split(k)
            return k, jax.random.uniform(kd, (2,), jnp.float32)

        return jnp.concatenate([x0[None], jax.lax.scan(body, k, None, length=256)[1]])

    return u_xy, jax.vmap(unit)(jax.random.split(kb, num))


def test_constants_and_signatures_equal_jax():
    np.testing.assert_array_equal(tant.STAND_POSE, jant.STAND_POSE)
    assert tant.STAND_POSE.dtype == jant.STAND_POSE.dtype == np.float32
    np.testing.assert_array_equal(tant.HH_SITES, jant.HH_SITES)
    for name in ("CAGE", "VISIBLE_RADIUS", "TAG_RADIUS", "MIN_SPAWN_DIST",
                 "TARGET_STEP", "HH_RADIUS", "_NQ", "_NV"):
        assert getattr(tant, name) == getattr(jant, name), name
    for jcls, tcls in ((jant.AntTagPhysics, tant.AntTagPhysics),
                       (jant.AntHeavenHellPhysics, tant.AntHeavenHellPhysics)):
        jp = inspect.signature(jcls).parameters
        tp = inspect.signature(tcls).parameters
        for name, p in jp.items():
            assert tp[name].default == p.default, name
        assert tp["device"].default == "cuda"
        je, te = jcls(), tcls(device="cpu")
        assert te.observation_space.shape == je.observation_space.shape
        assert te.action_space.shape == je.action_space.shape == (8,)
        assert te.name == je.name
        assert te.model.nq == 15 and te.model.nv == 14
    for env_id in ("AntTagPhysics-v0", "AntHeavenHellPhysics-v0"):
        env = gpt_torch.make(env_id, device="cpu", pipeline="array")
        assert env.device == torch.device("cpu") and env.pipeline == "array"
    with pytest.raises(ValueError):
        tant.AntTagPhysics(integrator="verlet", device="cpu")
    with pytest.raises(ValueError):
        tant.AntTagPhysics(pipeline="pallas", device="cpu")


def test_move_target_matches_jax():
    rng = np.random.default_rng(0)
    n = 4096
    agent = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    target = rng.uniform(-4.5, 4.5, (n, 2)).astype(np.float32)
    target[:64] = agent[:64]                                  # zero distance
    target[64:256, 0] = rng.choice([-4.4, 4.4, 4.1, -4.2], 192)  # cage edge
    mode = rng.integers(0, 4, n).astype(np.int32)
    want = jax.jit(jax.vmap(jant._move_target))(agent, target, mode)
    got = tant.move_target(_t(agent), _t(target), _t(mode))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the JAX tests' cases: flees +x, stays, cancelled at the edge
    a0 = torch.zeros(2)
    np.testing.assert_allclose(tant.move_target(a0, torch.tensor([1.0, 0.0]),
                                                torch.tensor(0)), [1.5, 0.0])
    np.testing.assert_allclose(tant.move_target(a0, torch.tensor([1.0, 0.0]),
                                                torch.tensor(3)), [1.0, 0.0])
    np.testing.assert_allclose(tant.move_target(a0, torch.tensor([4.3, 0.0]),
                                                torch.tensor(0)), [4.3, 0.0])


def test_target_spawn_returns_jax_point_exactly():
    """T2: the first of JAX's 257 candidates that qualifies, else the last —
    the point the JAX ``lax.while_loop`` rejection sampler returns."""
    env = jant.AntTagPhysics(**KNOBS)
    n = 256
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    rng = np.random.default_rng(2)
    agent = rng.uniform(-4.5, 4.5, (n, 2)).astype(np.float32)
    agent[:64] = 0.0                         # the centre: most rejections
    agent[64:80] = [4.5, -4.5]
    want = jax.jit(jax.vmap(env._spawn_target))(keys, agent)
    cands = jax.jit(jax.vmap(_jax_candidates))(keys)
    got = tant.AntTagPhysics.spawn_target(_t(agent), _t(cands))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d2 = ((np.asarray(cands) - agent[:, None]) ** 2).sum(-1)
    first = (d2 >= 25.0).argmax(-1)
    assert (first[:64] >= 2).any()          # draws past the second were taken
    # none qualifies: the last candidate
    c = torch.zeros(3, 257, 2)
    c[:, -1] = torch.tensor([0.5, 0.25])
    np.testing.assert_array_equal(
        tant.AntTagPhysics.spawn_target(torch.zeros(3, 2), c).numpy(),
        np.tile([0.5, 0.25], (3, 1)))


@pytest.mark.parametrize("env_id", ["tag", "hh"])
def test_fresh_and_reset_reproduce_jax(env_id):
    """``fresh`` on the uniforms behind JAX's ``_fresh_vec`` (and so
    ``reset_vec``) gives JAX's new states and observations exactly."""
    tag = env_id == "tag"
    jcls, tcls = ((jant.AntTagPhysics, tant.AntTagPhysics) if tag else
                  (jant.AntHeavenHellPhysics, tant.AntHeavenHellPhysics))
    je, te = jcls(**KNOBS), tcls(device="cpu", **KNOBS)
    key = jax.random.PRNGKey(11)
    obs, js = je.reset_vec(key, 128)
    draws = _jax_fresh_draws(key, 128, tag)
    ts = te.fresh(*(_t(x) for x in draws))
    _eq_state(js, ts, "fresh")
    _eq(obs, te.observe(ts), "obs")
    assert ts.qpos.dtype == torch.float32 and ts.elapsed.dtype == torch.int32
    assert ts.warm.abs().sum() == 0 and ts.qvel.abs().sum() == 0


def _staged_state(je, key, tag: bool):
    """A JAX batch with some envs one step from the time limit, some tags
    or arrivals in reach, both heaven sides."""
    B = 64
    _, js = je.reset_vec(key, B)
    rng = np.random.default_rng(3)
    elapsed = rng.integers(0, je.time_limit, B).astype(np.int32)
    elapsed[:8] = je.time_limit - 1
    js = js.replace(elapsed=jnp.asarray(elapsed))
    qpos = np.asarray(js.qpos).copy()
    if tag:
        target = np.asarray(js.target_xy).copy()
        near = slice(8, 24)
        target[near] = np.clip(qpos[near, :2] + rng.uniform(-1, 1, (16, 2)),
                               -4.4, 4.4)
        target[24:28] = qpos[24:28, :2]             # zero distance
        js = js.replace(target_xy=jnp.asarray(target))
    else:
        sites = np.asarray(jant.HH_SITES)
        qpos[8:32, :2] = sites[rng.integers(0, 3, 24)] + rng.uniform(
            -1.2, 1.2, (24, 2)).astype(np.float32)
        heaven = rng.random(B) < 0.5
        js = js.replace(qpos=jnp.asarray(qpos), heaven_right=jnp.asarray(heaven))
    return js


@pytest.mark.parametrize("env_id", ["tag", "hh"])
def test_step_stages_reproduce_jax_step_vec(env_id):
    tag = env_id == "tag"
    jcls, tcls, tstate = (
        (jant.AntTagPhysics, tant.AntTagPhysics, tant.AntTagPhysicsState) if tag
        else (jant.AntHeavenHellPhysics, tant.AntHeavenHellPhysics,
              tant.AntHeavenHellPhysicsState))
    je = jcls(pipeline="array", **KNOBS)
    te = tcls(device="cpu", **KNOBS)
    js = _staged_state(je, jax.random.PRNGKey(5), tag)
    B = js.elapsed.shape[0]
    action = np.random.default_rng(4).uniform(-1.3, 1.3, (B, 8)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    obs, jn, rew, done, trunc, info = jax.jit(je.step_vec)(key, js, jnp.asarray(action))
    jmid = info["terminal_state"]
    ts = tstate.from_numpy(js, device="cpu")

    # the physics stage, loosely (f32; one substep and one iteration)
    q, v, w = te.physics(ts.qpos, ts.qvel, ts.warm, _t(action))
    for name, got in (("qpos", q), ("qvel", v), ("warm", w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jmid, name)),
                                   rtol=0, atol=PHYSICS_ATOL, err_msg=name)

    # the task stages, fed JAX's physics output and draws: exact
    phys = tuple(_t(getattr(jmid, k)) for k in ("qpos", "qvel", "warm"))
    if tag:
        km, kr = jax.random.split(key)
        extra = (_t(jax.random.randint(km, (B,), 0, 4)),)
    else:
        kr, extra = key, ()
    mid, t_rew, t_done, t_trunc = te.advance(ts, *phys, *extra)
    _eq_state(jmid, mid, "terminal_state")
    _eq(rew, t_rew, "rew")
    _eq(done, t_done, "done")
    _eq(trunc, t_trunc, "trunc")
    reset = t_done | t_trunc
    _eq(info["reset_mask"], reset, "reset_mask")
    assert t_done.any() and t_trunc.any() and (~reset).any()
    if not tag:
        assert (t_rew > 0).any() and (t_rew < 0).any()
    fresh = te.fresh(*(_t(x) for x in _jax_fresh_draws(kr, B, tag)))
    new = te.apply_reset(mid, reset, fresh)
    _eq_state(jn, new, "new_state")
    _eq(obs, te.observe(new), "obs")


@pytest.mark.parametrize("env_id", ["AntTagPhysics-v0", "AntHeavenHellPhysics-v0"])
def test_step_vec_is_its_stages_on_its_generator(env_id):
    """The port's step_vec = physics, advance, fresh, apply_reset, observe
    on the draws its generator gives in order (mode; xy; candidates or
    coins), and the single-instance protocol runs."""
    env = gpt_torch.make(env_id, device="cpu", **KNOBS)
    tag = env_id.startswith("AntTag")
    gen = torch.Generator().manual_seed(1)
    _, st = env.reset_vec(gen, 16)
    st = st.replace(elapsed=torch.arange(16, dtype=torch.int32) % env.time_limit)
    act = torch.rand(16, 8, generator=gen) * 2 - 1
    saved = gen.get_state()
    obs, new, rew, done, trunc, info = env.step_vec(gen, st, act)
    gen.set_state(saved)
    phys = env.physics(st.qpos, st.qvel, st.warm, act)
    if tag:
        extra = (torch.randint(0, 4, (16,), generator=gen, dtype=torch.int32),)
        draws = (torch.rand(16, 2, generator=gen),
                 torch.rand(16, 257, 2, generator=gen))
    else:
        extra = ()
        draws = (torch.rand(16, 2, generator=gen), torch.rand(16, generator=gen) < 0.5)
    mid, rew2, done2, trunc2 = env.advance(st, *phys, *extra)
    want = env.apply_reset(mid, done2 | trunc2, env.fresh(*draws))
    for name in new.__dataclass_fields__:
        assert torch.equal(getattr(new, name), getattr(want, name)), name
        assert torch.equal(getattr(info["terminal_state"], name), getattr(mid, name))
    assert torch.equal(obs, env.observe(want)) and torch.equal(rew, rew2)
    assert trunc.any() and torch.equal(info["reset_mask"], done | trunc)
    o1, s1 = env.reset(gen)
    o1, s1, r1, d1, t1, i1 = env.step(gen, s1, torch.zeros(8))
    assert o1.shape == env.observation_space.shape and r1.shape == ()
    assert i1["terminal_state"].qpos.shape == (15,)


def test_tag_spawn_distribution():
    """The target spawn is the reference's conditional distribution
    (uniform over the cage beyond 5.0), against a NumPy rejection oracle,
    from the port's own draws (the JAX package's test, at the cage
    centre, the lowest acceptance rate)."""
    env = tant.AntTagPhysics(device="cpu", **KNOBS)
    n = 4096
    gen = torch.Generator().manual_seed(7)
    st = env.fresh(torch.full((n, 2), 0.5),
                   torch.rand(n, tant.SPAWN_CANDIDATES, 2, generator=gen))
    assert (st.qpos[:, :2] == 0).all()
    xy = st.target_xy.numpy().astype(np.float64)
    r = np.linalg.norm(xy, axis=-1)
    assert (r >= 5.0).all()
    assert (np.abs(xy) <= 4.5).all()
    assert len(np.unique(xy[:, 0])) > 0.99 * n
    assert not np.isin(np.abs(xy), 4.5).any()
    corners = np.array([[-4.5, -4.5], [-4.5, 4.5], [4.5, -4.5], [4.5, 4.5]])
    d_corner = np.linalg.norm(xy[:, None] - corners[None], axis=-1).min(-1)
    assert (d_corner < 0.3).mean() < 0.07
    rng = np.random.default_rng(0)
    acc = []
    while sum(len(a) for a in acc) < n:
        c = rng.uniform(-4.5, 4.5, size=(4 * n, 2))
        acc.append(c[(c**2).sum(-1) >= 25.0])
    ref = np.concatenate(acc)[:n]
    bins = np.linspace(5.0, 4.5 * np.sqrt(2.0), 7)
    h = np.histogram(r, bins)[0] / n
    h_ref = np.histogram(np.linalg.norm(ref, axis=-1), bins)[0] / n
    np.testing.assert_allclose(h, h_ref, atol=0.05)
    quad = (xy[:, 0] > 0).astype(int) * 2 + (xy[:, 1] > 0)
    np.testing.assert_allclose(np.bincount(quad, minlength=4) / n, 0.25, atol=0.05)
    # and through reset_vec: every target at least 5.0 from its ant
    _, st = env.reset_vec(gen, 256)
    d = (st.qpos[:, :2] - st.target_xy).norm(dim=-1)
    assert (d >= 5.0).all() and (st.target_xy.abs() <= 4.5).all()


@pytest.mark.parametrize("env_id", ["tag", "hh"])
def test_shaping_potentials_on_the_ant_match_jax(env_id):
    tag = env_id == "tag"
    je = (jant.AntTagPhysics if tag else jant.AntHeavenHellPhysics)(**KNOBS)
    js = _staged_state(je, jax.random.PRNGKey(9), tag)
    tstate = tant.AntTagPhysicsState if tag else tant.AntHeavenHellPhysicsState
    ts = tstate.from_numpy(js, device="cpu")
    jphi = (jshaping.tag_potential if tag else jshaping.heaven_hell_potential)(0.1)
    tphi = (tshaping.tag_potential if tag else tshaping.heaven_hell_potential)(0.1)
    np.testing.assert_allclose(tphi(ts).numpy(), np.asarray(jphi(js)), rtol=1e-6,
                               atol=1e-6)
    env = tshaping.PotentialShaped(
        (tant.AntTagPhysics if tag else tant.AntHeavenHellPhysics)(device="cpu",
                                                                   **KNOBS), tphi)
    gen = torch.Generator().manual_seed(0)
    _, st = env.reset_vec(gen, 8)
    out = env.step_vec(gen, st, torch.zeros(8, 8))
    assert torch.isfinite(out[2]).all() and env.device == torch.device("cpu")


def test_ppo_train_step_on_ant():
    """PPO trains the articulated ant end to end (Gaussian head over the
    8-torque Box action, 29-D Box obs), as the JAX package's test does."""
    from gym_po_tpu_torch.agents import PPOConfig, init_train_state, make_train_step

    env = tant.AntTagPhysics(frame_skip=1, solver_iters=1, integrator="euler",
                             device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_steps=4, epochs=1, minibatches=2,
                    hidden=(16, 16))
    model, ts = init_train_state(env, cfg, torch.Generator().manual_seed(0))
    before = ts.params.clone()
    ts2, metrics = make_train_step(env, model, cfg)(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert (ts2.params - before).abs().max() > 0
    assert ts2.env_obs.shape == (4, 29) and torch.isfinite(ts2.env_obs).all()


def test_rnn_ppo_train_step_on_ant():
    """GRU-PPO over the ant's Gaussian action head (heaven-hell)."""
    from gym_po_tpu_torch.agents import PPOConfig
    from gym_po_tpu_torch.agents.ppo_rnn import init_rnn_state, make_rnn_train_step

    env = tant.AntHeavenHellPhysics(frame_skip=1, solver_iters=1,
                                    integrator="euler", device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_steps=4, epochs=1, minibatches=2,
                    hidden=(16,))
    model, ts = init_rnn_state(env, cfg, torch.Generator().manual_seed(0), hidden=8)
    ts2, metrics = make_rnn_train_step(env, model, cfg)(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_dryrun_multichip_runs_the_ant():
    from gym_po_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(1, device="cpu")
    assert np.isfinite(out[0]["ant_loss"])
    assert set(out[0]["ant_metrics"]) >= {"loss", "entropy", "mean_reward"}
