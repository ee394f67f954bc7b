"""CRooms (continuous rooms) in the PyTorch port against the JAX package, on
identical inputs.

Every continuous observation model (the discrete models over discretized
coordinates, the raw 'mdp' vector, ``lidar``, the 'vel' flag) must give
equal observations at seeded positions, at cell sizes 1.0 and 0.5; the
env's deterministic stages must give exactly equal floats, bools and f32
rewards on the same numpy states, actions and draws, in float32 and, under
the ``x64`` fixture, in float64.  The port's ``step_vec`` is held to its own
stages by replaying its generator.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs.crooms import CRoomsState as JState
from gym_po_tpu.obs.observations import make_rooms_obs as jax_make_obs
from gym_po_tpu_torch.envs.crooms import CRooms, CRoomsState as TState
from gym_po_tpu_torch.maps import layouts as tlayouts
from gym_po_tpu_torch.obs.observations import make_rooms_obs as torch_make_obs


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(), err_msg=what)


def _space_equal(js, ts):
    assert type(js).__name__ == type(ts).__name__
    if hasattr(js, "n"):
        assert js.n == ts.n
    else:
        assert tuple(js.shape) == tuple(ts.shape)
        np.testing.assert_array_equal(js.low_arr, ts.low_arr)
        np.testing.assert_array_equal(js.high_arr, ts.high_arr)


def _positions(grid, cs, n, rng):
    """``n`` float32 positions over the clip range [0, shape - 1), a third
    of them at walkable cells' centers (in cell-size-1 coordinates, as the
    spawns are), and goals: the layout end's center, and moved ones."""
    hi = np.asarray(grid.shape, np.float64) - 1 - 1e-6
    pos = (rng.random((n, 2)) * hi).astype(np.float32)
    walk = np.stack(np.nonzero(grid >= 0), -1)
    centers = (walk[rng.integers(0, len(walk), n)] + 0.5).astype(np.float32)
    pos = np.where((rng.random(n) < 0.33)[:, None], centers, pos)
    end = np.asarray(tuple(reversed(tlayouts.layout_end("4"))), np.float32) + 0.5
    return pos, np.broadcast_to(end, pos.shape).copy(), pos[rng.permutation(n)]


OBS_TYPES = [
    ("mdp", 3), ("mdp_goal", 3), ("mdp_vector", 3), ("mdp_goal_vector", 3),
    ("room", 3), ("room_goal", 3), ("hansen", 3), ("hansen8", 3),
    ("hansen_vector", 3), ("hansen_goal_vector", 3), ("hansen8_goal_vector", 3),
    ("grid", 3), ("grid", 5), ("lidar", 8), ("lidar", 3),
]


@pytest.mark.parametrize("layout", ["4", "16", "32b"])
@pytest.mark.parametrize("cs", [1.0, 0.5])
@pytest.mark.parametrize("obs_type,obs_n", OBS_TYPES)
def test_continuous_observations_equal_jax(layout, cs, obs_type, obs_n):
    grid = tlayouts.layout_grid(layout)
    jspace, jfn = jax_make_obs(obs_type, grid, obs_n, cell_size=cs)
    tspace, tfn = torch_make_obs(obs_type, grid, obs_n, cell_size=cs,
                                 device="cpu")
    _space_equal(jspace, tspace)
    n = 96 if obs_type == "lidar" else 512
    agent, fixed_goal, moved_goal = _positions(
        grid, cs, n, np.random.default_rng(len(obs_type) + obs_n))
    for goal in (fixed_goal, moved_goal):
        want = jax.vmap(jfn)(jnp.asarray(agent), jnp.asarray(goal))
        got = tfn(_t(agent), _t(goal))
        assert got.dtype == {"int32": torch.int32, "float32": torch.float32}[
            str(np.asarray(want).dtype)]
        _eq(want, got, obs_type)


def test_lidar_needs_continuous_coordinates():
    grid = tlayouts.layout_grid("4")
    with pytest.raises(NotImplementedError):
        torch_make_obs("lidar", grid, 8)
    with pytest.raises(NotImplementedError):
        torch_make_obs("nonsense", grid, 3, cell_size=1.0)


ENV_CASES = [
    ("4", dict()),
    ("4", dict(use_velocity=True, obs_type="mdp_goal_vector_vel",
               goal_xy=None)),
    ("16", dict(action_type="ordinal", obs_type="hansen", agent_xy=(1, 1))),
    ("4b", dict(action_type="cardinal", action_std=0.0, obs_type="room_goal",
                step_reward=-0.01, wall_reward=-0.1)),
    ("8", dict(use_velocity=True, cell_size=0.5, obs_type="lidar_vel",
               obs_m=8, goal_xy=None, agent_xy=(2, 3))),
    ("4", dict(cell_size=2.0, obs_type="grid", obs_m=5, action_power=1.5,
               goal_threshold=0.8)),
]


def _pair(layout, kw, time_limit=10):
    je = gpt.make("CRooms-v0", layout=layout, time_limit=time_limit, **kw)
    te = gpt_torch.make("CRooms-v0", layout=layout, time_limit=time_limit,
                        device="cpu", **kw)
    return je, te


@pytest.mark.parametrize("layout,kw", ENV_CASES)
def test_constructor_equals_jax(layout, kw):
    je, te = _pair(layout, kw)
    assert te.name == je.name and te.num_actions == je.num_actions
    assert te.obs_includes_velocity == je.obs_includes_velocity
    np.testing.assert_array_equal(te._pos_hi, je._pos_hi)
    assert te._pos_hi.dtype == np.float64
    np.testing.assert_array_equal(te.valid_states, je.valid_states)
    np.testing.assert_array_equal(te._valid_coord.numpy(), np.asarray(je._valid_coord))
    for f in ("fixed_goal_coord", "fixed_agent_coord"):
        jv, tv = getattr(je, f), getattr(te, f)
        assert (jv is None) == (tv is None)
        if jv is not None:
            np.testing.assert_array_equal(tv, jv)
    _space_equal(je.observation_space, te.observation_space)
    _space_equal(je.action_space, te.action_space)
    if te.action_type != "yx":
        np.testing.assert_array_equal(te._cum, je._cum)
        np.testing.assert_array_equal(te._disp.numpy(), np.asarray(je._disp))


def test_defaults_and_refusals():
    assert inspect.signature(CRooms).parameters["device"].default == "cuda"
    te = gpt_torch.make("CRooms-v0", device="cpu")
    assert (te.layout, te.action_type, te.cell_size, te.time_limit) == (
        "4", "yx", 1.0, 500)
    np.testing.assert_array_equal(
        te.fixed_goal_coord,
        np.asarray(tuple(reversed(tlayouts.layout_end("4")))) + 0.5)
    assert te.fixed_agent_coord is None and te.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="vel"):
        gpt_torch.make("CRooms-v0", obs_type="mdp_vel", device="cpu")
    with pytest.raises(ValueError):
        gpt_torch.make("CRooms-v0", layout="nope", device="cpu")


def _effective_jax(je, a, u, noise):
    """The JAX package's ``_sample_effective_vec`` on given draws."""
    from gym_po_tpu.ops import row_gather

    if je.action_type == "yx":
        return (jnp.asarray(a) + jnp.asarray(noise) * je.action_std) * je.action_power
    disp = row_gather(je._disp, je._exec(jnp.asarray(a), jnp.asarray(u)))
    if je.action_std:
        disp = disp + jnp.asarray(noise) * je.action_std
    return disp * je.action_power


def _stages(layout, kw, dt):
    """K steps of effective_action, propose, resolve, apply_reset and
    observe on both packages, fed the same numpy draws."""
    je, te = _pair(layout, kw)
    B, K = 256, 24
    rng = np.random.default_rng(5)
    vc = np.asarray(je._valid_coord, np.float64)
    nv = len(vc)

    def spawn(fixed):
        if fixed is not None:
            return np.broadcast_to(np.asarray(fixed, dt), (B, 2)).copy()
        return vc[rng.integers(0, nv, B)].astype(dt)

    goal = spawn(je.fixed_goal_coord)
    agent = (vc[rng.integers(0, nv, B)]
             + rng.uniform(-0.45, 0.45, (B, 2))).astype(dt)
    # a third start within reach of their goal
    near = goal + rng.uniform(-0.6, 0.6, (B, 2)).astype(dt)
    agent = np.where((rng.random(B) < 0.33)[:, None], near, agent).astype(dt)
    vel = (rng.uniform(-1, 1, (B, 2)) if te.use_velocity
           else np.zeros((B, 2))).astype(dt)
    elapsed = rng.integers(0, 8, B).astype(np.int32)
    js = JState(elapsed=jnp.asarray(elapsed), agent_yx=jnp.asarray(agent),
                goal_yx=jnp.asarray(goal), vel_yx=jnp.asarray(vel))
    ts = TState(elapsed=_t(elapsed), agent_yx=_t(agent), goal_yx=_t(goal),
                vel_yx=_t(vel))
    _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "reset obs")
    counts = np.zeros(3, int)  # goals, wall hits, resets
    for t in range(K):
        if te.action_type == "yx":
            a = rng.uniform(-1, 1, (B, 2)).astype(dt)
            u, ndt = None, dt
        else:
            a = rng.integers(0, te.num_actions, B).astype(np.int32)
            u, ndt = rng.random(B).astype(np.float32), np.float32
        noise = rng.standard_normal((B, 2)).astype(ndt)
        ja = _effective_jax(je, a, u, noise)
        ta = te.effective_action(_t(a), None if u is None else _t(u), _t(noise))
        _eq(ja, ta, "a_eff")
        jp, jv, joob = jax.vmap(je.propose)(js, ja)
        tp, tv, toob = te.propose(ts, ta)
        for j, tt, what in ((jp, tp, "proposed"), (jv, tv, "vel"),
                            (joob, toob, "oob")):
            _eq(j, tt, what)
        cell_noise = (rng.standard_normal((B, 2)) * 0.5).astype(dt)
        jmid, jrew, jdone, jtrunc = jax.vmap(je.resolve)(
            js, jp, jv, joob, jnp.asarray(cell_noise))
        tmid, trew, tdone, ttrunc = te.resolve(ts, tp, tv, toob, _t(cell_noise))
        for j, tt, what in ((jmid.agent_yx, tmid.agent_yx, "agent"),
                            (jmid.vel_yx, tmid.vel_yx, "vel'"),
                            (jmid.elapsed, tmid.elapsed, "elapsed"),
                            (jrew, trew, "reward"), (jdone, tdone, "done"),
                            (jtrunc, ttrunc, "trunc")):
            _eq(j, tt, what)
        assert trew.dtype == torch.float32 and tmid.agent_yx.dtype == ts.agent_yx.dtype
        mask = np.asarray(jdone | jtrunc)
        g_new, a_new = spawn(je.fixed_goal_coord), spawn(je.fixed_agent_coord)
        js = jax.vmap(je.apply_reset)(jmid, jnp.asarray(mask),
                                      jnp.asarray(g_new), jnp.asarray(a_new))
        ts = te.apply_reset(tmid, _t(mask), _t(g_new), _t(a_new))
        for j, tt, what in ((js.agent_yx, ts.agent_yx, "agent'"),
                            (js.goal_yx, ts.goal_yx, "goal'"),
                            (js.vel_yx, ts.vel_yx, "vel''"),
                            (js.elapsed, ts.elapsed, "elapsed'")):
            _eq(j, tt, what)
        _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs")
        counts += (int(np.asarray(jdone).sum()), int(np.asarray(joob).sum()),
                   int(mask.sum()))
    assert (counts > 0).all(), counts  # every branch ran


@pytest.mark.parametrize("layout,kw", ENV_CASES)
def test_stages_equal_jax_float32(layout, kw):
    _stages(layout, kw, np.float32)


@pytest.mark.usefixtures("x64")
@pytest.mark.parametrize("layout,kw", ENV_CASES)
def test_stages_equal_jax_float64(layout, kw):
    """The JAX package's f64 parity mode: the stages keep float64."""
    _stages(layout, kw, np.float64)


def test_resample_stays_inside_the_cell_in_float32():
    """A wall hit resamples into [center - cs/2, boundary): in float32 the
    reference's boundary - 1e-8 rounds to the boundary itself, so the clamp
    one ULP down is what keeps the agent in its cell."""
    te = gpt_torch.make("CRooms-v0", device="cpu")
    B = 64
    agent = torch.full((B, 2), 5.5)
    st = TState(elapsed=torch.zeros(B, dtype=torch.int32), agent_yx=agent,
                goal_yx=torch.zeros(B, 2), vel_yx=torch.zeros(B, 2))
    oob = torch.ones(B, dtype=torch.bool)
    noise = torch.full((B, 2), 10.0)  # far past the upper edge
    mid, rew, done, _ = te.resolve(st, agent, st.vel_yx, oob, noise)
    assert (mid.agent_yx < 6.0).all()
    assert (mid.agent_yx == torch.nextafter(torch.tensor(6.0), torch.tensor(0.0))).all()
    assert (te._cell(mid.agent_yx) == 5).all()


@pytest.mark.parametrize("layout,kw", ENV_CASES)
def test_step_vec_composes_its_stages(layout, kw):
    """``step_vec`` is the stages on the generator's draws in the JAX
    package's key order: effective action, resample noise, goal, agent."""
    _, te = _pair(layout, kw, time_limit=6)
    B = 256
    gen = torch.Generator().manual_seed(4)
    obs, st = te.reset_vec(gen, B)
    assert obs.shape == (B, *te.observation_space.shape)
    for _ in range(6):
        a = te.action_space.sample_vec(gen, B)
        replay = torch.Generator().manual_seed(0)
        replay.set_state(gen.get_state())
        obs, st2, rew, done, trunc, info = te.step_vec(gen, st, a)
        a_eff = te.sample_effective_action(replay, a)
        p, v, oob = te.propose(st, a_eff)
        noise = torch.randn((B, 2), generator=replay) * 0.5
        mid, r2, d2, t2 = te.resolve(st, p, v, oob, noise)
        want = te.apply_reset(
            mid, d2 | t2,
            te._sample_spawn_vec(replay, B, te.fixed_goal_coord),
            te._sample_spawn_vec(replay, B, te.fixed_agent_coord))
        for x, y in ((st2.agent_yx, want.agent_yx), (st2.goal_yx, want.goal_yx),
                     (st2.vel_yx, want.vel_yx), (st2.elapsed, want.elapsed),
                     (rew, r2), (done, d2), (trunc, t2),
                     (obs, te.observe(want)),
                     (info["terminal_state"].agent_yx, mid.agent_yx),
                     (info["reset_mask"], d2 | t2)):
            assert torch.equal(x, y)
        st = st2
    hi = torch.as_tensor(te._pos_hi, dtype=torch.float32)
    assert ((st.agent_yx >= 0) & (st.agent_yx <= hi)).all()


def test_single_env_protocol():
    te = gpt_torch.make("CRooms-v0", layout="2", goal_xy=None, device="cpu",
                        action_type="ordinal", obs_type="hansen")
    gen = torch.Generator().manual_seed(1)
    obs, st = te.reset(gen)
    assert obs.shape == () and st.agent_yx.shape == (2,)
    for _ in range(5):
        obs, st, rew, done, trunc, info = te.step(
            gen, st, torch.tensor(3, dtype=torch.int32))
        assert rew.shape == () and info["terminal_state"].agent_yx.shape == (2,)


def test_random_policy_reaches_goals_and_walls():
    """Perf mode over 64 steps: wall rewards and goals both occur and the
    agents stay in the clip range."""
    te = gpt_torch.make("CRooms-v0", layout="1", goal_xy=None, wall_reward=-1.0,
                        use_velocity=True, device="cpu")
    gen = torch.Generator().manual_seed(7)
    _, st = te.reset_vec(gen, 1024)
    rews = []
    for _ in range(64):
        _, st, rew, *_ = te.step_vec(gen, st, te.action_space.sample_vec(gen, 1024))
        rews.append(rew)
    rews = torch.stack(rews)
    assert (rews == -1.0).any() and (rews == 1.0).any()
    assert (st.vel_yx.abs() <= 5.0).all()
