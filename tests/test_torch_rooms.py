"""ROOMS in the PyTorch port against the JAX package, on identical inputs.

Layouts, action tables and failure matrices must be equal array for array;
every discrete observation model must give equal observations on every
walkable cell; the env's deterministic stages must give exactly equal ints,
bools and f32 rewards on the same numpy states, actions and draws.  The
port's ``step_vec`` is held to its own stages by replaying its generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs.rooms import RoomsState as JRoomsState
from gym_po_tpu.maps import layouts as jlayouts
from gym_po_tpu.obs.observations import make_rooms_obs as jax_make_obs
from gym_po_tpu.utils import actions as jactions
from gym_po_tpu_torch.envs.rooms import RoomsState as TRoomsState
from gym_po_tpu_torch.maps import layouts as tlayouts
from gym_po_tpu_torch.obs.observations import make_rooms_obs as torch_make_obs
from gym_po_tpu_torch.utils import actions as tactions


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(), err_msg=what)


@pytest.mark.parametrize("name", tlayouts.LAYOUT_NAMES)
def test_layouts_equal_jax(name):
    assert tlayouts.LAYOUT_NAMES == jlayouts.LAYOUT_NAMES
    np.testing.assert_array_equal(tlayouts.layout_grid(name),
                                  jlayouts.layout_grid(name))
    assert tlayouts.layout_rows(name) == jlayouts.layout_rows(name)
    assert tlayouts.layout_start(name) == jlayouts.layout_start(name)
    assert tlayouts.layout_end(name) == jlayouts.layout_end(name)


def test_layout_sizes():
    """12 layouts, 169 to 1,225 cells, 111 to 852 walkable, each with a full
    wall border (the fused kernels' flat-cell arithmetic relies on it)."""
    cells, walk = [], []
    for name in tlayouts.LAYOUT_NAMES:
        g = tlayouts.layout_grid(name)
        cells.append(g.size)
        walk.append(int((g >= 0).sum()))
        for border in (g[0], g[-1], g[:, 0], g[:, -1]):
            assert (border == -1).all()
    assert (min(cells), max(cells)) == (169, 1225)
    assert (min(walk), max(walk)) == (111, 852)


@pytest.mark.parametrize("A,p", [(4, 0.2), (8, 0.2), (8, 0.0), (4, 1.0 / 3)])
def test_action_tables_and_failure_sampler_equal_jax(A, p):
    np.testing.assert_array_equal(tactions.ACTIONS_ORDINAL, jactions.ACTIONS_ORDINAL)
    np.testing.assert_array_equal(tactions.ACTIONS_CARDINAL, jactions.ACTIONS_CARDINAL)
    np.testing.assert_array_equal(tactions.ACTIONS_ORDINAL_Z,
                                  jactions.ACTIONS_ORDINAL_Z)
    np.testing.assert_array_equal(tactions.failure_matrix(A, p),
                                  jactions.failure_matrix(A, p))
    cum = tactions.failure_cumsum(A, p)
    np.testing.assert_array_equal(cum, jactions.failure_cumsum(A, p))
    rng = np.random.default_rng(A)
    a = rng.integers(0, A, 4096).astype(np.int32)
    # uniforms, plus the f32 cumsum entries themselves (ties: strict <)
    u = rng.random(4096).astype(np.float32)
    u[:A * A] = cum.astype(np.float32).reshape(-1)
    a[:A * A] = np.repeat(np.arange(A), A)
    np.testing.assert_array_equal(tactions.exec_action_np(cum, a, u),
                                  jactions.exec_action_np(cum, a, u))
    want = jactions.make_exec_action(cum)(jnp.asarray(a), jnp.asarray(u))
    got = tactions.make_exec_action(cum)(_t(a), _t(u))
    assert got.dtype == torch.int32
    _eq(want, got)


OBS_TYPES = [
    ("mdp", 3), ("mdp_goal", 3), ("mdp_vector", 3), ("mdp_goal_vector", 3),
    ("room", 3), ("room_goal", 3), ("hansen", 3), ("hansen8", 3),
    ("hansen_vector", 3), ("hansen_goal_vector", 3), ("hansen8_goal_vector", 3),
    ("grid", 3), ("grid", 5),
]


def _space_equal(js, ts):
    assert type(js).__name__ == type(ts).__name__
    if hasattr(js, "n"):
        assert js.n == ts.n
    else:
        assert tuple(js.shape) == tuple(ts.shape)
        np.testing.assert_array_equal(np.broadcast_to(js.low, js.shape),
                                      ts.low_arr)
        np.testing.assert_array_equal(np.broadcast_to(js.high, js.shape),
                                      ts.high_arr)


@pytest.mark.parametrize("layout", ["1", "4", "16b", "32"])
@pytest.mark.parametrize("obs_type,obs_n", OBS_TYPES)
def test_observations_equal_jax_on_every_walkable_cell(layout, obs_type, obs_n):
    grid = tlayouts.layout_grid(layout)
    jspace, jfn = jax_make_obs(obs_type, grid, obs_n)
    tspace, tfn = torch_make_obs(obs_type, grid, obs_n, device="cpu")
    _space_equal(jspace, tspace)
    walk = np.stack(np.nonzero(grid >= 0), -1).astype(np.int32)
    rng = np.random.default_rng(len(walk))
    # a fixed goal (the layout end) and a goal moved to random cells, next
    # to the agent for a quarter of the cells
    end = np.asarray(tuple(reversed(tlayouts.layout_end(layout))), np.int32)
    moved = walk[rng.integers(0, len(walk), len(walk))]
    near = walk + tactions.ACTIONS_ORDINAL[rng.integers(0, 8, len(walk))]
    near_ok = grid[near[:, 0], near[:, 1]] >= 0
    moved = np.where((near_ok & (rng.random(len(walk)) < 0.25))[:, None],
                     near, moved).astype(np.int32)
    for goal in (np.broadcast_to(end, walk.shape).copy(), moved):
        want = jax.vmap(jfn)(jnp.asarray(walk), jnp.asarray(goal))
        got = tfn(_t(walk), _t(goal))
        assert got.dtype == torch.int32
        _eq(want, got, obs_type)


def test_unported_observations_raise():
    """What neither package builds raises in both: lidar on discrete
    coordinates and an unknown model.  (The continuous branch and lidar on
    continuous coordinates are in tests/test_torch_crooms.py.)"""
    grid = tlayouts.layout_grid("4")
    for kw in ({"obs_type": "lidar"}, {"obs_type": "sonar", "cell_size": 1.0}):
        for make in (jax_make_obs, torch_make_obs):
            with pytest.raises(NotImplementedError):
                make(grid=grid, **kw)


ENV_CASES = [
    ("1", dict(action_type="cardinal")),
    ("4", dict()),
    ("4", dict(goal_xy=None, obs_type="hansen")),
    ("16", dict(agent_xy=(1, 1), obs_type="room_goal", action_type="cardinal")),
    ("32", dict(goal_xy=None, agent_xy=(3, 3), obs_type="grid", obs_n=5,
                action_failure_probability=0.4)),
]


def _pair(layout, kw, time_limit=12):
    je = gpt.make("Rooms-v0", layout=layout, time_limit=time_limit, **kw)
    te = gpt_torch.make("Rooms-v0", layout=layout, time_limit=time_limit,
                        device="cpu", **kw)
    return je, te


@pytest.mark.parametrize("layout,kw", ENV_CASES)
def test_constructor_equals_jax(layout, kw):
    je, te = _pair(layout, kw)
    assert te.name == je.name and te.num_actions == je.num_actions
    np.testing.assert_array_equal(te.grid_np, je.grid_np)
    np.testing.assert_array_equal(te.valid_states, je.valid_states)
    np.testing.assert_array_equal(te._cum, je._cum)
    for f in ("fixed_goal_yx", "fixed_agent_yx"):
        jv, tv = getattr(je, f), getattr(te, f)
        assert (jv is None) == (tv is None)
        if jv is not None:
            np.testing.assert_array_equal(jv, tv)
    _space_equal(je.observation_space, te.observation_space)
    assert je.action_space.n == te.action_space.n


def test_default_goal_resolves_to_layout_end():
    """``goal_xy=(0, 0)`` lands on a wall and falls back to the layout end."""
    te = gpt_torch.make("Rooms-v0", device="cpu")
    end = tuple(reversed(tlayouts.layout_end("4")))
    np.testing.assert_array_equal(te.fixed_goal_yx, end)
    assert te.fixed_agent_yx is None


@pytest.mark.parametrize("layout,kw", ENV_CASES)
def test_stages_equal_jax_on_identical_draws(layout, kw):
    """K steps of exec_action, advance, apply_reset and observe, fed the
    same numpy uniforms, actions and spawn indices, on both packages."""
    je, te = _pair(layout, kw)
    B, K = 256, 24
    rng = np.random.default_rng(3)
    valid_yx = np.stack(np.unravel_index(je.valid_states, je.grid_np.shape),
                        -1).astype(np.int32)
    nv = len(valid_yx)

    def spawn(fixed):
        if fixed is not None:
            return np.broadcast_to(np.asarray(fixed, np.int32), (B, 2)).copy()
        return valid_yx[rng.integers(0, nv, B)]

    # start beside the goal often enough that episodes end within K
    goal = spawn(je.fixed_goal_yx)
    agent = spawn(je.fixed_agent_yx)
    near = goal + jactions.ACTIONS_ORDINAL[rng.integers(0, 8, B)]
    H, GW = je.grid_np.shape
    near_ok = ((near >= 0).all(-1) & (near[:, 0] < H) & (near[:, 1] < GW))
    near_ok[near_ok] = je.grid_np[near[near_ok, 0], near[near_ok, 1]] >= 0
    agent = np.where((near_ok & (rng.random(B) < 0.5))[:, None], near,
                     agent).astype(np.int32)
    elapsed = rng.integers(0, 12, B).astype(np.int32)
    js = JRoomsState(elapsed=jnp.asarray(elapsed), agent_yx=jnp.asarray(agent),
                     goal_yx=jnp.asarray(goal))
    ts = TRoomsState(elapsed=_t(elapsed), agent_yx=_t(agent), goal_yx=_t(goal))
    _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "reset obs")
    n_done = 0
    for t in range(K):
        a = rng.integers(0, je.num_actions, B).astype(np.int32)
        u = rng.random(B).astype(np.float32)
        jx = je.exec_action(jnp.asarray(a), jnp.asarray(u))
        tx = te.exec_action(_t(a), _t(u))
        _eq(jx, tx, "executed")
        jmid, jrew, jdone, jtrunc = jax.vmap(je.advance)(js, jx)
        tmid, trew, tdone, ttrunc = te.advance(ts, tx)
        for j, tt, what in ((jmid.agent_yx, tmid.agent_yx, "agent"),
                            (jmid.elapsed, tmid.elapsed, "elapsed"),
                            (jrew, trew, "reward"), (jdone, tdone, "done"),
                            (jtrunc, ttrunc, "trunc")):
            _eq(j, tt, what)
        mask = np.asarray(jdone | jtrunc)
        g_new, a_new = spawn(je.fixed_goal_yx), spawn(je.fixed_agent_yx)
        js = jax.vmap(je.apply_reset)(jmid, jnp.asarray(mask),
                                      jnp.asarray(g_new), jnp.asarray(a_new))
        ts = te.apply_reset(tmid, _t(mask), _t(g_new), _t(a_new))
        for j, tt, what in ((js.agent_yx, ts.agent_yx, "agent'"),
                            (js.goal_yx, ts.goal_yx, "goal'"),
                            (js.elapsed, ts.elapsed, "elapsed'")):
            _eq(j, tt, what)
        _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs")
        n_done += int(np.asarray(jdone).sum())
    assert n_done > 0  # the goal branch ran


@pytest.mark.parametrize("layout,kw", ENV_CASES)
def test_step_vec_composes_its_stages(layout, kw):
    """``step_vec`` is exec_action, advance, apply_reset and observe on the
    generator's draws in the JAX package's order (u, goal, agent)."""
    _, te = _pair(layout, kw, time_limit=6)
    B = 512
    gen = torch.Generator().manual_seed(4)
    obs, st = te.reset_vec(gen, B)
    assert obs.shape[0] == B and st.agent_yx.shape == (B, 2)
    assert (te.grid_np[st.agent_yx[:, 0], st.agent_yx[:, 1]] >= 0).all()
    for _ in range(8):
        a = torch.randint(0, te.num_actions, (B,), dtype=torch.int32)
        replay = torch.Generator().manual_seed(0)
        replay.set_state(gen.get_state())
        obs, st2, rew, done, trunc, info = te.step_vec(gen, st, a)
        u = torch.rand(B, generator=replay)
        mid, r2, d2, t2 = te.advance(st, te.exec_action(a, u))
        want = te.apply_reset(mid, d2 | t2,
                              te._sample_spawn_vec(replay, B, te.fixed_goal_yx),
                              te._sample_spawn_vec(replay, B, te.fixed_agent_yx))
        for x, y in ((st2.agent_yx, want.agent_yx), (st2.goal_yx, want.goal_yx),
                     (st2.elapsed, want.elapsed), (rew, r2), (done, d2),
                     (trunc, t2), (obs, te.observe(want)),
                     (info["terminal_state"].agent_yx, mid.agent_yx),
                     (info["reset_mask"], d2 | t2)):
            assert torch.equal(x, y)
        st = st2
    assert (te.grid_np[st.agent_yx[:, 0], st.agent_yx[:, 1]] >= 0).all()


def test_single_env_protocol():
    te = gpt_torch.make("Rooms-v0", layout="2", goal_xy=None, device="cpu")
    gen = torch.Generator().manual_seed(1)
    obs, st = te.reset(gen)
    assert obs.shape == () and st.agent_yx.shape == (2,)
    for _ in range(20):
        obs, st, rew, done, trunc, info = te.step(
            gen, st, torch.tensor(3, dtype=torch.int32))
        assert obs.shape == () and rew.shape == () and done.dtype == torch.bool
        assert info["terminal_state"].agent_yx.shape == (2,)
        assert te.observation_space.contains(obs.numpy())


def test_random_action_failure_rate():
    """Perf mode: with p = 0.2 the executed action differs from the
    commanded one at rate 0.2, uniformly over the other A - 1."""
    te = gpt_torch.make("Rooms-v0", device="cpu")
    n = 200_000
    gen = torch.Generator().manual_seed(7)
    a = torch.full((n,), 3, dtype=torch.int32)
    x = te.exec_action(a, torch.rand(n, generator=gen))
    assert abs((x != a).double().mean().item() - 0.2) < 0.005
    other = torch.bincount(x[x != a].long(), minlength=8).double()
    other = other[torch.arange(8) != 3] / other.sum()
    assert (other - 1 / 7).abs().max().item() < 0.01
