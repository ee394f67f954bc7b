"""MultistoryFourRooms in the PyTorch port against the JAX package, on
identical inputs.

The walk map, the spawn banks and every observation model must be equal
array for array (observations on every cell, with the fixed goal and with
random goals); the env's deterministic stages must give exactly equal ints,
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
from gym_po_tpu.envs import msrooms as jms
from gym_po_tpu.envs.msrooms import MSRoomsState as JState
from gym_po_tpu_torch.envs import msrooms as tms
from gym_po_tpu_torch.envs.msrooms import MSRoomsState as TState


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
        np.testing.assert_array_equal(np.broadcast_to(js.low, js.shape),
                                      ts.low_arr)
        np.testing.assert_array_equal(np.broadcast_to(js.high, js.shape),
                                      ts.high_arr)


@pytest.mark.parametrize("grid_z", [1, 3, 5])
def test_walk_map_and_constants_equal_jax(grid_z):
    np.testing.assert_array_equal(tms.FR_MAP, jms.FR_MAP)
    assert int((tms.FR_MAP > 0).sum()) == 104
    np.testing.assert_array_equal(tms.build_walk_map(tms.FR_MAP, grid_z),
                                  jms.build_walk_map(jms.FR_MAP, grid_z))
    for name in ("WALL", "GOAL_CODE", "STAIR_DOWN", "STAIR_UP", "MAX_CODE",
                 "UPSTAIRS_NE", "DOWNSTAIRS_SW", "END_XYZ", "START_XYZ"):
        assert getattr(tms, name) == getattr(jms, name)


OBS_TYPES = ["mdp", "mdp_goal", "mdp_vector", "mdp_goal_vector", "hansen",
             "hansen8", "hansen_vector", "hansen_goal_vector",
             "hansen8_goal_vector"]


@pytest.mark.parametrize("grid_z", [1, 3, 5])
@pytest.mark.parametrize("obs_type", OBS_TYPES)
def test_observations_equal_jax_on_every_cell(grid_z, obs_type):
    grid = jms.build_walk_map(jms.FR_MAP, grid_z)
    jspace, jfn = jms.make_msrooms_obs(obs_type, grid)
    tspace, tfn = tms.make_msrooms_obs(obs_type, grid, device="cpu")
    _space_equal(jspace, tspace)
    cells = np.stack(np.unravel_index(np.arange(grid.size), grid.shape),
                     -1).astype(np.int32)
    rng = np.random.default_rng(grid_z)
    top = np.stack(np.nonzero(grid[-1] > 0), -1)
    end = np.asarray([grid_z - 1, 7, 9], np.int32)
    # the fixed goal, and random top-floor goals, next to the agent for a
    # quarter of the cells
    moved = np.concatenate([np.full((len(top), 1), grid_z - 1), top], -1)[
        rng.integers(0, len(top), len(cells))]
    near = cells + jms.ACTIONS_ORDINAL_Z[rng.integers(0, 8, len(cells))]
    moved = np.where((rng.random(len(cells)) < 0.25)[:, None], near,
                     moved).astype(np.int32)
    for goal in (np.broadcast_to(end, cells.shape).copy(), moved):
        want = jax.vmap(jfn)(jnp.asarray(cells), jnp.asarray(goal))
        got = tfn(_t(cells), _t(goal))
        assert got.dtype == (torch.float32 if obs_type in ("hansen", "hansen8")
                             else torch.int32)
        _eq(want, got, obs_type)


def test_room_observation_raises():
    grid = jms.build_walk_map(jms.FR_MAP, 2)
    for obs_type in ("room", "room_goal"):
        with pytest.raises(NotImplementedError):
            tms.make_msrooms_obs(obs_type, grid)


ENV_CASES = [
    dict(grid_z=1),
    dict(grid_z=3),
    dict(grid_z=3, goal_xyz=None, action_type="ordinal", obs_type="hansen"),
    dict(grid_z=2, agent_xyz=(2, 3, 0), obs_type="mdp_goal_vector"),
    dict(grid_z=5, goal_xyz=None, agent_xyz=(0, 0, 0), obs_type="hansen8",
         action_failure_probability=0.4, step_reward=-0.01, wall_reward=-0.5),
]


def _pair(kw, time_limit=12):
    return (gpt.make("MultistoryFourRooms-v0", time_limit=time_limit, **kw),
            gpt_torch.make("MultistoryFourRooms-v0", time_limit=time_limit,
                           device="cpu", **kw))


@pytest.mark.parametrize("kw", ENV_CASES)
def test_constructor_equals_jax(kw):
    je, te = _pair(kw)
    assert te.name == je.name and te.num_actions == je.num_actions
    np.testing.assert_array_equal(te.grid_np, je.grid_np)
    np.testing.assert_array_equal(te.valid_agent_states, je.valid_agent_states)
    np.testing.assert_array_equal(te.valid_goal_states, je.valid_goal_states)
    np.testing.assert_array_equal(te._valid_agent_zyx.numpy(),
                                  np.asarray(je._valid_agent_zyx))
    np.testing.assert_array_equal(te._valid_goal_zyx.numpy(),
                                  np.asarray(je._valid_goal_zyx))
    np.testing.assert_array_equal(te._cum, je._cum)
    for f in ("fixed_goal_zyx", "fixed_agent_zyx"):
        jv, tv = getattr(je, f), getattr(te, f)
        assert (jv is None) == (tv is None)
        if jv is not None:
            np.testing.assert_array_equal(jv, tv)
    _space_equal(je.observation_space, te.observation_space)
    assert je.action_space.n == te.action_space.n


def test_fixed_spawns_follow_the_reference_quirks():
    """A fixed goal always falls back to END_XYZ, at zyx = (Z-1, 7, 9); a
    fixed agent on a wall falls back to START_XYZ."""
    te = gpt_torch.make("MultistoryFourRooms-v0", grid_z=3,
                        goal_xyz=(1, 1, 0), agent_xyz=(2, 3, 0), device="cpu")
    assert te.fixed_goal_zyx.tolist() == [2, 7, 9]
    assert te.fixed_agent_zyx.tolist() == [0, 3, 2]
    te = gpt_torch.make("MultistoryFourRooms-v0", grid_z=2, agent_xyz=(0, 0, 0),
                        device="cpu")
    assert te.fixed_agent_zyx.tolist() == [0, 1, 1]
    assert len(te.valid_agent_states) == len(te.valid_goal_states) == 104


def _stair_starts(grid, B, rng):
    """Agents on walkable cells of every floor, half of them next to a
    stair square (so that the transits run)."""
    walk = np.stack(np.nonzero(grid > 0), -1)
    agent = walk[rng.integers(0, len(walk), B)]
    stairs = np.stack(np.nonzero(grid >= 2), -1)
    if len(stairs):
        near = stairs[rng.integers(0, len(stairs), B)] + \
            jms.ACTIONS_ORDINAL_Z[rng.integers(0, 8, B)]
        ok = grid[near[:, 0], near[:, 1], near[:, 2]] > 0
        agent = np.where((ok & (rng.random(B) < 0.5))[:, None], near, agent)
    return agent.astype(np.int32)


@pytest.mark.parametrize("kw", ENV_CASES)
def test_stages_equal_jax_on_identical_draws(kw):
    """K steps of exec_action, advance, apply_reset and observe, fed the
    same numpy uniforms, actions and spawn indices, on both packages."""
    je, te = _pair(kw)
    B, K = 256, 24
    rng = np.random.default_rng(3)
    agent_bank = np.asarray(je._valid_agent_zyx)
    goal_bank = np.asarray(je._valid_goal_zyx)

    def spawn(fixed, bank):
        if fixed is not None:
            return np.broadcast_to(np.asarray(fixed, np.int32), (B, 3)).copy()
        return bank[rng.integers(0, len(bank), B)]

    goal = spawn(je.fixed_goal_zyx, goal_bank)
    agent = _stair_starts(je.grid_np, B, rng)
    # a quarter start beside the goal, so that episodes end within K
    near = goal + jms.ACTIONS_ORDINAL_Z[rng.integers(0, 8, B)]
    ok = je.grid_np[near[:, 0], near[:, 1], near[:, 2]] > 0
    agent = np.where((ok & (rng.random(B) < 0.25))[:, None], near,
                     agent).astype(np.int32)
    elapsed = rng.integers(0, 12, B).astype(np.int32)
    js = JState(elapsed=jnp.asarray(elapsed), agent_zyx=jnp.asarray(agent),
                goal_zyx=jnp.asarray(goal))
    ts = TState(elapsed=_t(elapsed), agent_zyx=_t(agent), goal_zyx=_t(goal))
    _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "reset obs")
    n_done = n_floor_changes = 0
    for _ in range(K):
        a = rng.integers(0, je.num_actions, B).astype(np.int32)
        u = rng.random(B).astype(np.float32)
        jx = jax.vmap(je.exec_action)(jnp.asarray(a), jnp.asarray(u))
        tx = te.exec_action(_t(a), _t(u))
        _eq(jx, tx, "executed")
        jmid, jrew, jdone, jtrunc = jax.vmap(je.advance)(js, jx)
        tmid, trew, tdone, ttrunc = te.advance(ts, tx)
        for j, tt, what in ((jmid.agent_zyx, tmid.agent_zyx, "agent"),
                            (jmid.elapsed, tmid.elapsed, "elapsed"),
                            (jrew, trew, "reward"), (jdone, tdone, "done"),
                            (jtrunc, ttrunc, "trunc")):
            _eq(j, tt, what)
        n_floor_changes += int((np.asarray(jmid.agent_zyx)[:, 0]
                                != np.asarray(js.agent_zyx)[:, 0]).sum())
        mask = np.asarray(jdone | jtrunc)
        g_new = spawn(je.fixed_goal_zyx, goal_bank)
        a_new = spawn(je.fixed_agent_zyx, agent_bank)
        js = jax.vmap(je.apply_reset)(jmid, jnp.asarray(mask),
                                      jnp.asarray(g_new), jnp.asarray(a_new))
        ts = te.apply_reset(tmid, _t(mask), _t(g_new), _t(a_new))
        for j, tt, what in ((js.agent_zyx, ts.agent_zyx, "agent'"),
                            (js.goal_zyx, ts.goal_zyx, "goal'"),
                            (js.elapsed, ts.elapsed, "elapsed'")):
            _eq(j, tt, what)
        _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs")
        n_done += int(np.asarray(jdone).sum())
    assert n_done > 0  # the goal branch ran
    if je.grid_np.shape[0] > 1:
        assert n_floor_changes > 0  # stair transits ran


# (z, y, x) before, cardinal action, (z, y, x) after: up from below the NE
# stair (tests/test_msrooms.py:78), down onto floor 1's SW stair from the
# north, a wall bump while standing on a stair square (no transit), and a
# plain move
TRANSITS = [
    ((0, 2, 11), 0, (1, 11, 1)),
    ((1, 10, 1), 2, (0, 1, 11)),
    ((1, 11, 1), 2, (1, 11, 1)),
    ((0, 1, 10), 1, (1, 11, 1)),
    ((1, 5, 5), 1, (1, 5, 5)),
    ((1, 4, 4), 1, (1, 4, 5)),
]


@pytest.mark.parametrize("before,action,after", TRANSITS)
def test_stair_transit_teleports(before, action, after):
    """Climbing stairs moves the agent between floors at the right cells
    (reference msrooms.py:419-428): stair up NE -> next floor SW, stair
    down SW -> previous floor NE, only when the agent moved."""
    je, te = _pair(dict(grid_z=2, obs_type="vector_mdp", goal_xyz=None))
    goal = np.asarray([1, 7, 9], np.int32)
    js = JState(elapsed=jnp.int32(0), agent_zyx=jnp.asarray(before, jnp.int32),
                goal_zyx=jnp.asarray(goal))
    ts = TState(elapsed=torch.tensor(0, dtype=torch.int32),
                agent_zyx=torch.tensor(before, dtype=torch.int32),
                goal_zyx=_t(goal))
    jmid, jrew, jdone, _ = je.advance(js, jnp.int32(action))
    tmid, trew, tdone, _ = te.advance(ts, torch.tensor(action, dtype=torch.int32))
    assert tmid.agent_zyx.tolist() == list(after)
    _eq(jmid.agent_zyx, tmid.agent_zyx)
    _eq(jrew, trew)
    _eq(jdone, tdone)


@pytest.mark.parametrize("kw", ENV_CASES[1:3])
def test_step_vec_composes_its_stages(kw):
    """``step_vec`` is exec_action, advance, apply_reset and observe on the
    generator's draws in the JAX package's order (u, goal, agent); goals
    stay on the top floor and agents on walkable cells."""
    _, te = _pair(kw, time_limit=6)
    B = 512
    gen = torch.Generator().manual_seed(4)
    obs, st = te.reset_vec(gen, B)
    assert obs.shape[0] == B and st.agent_zyx.shape == (B, 3)
    assert (st.agent_zyx[:, 0] == 0).all()
    grid = te.grid_np
    for _ in range(8):
        a = torch.randint(0, te.num_actions, (B,), dtype=torch.int32)
        replay = torch.Generator().manual_seed(0)
        replay.set_state(gen.get_state())
        obs, st2, rew, done, trunc, info = te.step_vec(gen, st, a)
        u = torch.rand(B, generator=replay)
        mid, r2, d2, t2 = te.advance(st, te.exec_action(a, u))
        want = te.apply_reset(
            mid, d2 | t2,
            te._sample_spawn_vec(replay, B, te.fixed_goal_zyx, te._valid_goal_zyx),
            te._sample_spawn_vec(replay, B, te.fixed_agent_zyx,
                                 te._valid_agent_zyx))
        for x, y in ((st2.agent_zyx, want.agent_zyx), (st2.goal_zyx, want.goal_zyx),
                     (st2.elapsed, want.elapsed), (rew, r2), (done, d2),
                     (trunc, t2), (obs, te.observe(want)),
                     (info["terminal_state"].agent_zyx, mid.agent_zyx),
                     (info["reset_mask"], d2 | t2)):
            assert torch.equal(x, y)
        st = st2
        z, y, x = st.agent_zyx.T.numpy()
        assert (grid[z, y, x] > 0).all()
        assert (st.goal_zyx[:, 0] == grid.shape[0] - 1).all()


def test_single_env_protocol_and_registry_defaults():
    te = gpt_torch.make("MultistoryFourRooms-v0", device="cpu")
    je = gpt.make("MultistoryFourRooms-v0")
    assert te.name == je.name == "MultistoryFourRooms1__cardinal__mdp"
    assert (te.time_limit, te.num_actions, te.observation_space.n) == (500, 4, 104)
    assert (te.step_reward, te.wall_reward, te.goal_reward) == (0.0, 0.0, 1.0)
    np.testing.assert_array_equal(te._cum, je._cum)
    assert te.fixed_goal_zyx.tolist() == [0, 7, 9] and te.fixed_agent_zyx is None
    gen = torch.Generator().manual_seed(1)
    obs, st = te.reset(gen)
    assert obs.shape == () and st.agent_zyx.shape == (3,)
    for _ in range(20):
        obs, st, rew, done, trunc, info = te.step(
            gen, st, torch.tensor(1, dtype=torch.int32))
        assert obs.shape == () and rew.shape == () and done.dtype == torch.bool
        assert info["terminal_state"].agent_zyx.shape == (3,)
        assert te.observation_space.contains(obs.numpy())
