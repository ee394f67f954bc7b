"""Fused ROOMS rollout of the PyTorch port: its plain twin against the JAX
Pallas kernel (interpreted) on the same tape, bit for bit.  The CUDA kernel
against the twin on the card is in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import make_fused_rooms_rollout as jax_rollout
from gym_po_tpu_torch.ops import make_fused_rooms_rollout
from gym_po_tpu_torch.ops.rooms_dynamics import RoomsDynamics

from _tape import make_tape

B, K = 256, 32
W = 128


def _start_cells(env, B, seed):
    """Flat agent and goal cells on walkable cells (goal: the fixed one
    where the env has it), a third of the agents next to their goal."""
    rng = np.random.default_rng(seed)
    H, GW = env.grid_np.shape
    valid = np.flatnonzero(env.grid_np.reshape(-1) >= 0)
    goal = rng.choice(valid, B)
    if env.fixed_goal_yx is not None:
        goal[:] = env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1]
    agent = rng.choice(valid, B)
    act = np.asarray(env._actions)
    disp = act[:, 0] * GW + act[:, 1]
    near = goal + disp[rng.integers(0, len(disp), B)]
    ok = (near >= 0) & (near < H * GW)
    ok[ok] = env.grid_np.reshape(-1)[near[ok]] >= 0
    agent = np.where(ok & (rng.random(B) < 0.33), near, agent)
    return (agent.astype(np.int32).reshape(-1, W),
            goal.astype(np.int32).reshape(-1, W))


# layout, env kwargs, rows_per_tile (1: two tiles at B = 256), stats
CASES = [
    ("4", {}, 128, False),
    ("4", {}, 1, True),
    ("4", {"goal_xy": None}, 1, True),
    ("16", {"action_type": "cardinal", "goal_xy": None}, 128, False),
    ("32b", {"agent_xy": (1, 1), "action_failure_probability": 0.4}, 1, True),
    ("1", {"goal_xy": None, "agent_xy": (1, 1), "wall_reward": -0.5,
           "step_reward": -0.01}, 128, True),
]


@pytest.mark.parametrize("layout,kw,rows_per_tile,stats", CASES)
def test_twin_with_tape_equals_jax_kernel(layout, kw, rows_per_tile, stats):
    je = gpt.make("Rooms-v0", layout=layout, time_limit=12, **kw)
    te = gpt_torch.make("Rooms-v0", layout=layout, time_limit=12,
                        device="cpu", **kw)
    jrun = jax_rollout(je, B, K, rows_per_tile=rows_per_tile, interpret=True,
                       episode_stats=stats, rng_tape=True)
    trun = make_fused_rooms_rollout(te, B, K, rows_per_tile=rows_per_tile,
                                    episode_stats=stats, rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites
    R = min(rows_per_tile, B // W)
    tape = make_tape(np.random.default_rng(7), jrun.n_sites, K, R,
                     grid=B // W // R)
    a0, g0 = _start_cells(je, B, 1)
    jout = jrun(jnp.asarray([3], jnp.int32), jnp.asarray(a0), jnp.asarray(g0),
                jnp.asarray(tape))
    tout = trun(3, torch.as_tensor(a0), torch.as_tensor(g0),
                torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    assert len(jout) == len(tout) == (6 if stats else 3)
    assert tout[0].dtype == tout[1].dtype == torch.int32
    for j, t in zip(jout, tout):
        assert t.shape == (B // W, W)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    agent = tout[0].numpy().reshape(-1)
    assert (te.grid_np.reshape(-1)[agent] >= 0).all()
    assert len(np.unique(agent)) > 1
    if stats:
        assert tout[5].sum() > 0  # episodes completed


def test_rejects_bad_shapes_and_arguments():
    env = gpt_torch.make("Rooms-v0", device="cpu")
    with pytest.raises(ValueError):
        make_fused_rooms_rollout(env, 100, 10)  # not a multiple of 128
    with pytest.raises(ValueError):
        make_fused_rooms_rollout(env, 384, 10, rows_per_tile=2)
    run = make_fused_rooms_rollout(env, 256, 8, rng_tape=True)
    a = torch.zeros(2, W, dtype=torch.int32)
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="tape must have shape"):
        run(0, a, a, tape[:8])
    with pytest.raises(ValueError, match="tape argument"):
        run(0, a, a)
    with pytest.raises(ValueError):
        run(0, a, a.to(torch.int64), tape)
    with pytest.raises(ValueError):
        run(0, a, torch.zeros(4, W, dtype=torch.int32), tape)
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, a.to("meta"), a.to("meta"), tape.to("meta"))


def test_out_of_range_agent_gives_minus_one_and_nan():
    env = gpt_torch.make("Rooms-v0", goal_xy=None, time_limit=10, device="cpu")
    run = make_fused_rooms_rollout(env, B, 16, episode_stats=True)
    a0, g0 = (torch.as_tensor(x) for x in _start_cells(env, B, 3))
    idx = torch.tensor([0, 77, 200])
    bad = a0.clone()
    bad.view(-1)[idx] = torch.tensor([-1, env.grid_np.size, 2**31 - 1],
                                     dtype=torch.int32)
    want, got = run(5, a0, g0), run(5, bad, g0)
    keep = torch.ones(B, dtype=torch.bool)
    keep[idx] = False
    for g in got[:2]:
        assert (g.view(-1)[idx] == -1).all()
    for g in got[2:]:
        assert torch.isnan(g.view(-1)[idx]).all()
    for g, w in zip(got, want):
        assert torch.equal(g.view(-1)[keep], w.view(-1)[keep])


def test_goal_outside_the_grid_is_never_reached():
    """Layout '32''s default goal lies outside its grid in both packages
    (ROADMAP Queue 3): it is compared, never looked up, so episodes end by
    truncation alone."""
    env = gpt_torch.make("Rooms-v0", layout="32", time_limit=8, device="cpu")
    dyn = RoomsDynamics(env)
    assert dyn.goal >= dyn.ncells
    run = make_fused_rooms_rollout(env, B, 20, episode_stats=True)
    a0, g0 = (torch.as_tensor(x) for x in _start_cells(env, B, 4))
    agent, goal, rew, _, ep_len, ep_cnt = run(2, a0, g0)
    assert (rew == 0).all() and (goal == dyn.goal).all()
    assert (ep_len == 9 * ep_cnt).all() and (ep_cnt == 2).all()


def test_philox_rollout_visits_the_layout():
    """Perf mode: after one call from a single start cell the agents spread
    over most walkable cells, and the goal rate is near a random walk's."""
    env = gpt_torch.make("Rooms-v0", layout="1", device="cpu")
    run = make_fused_rooms_rollout(env, 1024, 64)
    start = torch.full((8, W), int(env.valid_states[0]), dtype=torch.int32)
    goal = torch.full_like(start, RoomsDynamics(env).goal)
    agent, goal2, rew = run(11, start, goal)
    assert (goal2 == goal).all()
    assert len(torch.unique(agent)) > 0.5 * len(env.valid_states)
    r1 = make_fused_rooms_rollout(env, 1024, 64, rows_per_tile=1)(11, start, goal)
    for x, y in zip(r1, (agent, goal2, rew)):
        assert torch.equal(x, y)  # Philox draws do not depend on the tiles


def _far_cells(env, B, K, seed):
    """Flat agent and goal cells, each agent more than K moves from its goal
    (a move changes each coordinate by at most one): the fixed goal where
    the env has one, else a walkable cell per env that has such cells."""
    rng = np.random.default_rng(seed)
    GW = env.grid_np.shape[1]
    valid = np.flatnonzero(env.grid_np.reshape(-1) >= 0)
    vy, vx = np.divmod(valid, GW)
    far = np.maximum(abs(vy[:, None] - vy), abs(vx[:, None] - vx)) > K
    if env.fixed_goal_yx is not None:
        goal = np.full(B, env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    else:
        goal = rng.choice(valid[far.any(1)], B)
    agent = np.array([rng.choice(valid[far[np.searchsorted(valid, g)]])
                      for g in goal])
    return (agent.astype(np.int32).reshape(-1, W),
            goal.astype(np.int32).reshape(-1, W))


@pytest.mark.parametrize("time_limit", [12, 1])
@pytest.mark.parametrize("kw", [{}, {"goal_xy": None}],
                         ids=["fixed-goal", "random-goal"])
def test_spawn_draws_are_discarded_where_no_env_resets(kw, time_limit):
    """The ROOMS kernel draws the respawns (site 3, and 4 with a random
    goal) only where an episode ends.  Agents more than K = 8 moves from
    their goals with a time limit past K cannot end one, so two tapes that
    differ only at the spawn sites give the JAX kernel (interpreted) and
    the twin the same outputs, each equal to the other.  At time limit 1
    every env resets every second step, and the same change moves the
    outputs (the control)."""
    B, K, R = 256, 8, 1
    je = gpt.make("Rooms-v0", time_limit=time_limit, **kw)
    te = gpt_torch.make("Rooms-v0", time_limit=time_limit, device="cpu", **kw)
    jrun = jax_rollout(je, B, K, rows_per_tile=R, interpret=True,
                       episode_stats=True, rng_tape=True)
    trun = make_fused_rooms_rollout(te, B, K, rows_per_tile=R,
                                    episode_stats=True, rng_tape=True)
    n = trun.n_sites
    assert n == jrun.n_sites == 4 + ("goal_xy" in kw)
    grid = B // W // R
    tape = make_tape(np.random.default_rng(43), n, K, R, grid=grid)
    t5 = tape.copy().reshape(grid, n, K, R, W)
    rng = np.random.default_rng(44)
    for j in range(3, n):  # the spawn sites
        t5[:, j] = rng.integers(-2**31, 2**31, t5[:, j].shape).astype(np.int32)
    other = t5.reshape(tape.shape)
    a0, g0 = _far_cells(je, B, K, 45)
    outs = []
    for t in (tape, other):
        jout = [np.asarray(x) for x in
                jrun(jnp.asarray([3], jnp.int32), jnp.asarray(a0),
                     jnp.asarray(g0), jnp.asarray(t))]
        tout = [x.numpy() for x in
                trun(3, torch.as_tensor(a0), torch.as_tensor(g0),
                     torch.as_tensor(t))]
        for j, o in zip(jout, tout):
            np.testing.assert_array_equal(j, o)
        outs.append(tout)
    ep_cnt = outs[0][5]
    if time_limit == 12:
        assert (ep_cnt == 0).all()
        assert (outs[0][0] != a0).mean() > 0.5  # the agents moved
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    else:
        assert (ep_cnt == K // 2).all()
        assert not np.array_equal(outs[0][0], outs[1][0])
        if "goal_xy" in kw:
            assert not np.array_equal(outs[0][1], outs[1][1])
