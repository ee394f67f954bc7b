"""Fused MultistoryFourRooms kernels of the PyTorch port against the JAX
package: the rollout's plain twin against the JAX Pallas kernel
(interpreted) on the same tape, bit for bit, and the Q trainer's twin
against ``make_fused_q_trainer_msrooms`` on the same tape: agents and reward
sums exact, Q to ``rtol=1e-5, atol=1e-6`` (JAX sums each step's updates in
f32 through ``dot_general`` with a bf16x2 split, the port exactly in int64
fixed point, rounded once; tables start from ``normal(0, 0.1)``, which has
no exact ties among actions).  The CUDA kernels against the twins on the
card are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import fused_qlearning as jfq
from gym_po_tpu.ops import make_fused_msrooms_rollout as jax_rollout
from gym_po_tpu_torch.agents import fused_q_learning
from gym_po_tpu_torch.ops import (
    make_fused_msrooms_rollout,
    make_fused_q_trainer_msrooms,
    q_to_banks,
)
from gym_po_tpu_torch.ops.msrooms_dynamics import MSRoomsDynamics

from _tape import make_tape

W = 128
SEED0 = jnp.asarray([3], jnp.int32)
Q_TOL = dict(rtol=1e-5, atol=1e-6)


def start_cells(env, B, seed):
    """Flat agent cells on every floor, a third of them next to a stair
    square and a sixth next to their goal; goals from the top-floor bank (or
    the fixed one)."""
    rng = np.random.default_rng(seed)
    grid = env.grid_np
    flat = grid.reshape(-1)
    walk = np.flatnonzero(flat > 0)
    agent = rng.choice(walk, B)
    goal = rng.choice(np.asarray(env.valid_goal_states), B)
    if env.fixed_goal_zyx is not None:
        goal[:] = np.ravel_multi_index(tuple(env.fixed_goal_zyx), grid.shape)
    act = np.asarray(env._actions)
    disp = act[:, 1] * grid.shape[2] + act[:, 2]
    stairs = np.flatnonzero(flat >= 2)
    for p, centres in ((0.33, stairs), (0.17, goal)):
        if not len(centres):
            continue
        near = rng.choice(centres, B) if centres is stairs else centres
        near = near + disp[rng.integers(0, len(disp), B)]
        ok = (near >= 0) & (near < flat.size)
        ok[ok] = flat[near[ok]] > 0
        agent = np.where(ok & (rng.random(B) < p), near, agent)
    return (agent.astype(np.int32).reshape(-1, W),
            goal.astype(np.int32).reshape(-1, W))


# env kwargs, B, K, rows_per_tile (1: two tiles at B = 256), stats
CASES = [
    # the JAX tape test's case (tests/test_tape_rollouts.py:369)
    (dict(grid_z=3, obs_type="mdp", goal_xyz=None, time_limit=25), 256, 60,
     128, False),
    (dict(grid_z=3, goal_xyz=None, time_limit=25), 256, 40, 1, True),
    (dict(time_limit=12), 256, 40, 128, True),  # the registry's defaults
    (dict(grid_z=4, action_type="ordinal", agent_xyz=(1, 1, 0),
          time_limit=15), 256, 40, 1, True),
    (dict(grid_z=2, goal_xyz=None, agent_xyz=(3, 2, 0), step_reward=-0.01,
          wall_reward=-0.5, action_failure_probability=0.4, time_limit=9),
     256, 40, 128, True),
]


@pytest.mark.parametrize("kw,B,K,rows_per_tile,stats", CASES)
def test_rollout_twin_with_tape_equals_jax_kernel(kw, B, K, rows_per_tile, stats):
    je = gpt.make("MultistoryFourRooms-v0", **kw)
    te = gpt_torch.make("MultistoryFourRooms-v0", device="cpu", **kw)
    jrun = jax_rollout(je, B, K, rows_per_tile=rows_per_tile, interpret=True,
                       episode_stats=stats, rng_tape=True)
    trun = make_fused_msrooms_rollout(te, B, K, rows_per_tile=rows_per_tile,
                                      episode_stats=stats, rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites
    R = min(rows_per_tile, B // W)
    tape = make_tape(np.random.default_rng(17), jrun.n_sites, K, R,
                     grid=B // W // R)
    a0, g0 = start_cells(je, B, 1)
    jout = jrun(SEED0, jnp.asarray(a0), jnp.asarray(g0), jnp.asarray(tape))
    tout = trun(3, torch.as_tensor(a0), torch.as_tensor(g0),
                torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    assert len(jout) == len(tout) == (6 if stats else 3)
    assert tout[0].dtype == tout[1].dtype == torch.int32
    for j, t in zip(jout, tout):
        assert t.shape == (B // W, W)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    agent = tout[0].numpy().reshape(-1)
    assert (te.grid_np.reshape(-1)[agent] > 0).all()
    assert len(np.unique(agent)) > 1
    if stats:
        assert tout[5].sum() > 0  # episodes completed


def test_rollout_rejects_bad_shapes_and_out_of_range_agents():
    env = gpt_torch.make("MultistoryFourRooms-v0", grid_z=2, goal_xyz=None,
                         time_limit=10, device="cpu")
    with pytest.raises(ValueError):
        make_fused_msrooms_rollout(env, 100, 10)  # not a multiple of 128
    run = make_fused_msrooms_rollout(env, 256, 8, rng_tape=True)
    a = torch.zeros(2, W, dtype=torch.int32)
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="tape must have shape"):
        run(0, a, a, tape[:8])
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, a.to("meta"), a.to("meta"), tape.to("meta"))
    run = make_fused_msrooms_rollout(env, 256, 16, episode_stats=True)
    a0, g0 = (torch.as_tensor(x) for x in start_cells(env, 256, 3))
    idx = torch.tensor([0, 77, 200])
    bad = a0.clone()
    bad.view(-1)[idx] = torch.tensor([-1, env.grid_np.size, 2**31 - 1],
                                     dtype=torch.int32)
    want, got = run(5, a0, g0), run(5, bad, g0)
    keep = torch.ones(256, dtype=torch.bool)
    keep[idx] = False
    for g in got[:2]:
        assert (g.view(-1)[idx] == -1).all()
    for g in got[2:]:
        assert torch.isnan(g.view(-1)[idx]).all()
    for g, w in zip(got, want):
        assert torch.equal(g.view(-1)[keep], w.view(-1)[keep])


def test_philox_rollout_climbs_and_keeps_goals_on_top():
    """Perf mode: from the ground floor some agents climb to the top floor
    within one call; random goals stay on the top floor; the draws do not
    depend on the tiles."""
    env = gpt_torch.make("MultistoryFourRooms-v0", grid_z=2, goal_xyz=None,
                         time_limit=400, device="cpu")
    dyn = MSRoomsDynamics(env)
    run = make_fused_msrooms_rollout(env, 1024, 200)
    rng = np.random.default_rng(0)
    a0 = torch.as_tensor(rng.choice(env.valid_agent_states, 1024).astype(
        np.int32)).reshape(-1, W)
    g0 = torch.as_tensor(rng.choice(env.valid_goal_states, 1024).astype(
        np.int32)).reshape(-1, W)
    agent, goal, rew = run(11, a0, g0)
    floors = torch.bincount((agent // dyn.HW).view(-1).long(), minlength=2)
    assert (floors > 0).all()
    assert ((goal // dyn.HW) == 1).all()
    r1 = make_fused_msrooms_rollout(env, 1024, 200, rows_per_tile=1)(11, a0, g0)
    for x, y in zip(r1, (agent, goal, rew)):
        assert torch.equal(x, y)


def random_banks(env, rng):
    n_obs = int(env.observation_space.n)
    A = int(env.num_actions)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)
    return q_to_banks(q0)


# the JAX tape test's case (tests/test_tape_trainers.py:525), averaged and
# summed, and ordinal actions with hansen obs and a fixed agent
TRAINER_CASES = [
    (dict(grid_z=3), True),
    (dict(grid_z=3), False),
    (dict(grid_z=2, action_type="ordinal", obs_type="hansen",
          agent_xyz=(1, 1, 0)), True),
]


@pytest.mark.parametrize("kw,average", TRAINER_CASES)
def test_q_trainer_twin_with_tape_equals_jax_kernel(kw, average):
    B, K = 1024, 16
    lr, eps, gamma = 0.2, 0.3, 0.9
    je = gpt.make("MultistoryFourRooms-v0", time_limit=8, **kw)
    te = gpt_torch.make("MultistoryFourRooms-v0", time_limit=8, device="cpu", **kw)
    jrun = jfq.make_fused_q_trainer_msrooms(je, B, K, gamma,
                                            average_duplicates=average,
                                            interpret=True, rng_tape=True)
    trun = make_fused_q_trainer_msrooms(te, B, K, gamma,
                                        average_duplicates=average,
                                        rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites == 5
    rng = np.random.default_rng(8)
    a0, _ = start_cells(je, B, 6)
    qb0 = random_banks(je, rng)
    tape = make_tape(rng, jrun.n_sites, K, B // W)
    ja, jq, jr = jrun(SEED0, lr, eps, jnp.asarray(a0), jnp.asarray(qb0),
                      jnp.asarray(tape))
    ta, tq, tr = trun(3, lr, eps, torch.as_tensor(a0), torch.as_tensor(qb0),
                      torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **Q_TOL)
    assert 0 < np.count_nonzero(tq.numpy() != qb0) < qb0.size
    assert (tr.numpy() > 0).any()  # goals reached


def test_q_trainer_respawns_from_the_ground_floor_bank_even_with_a_fixed_agent():
    """The JAX trainer draws the respawn from the ground-floor bank whatever
    the env's fixed agent says (gym_po_tpu/ops/fused_qlearning.py:874); the
    port keeps it (ROADMAP Queue 3)."""
    env = gpt_torch.make("MultistoryFourRooms-v0", agent_xyz=(1, 1, 0),
                         time_limit=3, device="cpu")
    run = make_fused_q_trainer_msrooms(env, 1024, 8)
    a0 = torch.full((8, W), 14, dtype=torch.int32)  # (0, 1, 1): the fixed cell
    agent, _, _ = run(1, 0.1, 1.0, a0, torch.zeros(32, W))
    assert len(torch.unique(agent)) > 20


def test_trainer_guards_raise():
    def make(**kw):
        return gpt_torch.make("MultistoryFourRooms-v0", device="cpu", **kw)

    with pytest.raises(ValueError, match="512"):  # 5 floors: 520 observations
        make_fused_q_trainer_msrooms(make(grid_z=5), 1024, 8)
    make_fused_q_trainer_msrooms(make(grid_z=4), 1024, 8)  # 416: taken
    with pytest.raises(ValueError, match="fixed goal"):
        make_fused_q_trainer_msrooms(make(goal_xyz=None), 1024, 8)
    with pytest.raises(ValueError, match="Discrete"):
        make_fused_q_trainer_msrooms(make(obs_type="mdp_vector"), 1024, 8)
    with pytest.raises(ValueError, match="1024"):
        make_fused_q_trainer_msrooms(make(), 512, 8)
    with pytest.raises(ValueError, match="128"):
        make_fused_q_trainer_msrooms(make(), 1000, 8)
    with pytest.raises(ValueError, match="lam"):
        fused_q_learning(make(), 0, [(0.1, 0.1, 8)], num_envs=1024,
                         chunk_steps=8, lam=0.5)
    with pytest.raises(ValueError, match="expected_sarsa"):
        fused_q_learning(make(), 0, [(0.1, 0.1, 8)], num_envs=1024,
                         chunk_steps=8, expected_sarsa=True)


def test_fused_q_learning_msrooms_runs_on_the_cpu():
    env = gpt_torch.make("MultistoryFourRooms-v0", device="cpu")
    sched = [(0.2, 0.3, 32), (0.05, 0.1, 16)]
    q, hist = fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=16)
    assert isinstance(q, np.ndarray) and q.dtype == np.float32
    assert q.shape == (env.observation_space.n, env.action_space.n)
    assert len(hist) == 3 and all(np.isfinite(h) and 0 <= h <= 1 for h in hist)
    assert np.count_nonzero(q) > 0
    q2, hist2 = fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=16)
    np.testing.assert_array_equal(q, q2)  # a seed fixes the whole run
    assert hist == hist2
