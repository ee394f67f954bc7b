"""Vector layer of the PyTorch port against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs.taxi import TaxiState as JTaxiState
from gym_po_tpu.vector import (
    EpisodeStatsState as JStats,
    RecordEpisodeStatistics as JRecord,
    rollout as jrollout,
)
from gym_po_tpu_torch.envs.taxi import TaxiState as TTaxiState
from gym_po_tpu_torch.vector import (
    EpisodeStatsState as TStats,
    RecordEpisodeStatistics as TRecord,
    VecEnv,
    rollout as trollout,
)


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(), err_msg=what)


@pytest.mark.parametrize("env_id", ["Taxi-v4", "ExtendedHansenTaxi-v4"])
def test_rollout_with_move_only_policy_equals_jax(env_id):
    """A fixed move-only policy table and K below the time limit: no env can
    finish, so the draws are all masked out and both packages' rollouts
    must agree exactly although their random streams differ."""
    je, te = gpt.make(env_id), gpt_torch.make(env_id, device="cpu")
    n_obs = je.observation_space.n
    pol = (np.arange(n_obs) * 7 % 4).astype(np.int32)  # moves only
    B, K = 256, 32
    s0 = np.random.default_rng(3).choice(je.tables.valid_init, B).astype(np.int32)
    z = np.zeros(B, np.int32)
    jst = JTaxiState(elapsed=jnp.asarray(z), s=jnp.asarray(s0), completed=jnp.asarray(z))
    tst = TTaxiState(elapsed=torch.as_tensor(z), s=torch.as_tensor(s0),
                     completed=torch.as_tensor(z))
    pol_j, pol_t = jnp.asarray(pol), torch.as_tensor(pol)
    jtraj, (jobs, jfin) = jrollout(je, jax.random.PRNGKey(9), lambda k, o: pol_j[o],
                                   B, K, init=(je.observe(jst), jst))
    ttraj, (tobs, tfin) = trollout(te, torch.Generator().manual_seed(9),
                                   lambda g, o: pol_t[o.long()], B, K,
                                   init=(te.observe(tst), tst))
    for f in ("obs", "action", "reward", "done", "truncated"):
        _eq(getattr(jtraj, f), getattr(ttraj, f), f)
        assert getattr(ttraj, f).shape == (K, B)
    _eq(jobs, tobs, "final obs")
    for f in ("s", "elapsed", "completed"):
        _eq(getattr(jfin, f), getattr(tfin, f), f)


def test_rollout_random_policy_shapes_and_infos():
    env = gpt_torch.make("HansenTaxi-v4", time_limit=10, device="cpu")
    venv = VecEnv(env, 64)
    assert venv.observation_space.shape == (64,)
    assert venv.single_action_space.n == 5
    obs, st = venv.reset(torch.Generator().manual_seed(0))
    traj, (obs_f, st_f) = trollout(env, torch.Generator().manual_seed(1), None,
                                   64, 30, init=(obs, st), keep_infos=True)
    assert traj.reward.shape == (30, 64) and traj.reward.dtype == torch.float32
    assert traj.info["reset_mask"].shape == (30, 64)
    assert traj.info["terminal_state"].s.shape == (30, 64)
    assert traj.truncated.any()  # time_limit=10 within 30 steps
    assert (traj.info["terminal_state"].elapsed[traj.truncated] == 11).all()


def test_episode_statistics_accounting_equals_jax():
    """``_account`` on identical step outputs, with episodes finishing
    mid-batch at different steps in different envs."""
    rng = np.random.default_rng(4)
    B, T = 64, 40
    je, te = JRecord(gpt.make("Taxi-v4")), TRecord(gpt_torch.make("Taxi-v4", device="cpu"))
    z_i, z_f = np.zeros(B, np.int32), np.zeros(B, np.float32)
    jinner = JTaxiState(elapsed=jnp.asarray(z_i), s=jnp.asarray(z_i),
                        completed=jnp.asarray(z_i))
    tinner = TTaxiState(elapsed=torch.as_tensor(z_i), s=torch.as_tensor(z_i),
                        completed=torch.as_tensor(z_i))
    jst = JStats(elapsed=jinner.elapsed, env_state=jinner,
                 episode_return=jnp.asarray(z_f), episode_length=jnp.asarray(z_i),
                 returned_return=jnp.asarray(z_f), returned_length=jnp.asarray(z_i))
    tst = TStats(elapsed=tinner.elapsed, env_state=tinner,
                 episode_return=torch.as_tensor(z_f),
                 episode_length=torch.as_tensor(z_i),
                 returned_return=torch.as_tensor(z_f),
                 returned_length=torch.as_tensor(z_i))
    account = jax.jit(je._account)
    finished = 0
    for t in range(T):
        rew = rng.choice(np.float32([1.0, -0.5, -0.05]), B)
        done = rng.random(B) < 0.08
        trunc = rng.random(B) < 0.03
        elapsed = rng.integers(0, 200, B).astype(np.int32)
        jin = jinner.replace(elapsed=jnp.asarray(elapsed))
        tin = tinner.replace(elapsed=torch.as_tensor(elapsed))
        jout = account(jst, (jnp.asarray(z_i), jin, jnp.asarray(rew),
                             jnp.asarray(done), jnp.asarray(trunc), {}))
        tout = te._account(tst, (torch.as_tensor(z_i), tin, torch.as_tensor(rew),
                                 torch.as_tensor(done), torch.as_tensor(trunc), {}))
        jst, tst = jout[1], tout[1]
        for f in ("elapsed", "episode_return", "episode_length",
                  "returned_return", "returned_length"):
            _eq(getattr(jst, f), getattr(tst, f), f)
            assert getattr(tst, f).dtype == (
                torch.float32 if f.endswith("_return") else torch.int32)
        for k in ("episode_return", "episode_length", "episode_done"):
            _eq(jout[5][k], tout[5][k], k)
        finished += int((done | trunc).sum())
    assert finished > B  # many episodes ended mid-batch


def test_episode_statistics_wrapper_step_vec():
    env = TRecord(gpt_torch.make("Taxi-v4", time_limit=5, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    obs, st = env.reset_vec(gen, 32)
    for _ in range(6):
        a = env.action_space.sample_vec(gen, 32)
        obs, st, rew, done, trunc, info = env.step_vec(gen, st, a)
    # every env truncated at step 6 (strict > 5) unless it finished earlier
    assert (info["episode_done"] | (st.returned_length > 0)).all()
    assert (info["episode_length"][trunc] == 6).all()
    _eq(env.observe_vec(st), obs)
