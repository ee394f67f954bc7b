"""The fused CRooms kernels of the PyTorch port, their plain twins against the
JAX Pallas kernels (interpreted) on the same tape: the rollout and the Q
trainer.

With XLA's ``log``/``cos`` set into ``ops/kernel_rng`` (the ``_log``/``_cos``
seam) the twins equal the JAX kernels bit for bit (the trainer's Q to rtol
1e-5: the JAX scatter rounds its operand through bf16x2, the port sums in
fixed point).  With torch's own libm, which differs from XLA's in the last
bit for a few per cent of inputs, the rollout's rewards, goals and reward
sums stay exact and its positions and velocities agree to 1e-5.  The CUDA
kernels against the twins on the card are in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import make_fused_crooms_rollout as jax_rollout
from gym_po_tpu.ops import make_fused_q_trainer_crooms as jax_trainer
from gym_po_tpu.ops import q_to_banks
from gym_po_tpu_torch.ops import (
    kernel_rng,
    make_fused_crooms_rollout,
    make_fused_q_trainer_crooms,
)

from _tape import make_tape

W = 128
_jlog, _jcos = jax.jit(jnp.log), jax.jit(jnp.cos)


def _xla(fn):
    return lambda x: torch.from_numpy(np.array(fn(x.numpy())))


@pytest.fixture
def xla_libm(monkeypatch):
    """The twins' Box-Muller through XLA's CPU log and cos."""
    monkeypatch.setattr(kernel_rng, "_log", _xla(_jlog))
    monkeypatch.setattr(kernel_rng, "_cos", _xla(_jcos))


def _state6(je, B, key=2):
    """(py, px, vy, vx, gy, gx) f32 tiles from the JAX package's reset, with
    uniform velocities in [-1, 1) when the env integrates them."""
    _, st = je.reset_vec(jax.random.PRNGKey(key), B)
    vel = np.asarray(st.vel_yx)
    if je.use_velocity:
        vel = np.random.default_rng(key).uniform(-1, 1, vel.shape).astype(np.float32)
    cols = (st.agent_yx[:, 0], st.agent_yx[:, 1], vel[:, 0], vel[:, 1],
            st.goal_yx[:, 0], st.goal_yx[:, 1])
    return [np.array(c, np.float32).reshape(-1, W) for c in cols]


def _rollouts(kw, B, K, rows_per_tile=128, stats=False, tape_seed=13):
    je = gpt.make("CRooms-v0", **kw)
    te = gpt_torch.make("CRooms-v0", device="cpu", **kw)
    jrun = jax_rollout(je, B, K, rows_per_tile=rows_per_tile, interpret=True,
                       episode_stats=stats, rng_tape=True)
    trun = make_fused_crooms_rollout(te, B, K, rows_per_tile=rows_per_tile,
                                     episode_stats=stats, rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape and trun.n_sites == jrun.n_sites
    R = min(rows_per_tile, B // W)
    tape = make_tape(np.random.default_rng(tape_seed), jrun.n_sites, K, R,
                     grid=B // W // R)
    s6 = _state6(je, B)
    jout = jrun(jnp.asarray([3], jnp.int32), *map(jnp.asarray, s6),
                jnp.asarray(tape))
    return [np.asarray(x) for x in jout], trun, s6, tape


NAMES = "py px vy vx gy gx racc ep_ret ep_len ep_cnt".split()
# env kwargs, rows_per_tile (1: two tiles at B = 256), episode stats
ROLLOUT_CASES = [
    (dict(goal_xy=None, time_limit=25), 128, False),
    (dict(goal_xy=None, use_velocity=True, time_limit=25), 1, True),
    (dict(time_limit=25, agent_xy=(2, 3), step_reward=-0.01,
          wall_reward=-0.1), 128, True),
    (dict(layout="16", cell_size=0.5, goal_xy=None, use_velocity=True,
          action_std=0.5, action_power=0.7, time_limit=30), 1, False),
]


@pytest.mark.parametrize("kw,rows_per_tile,stats", ROLLOUT_CASES)
def test_rollout_twin_with_xla_libm_equals_jax_kernel(xla_libm, kw,
                                                      rows_per_tile, stats):
    B, K = 256, 60
    jout, trun, s6, tape = _rollouts(kw, B, K, rows_per_tile, stats)
    tout = trun(3, *map(torch.as_tensor, s6), torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    assert len(tout) == len(jout) == (10 if stats else 7)
    for name, j, t in zip(NAMES, jout, tout):
        assert t.dtype == torch.float32 and t.shape == (B // W, W), name
        np.testing.assert_array_equal(j, t.numpy(), err_msg=name)
    assert len(np.unique(jout[0])) > 10  # moves and wall resamples happened
    if stats:
        assert tout[9].sum() > 0  # episodes completed


@pytest.mark.parametrize("use_velocity", [False, True])
def test_rollout_twin_with_torch_libm_is_within_atol(use_velocity):
    """torch's CPU log/cos differ from XLA's in the last bit for some
    inputs: a normal moves by an ulp and a position by a few.  At the JAX
    tape test's shape the rewards, goals and sums stay exact."""
    B, K = 256, 60
    jout, trun, s6, tape = _rollouts(
        dict(goal_xy=None, use_velocity=use_velocity, time_limit=25), B, K)
    tout = [t.numpy() for t in trun(3, *map(torch.as_tensor, s6),
                                    torch.as_tensor(tape))]
    for name, j, t in zip(NAMES, jout, tout):
        if name in ("gy", "gx", "racc"):
            np.testing.assert_array_equal(j, t, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5, err_msg=name)


def test_rollout_refuses_what_the_kernel_does_not_take():
    env = gpt_torch.make("CRooms-v0", action_type="ordinal", device="cpu")
    with pytest.raises(ValueError, match="yx"):
        make_fused_crooms_rollout(env, 256, 8)
    env = gpt_torch.make("CRooms-v0", device="cpu")
    with pytest.raises(ValueError):
        make_fused_crooms_rollout(env, 100, 8)
    with pytest.raises(ValueError):
        make_fused_crooms_rollout(env, 384, 8, rows_per_tile=2)
    run = make_fused_crooms_rollout(env, 256, 8, rng_tape=True)
    f = torch.zeros(2, W)
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="tape must have shape"):
        run(0, f, f, f, f, f, f, tape[:8])
    with pytest.raises(ValueError, match="tape argument"):
        run(0, f, f, f, f, f, f)
    with pytest.raises(ValueError, match="state tile"):
        run(0, f, f, f, f, f, f.double(), tape)
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, *(f.to("meta"),) * 6, tape.to("meta"))


def test_philox_rollout_stays_in_range_and_ignores_the_tiling():
    """Perf mode: positions stay in [0, pos_hi], velocities in [-5, 5],
    goals at walkable cell centers; the draws do not depend on the tiles."""
    env = gpt_torch.make("CRooms-v0", goal_xy=None, use_velocity=True,
                         time_limit=40, device="cpu")
    B, K = 1024, 64
    _, st = env.reset_vec(torch.Generator().manual_seed(3), B)
    s6 = [c.reshape(-1, W).contiguous() for c in (
        st.agent_yx[:, 0], st.agent_yx[:, 1], st.vel_yx[:, 0], st.vel_yx[:, 1],
        st.goal_yx[:, 0], st.goal_yx[:, 1])]
    out = make_fused_crooms_rollout(env, B, K, episode_stats=True)(11, *s6)
    hi = env._pos_hi.astype(np.float32)
    assert ((out[0] >= 0) & (out[0] <= hi[0])).all()
    assert ((out[1] >= 0) & (out[1] <= hi[1])).all()
    assert (out[2].abs() <= 5).all() and (out[3].abs() <= 5).all()
    g = np.stack([out[4].numpy().reshape(-1), out[5].numpy().reshape(-1)], -1) - 0.5
    assert (env.grid_np[g[:, 0].astype(int), g[:, 1].astype(int)] >= 0).all()
    assert (out[9] >= 1).all()  # every env truncated at least once
    again = make_fused_crooms_rollout(env, B, K, rows_per_tile=1,
                                      episode_stats=True)(11, *s6)
    for x, y in zip(out, again):
        assert torch.equal(x, y)


# ------------------------------------------------------------- Q trainer
# env kwargs, averaged duplicates, lr
TRAINER_CASES = [
    (dict(action_type="ordinal"), True, 0.2),
    (dict(action_type="ordinal", use_velocity=True), False, 0.002),
    (dict(action_type="cardinal", agent_xy=(1, 1), obs_type="hansen",
          step_reward=-0.01), True, 0.2),
]


@pytest.mark.parametrize("kw,average,lr", TRAINER_CASES)
def test_trainer_twin_with_xla_libm_equals_jax_kernel(xla_libm, kw, average, lr):
    """At the JAX tape test's shape: positions, velocities and reward sums
    exact, Q to rtol 1e-5."""
    je = gpt.make("CRooms-v0", time_limit=8, **kw)
    te = gpt_torch.make("CRooms-v0", time_limit=8, device="cpu", **kw)
    B, K, eps, gamma = 1024, 12, 0.3, 0.9
    A = int(je.num_actions)
    _, st = je.reset_vec(jax.random.PRNGKey(8), B)
    rng = np.random.default_rng(10)
    vel = (rng.uniform(-1, 1, (2, B)) if je.use_velocity
           else np.zeros((2, B))).astype(np.float32)
    s4 = [np.asarray(st.agent_yx[:, 0]), np.asarray(st.agent_yx[:, 1]), *vel]
    s4 = [np.array(x, np.float32).reshape(-1, W) for x in s4]
    n_obs = int(je.observation_space.n)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)
    qb0 = q_to_banks(q0)
    jrun = jax_trainer(je, B, K, gamma, average_duplicates=average,
                       interpret=True, rng_tape=True)
    trun = make_fused_q_trainer_crooms(te, B, K, gamma,
                                       average_duplicates=average, rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape and trun.n_sites == jrun.n_sites
    tape = make_tape(rng, jrun.n_sites, K, B // W)
    jout = jrun(jnp.asarray([3], jnp.int32), lr, eps, *map(jnp.asarray, s4),
                jnp.asarray(qb0), jnp.asarray(tape))
    tout = trun(3, lr, eps, *map(torch.as_tensor, s4), torch.as_tensor(qb0),
                torch.as_tensor(tape))
    assert trun.launches == 0
    for name, j, t in zip("py px vy vx q racc".split(), jout, tout):
        assert t.dtype == torch.float32, name
        if name == "q":
            assert t.shape == (32, W)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    assert len(np.unique(np.asarray(jout[0]))) > 10
    assert 0 < int((tout[4].numpy() != qb0).sum()) < qb0.size


def test_trainer_refuses_what_the_kernel_does_not_take():
    def make(**kw):
        return gpt_torch.make("CRooms-v0", device="cpu", **kw)

    with pytest.raises(ValueError, match="discrete action_type"):
        make_fused_q_trainer_crooms(make(), 1024, 8)
    with pytest.raises(ValueError, match="Discrete"):
        make_fused_q_trainer_crooms(make(action_type="ordinal",
                                         obs_type="mdp_vector"), 1024, 8)
    with pytest.raises(ValueError, match="512"):
        make_fused_q_trainer_crooms(make(action_type="ordinal", layout="32"),
                                    1024, 8)
    with pytest.raises(ValueError, match="fixed goal"):
        make_fused_q_trainer_crooms(make(action_type="ordinal", goal_xy=None),
                                    1024, 8)
    env = make(action_type="ordinal")
    for B in (100, 512, 1536):
        with pytest.raises(ValueError, match="multiple"):
            make_fused_q_trainer_crooms(env, B, 8)
    run = make_fused_q_trainer_crooms(env, 1024, 4, rng_tape=True)
    f, q = torch.zeros(8, W), torch.zeros(32, W)
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="q banks"):
        run(0, 0.1, 0.1, f, f, f, f, q[:16], tape)
    with pytest.raises(ValueError, match="tape"):
        run(0, 0.1, 0.1, f, f, f, f, q, tape[:4])
    with pytest.raises(ValueError, match="state tile"):
        run(0, 0.1, 0.1, f, f, f, f.double(), q, tape)


def test_fused_q_learning_crooms_branch_is_the_kernel_loop():
    """``fused_q_learning`` on CRooms: reset positions and zero velocities
    in, one trainer call per chunk seeded ``seed + i``, one mean reward per
    step each; lam > 0 and expected_sarsa are refused, as in the JAX
    package."""
    from gym_po_tpu_torch.agents import fused_q_learning
    from gym_po_tpu_torch.ops import banks_to_q
    from gym_po_tpu_torch.parallel import chunk_seeds

    env = gpt_torch.make("CRooms-v0", action_type="ordinal", time_limit=20,
                         device="cpu")
    sched = [(0.2, 0.3, 16), (0.05, 0.05, 8)]
    q, hist = fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=8)
    n_obs, A = int(env.observation_space.n), env.num_actions
    assert q.shape == (n_obs, A) and q.dtype == np.float32
    assert len(hist) == 3 and np.isfinite(hist).all()
    run = make_fused_q_trainer_crooms(env, 1024, 8)
    _, st = env.reset_vec(torch.Generator().manual_seed(0), 1024)
    z = torch.zeros(8, W)
    s = [st.agent_yx[:, 0].reshape(-1, W).contiguous(),
         st.agent_yx[:, 1].reshape(-1, W).contiguous(), z, z]
    qb = torch.zeros(32, W)
    want = []
    for i, (lr, eps) in enumerate([(0.2, 0.3)] * 2 + [(0.05, 0.05)]):
        *s, qb, rew = run(int(chunk_seeds(0, i + 1, 1)[0]), lr, eps, *s, qb)
        want.append(rew.mean().item() / 8)
    np.testing.assert_array_equal(q, banks_to_q(qb.numpy(), 512, na=A)[:n_obs])
    np.testing.assert_allclose(hist, want, rtol=1e-6)
    with pytest.raises(ValueError, match="lam"):
        fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=8, lam=0.5)
    with pytest.raises(ValueError, match="expected_sarsa"):
        fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=8,
                         expected_sarsa=True)
