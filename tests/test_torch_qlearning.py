"""Tabular Q-learning of the PyTorch port against the JAX package.

The fused trainer's plain twin is held against the JAX Pallas kernel run
interpreted on the same numpy tape (``interpret=True, rng_tape=True``), for
every option of the builder.  States and reward sums must be equal.  Q must
agree to ``rtol=1e-5, atol=1e-6``: the two sum each step's updates in
different ways (JAX in f32 through ``dot_general``, the port exactly in
int64 fixed point, rounded once), so Q differs in the last few ulps.  Q
starts from ``normal(0, 0.1)``, which has no exact ties among actions, so
those ulps cannot flip an action.  The CUDA kernel against the twin on the
card is in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import fused_qlearning as jfq
from gym_po_tpu_torch.agents import (
    QConfig,
    fused_q_learning,
    greedy_policy,
    q_learning,
    td_update,
)
from gym_po_tpu_torch.ops import (
    apply_update,
    bank_geometry,
    banks_to_q,
    make_fused_q_trainer,
    q_to_banks,
)
from gym_po_tpu_torch.vector import rollout

from _tape import make_tape

W = 128
B, K = 1024, 16
LR, GAMMA = 0.2, 0.9
Q_TOL = dict(rtol=1e-5, atol=1e-6)


def start_states(env, B, seed):
    return np.random.default_rng(seed).choice(env.tables.valid_init, B).astype(
        np.int32).reshape(-1, W)


def random_banks(env, rng):
    """Q banks with ``normal(0, 0.1)`` entries for every (obs, action)."""
    nsb, _ = bank_geometry(int(env.observation_space.n), 5)
    q0 = np.zeros((nsb * W, 5), np.float32)
    n = int(env.observation_space.n)
    q0[:n] = rng.normal(scale=0.1, size=(n, 5)).astype(np.float32)
    return q_to_banks(q0, nsb)


# name, time_limit, eps, builder options (lam, trace_len, ...)
TAPE_CASES = [
    ("Taxi-v4", 5, 0.3, dict(average_duplicates=False)),
    ("Taxi-v4", 5, 0.3, dict(average_duplicates=True, expected_sarsa=True)),
    ("HansenTaxi-v4", 5, 0.3, dict(average_duplicates=True)),
    ("ExtendedTaxi-v4", 5, 0.3, dict(average_duplicates=True)),
    ("Taxi-v4", 6, 0.4, dict(average_duplicates=False, lam=0.8, trace_len=4)),
    ("Taxi-v4", 6, 0.4, dict(average_duplicates=True, lam=0.8, trace_len=4,
                             watkins_cut=False)),
    ("ExtendedTaxi-v4", 6, 0.4, dict(average_duplicates=True, lam=0.8,
                                     trace_len=16, watkins_cut=False)),
]


@pytest.mark.parametrize("name,time_limit,eps,opts", TAPE_CASES)
def test_twin_with_tape_equals_jax_kernel(name, time_limit, eps, opts):
    je = gpt.make(name, time_limit=time_limit)
    te = gpt_torch.make(name, time_limit=time_limit, device="cpu")
    jrun = jfq.make_fused_q_trainer(je, B, K, GAMMA, interpret=True,
                                    rng_tape=True, **opts)
    trun = make_fused_q_trainer(te, B, K, GAMMA, rng_tape=True, **opts)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites
    assert trun.trace_len == jrun.trace_len
    rng = np.random.default_rng(1)
    s0 = start_states(je, B, 3)
    qb0 = random_banks(je, rng)
    tape = make_tape(rng, jrun.n_sites, K, B // W)
    js, jq, jr = jrun(jnp.asarray([3], jnp.int32), LR, eps, jnp.asarray(s0),
                      jnp.asarray(qb0), jnp.asarray(tape))
    ts, tq, tr = trun(3, LR, eps, torch.as_tensor(s0), torch.as_tensor(qb0),
                      torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    assert ts.dtype == torch.int32 and tq.dtype == tr.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **Q_TOL)
    # the tape exercised exploration and greedy actions: some entries moved,
    # most did not
    changed = np.count_nonzero(tq.numpy() != qb0)
    assert 0 < changed < qb0.size


def test_lam_zero_equals_one_step_trainer():
    """``lam=0`` keeps the one-step path: same sites, same outputs."""
    env = gpt_torch.make("Taxi-v4", time_limit=6, device="cpu")
    run_l = make_fused_q_trainer(env, B, K, GAMMA, lam=0.0, trace_len=8,
                                 rng_tape=True)
    run_1 = make_fused_q_trainer(env, B, K, GAMMA, rng_tape=True)
    assert run_l.trace_len == 1 and run_l.n_sites == run_1.n_sites
    rng = np.random.default_rng(2)
    s0 = torch.as_tensor(start_states(env, B, 5))
    qb0 = torch.as_tensor(random_banks(env, rng))
    tape = torch.as_tensor(make_tape(rng, run_l.n_sites, K, B // W))
    for got, want in zip(run_l(3, LR, 0.3, s0, qb0, tape),
                         run_1(3, LR, 0.3, s0, qb0, tape)):
        assert torch.equal(got, want)


def test_trace_trimmed_to_nonzero_weights():
    """``(γλ)^k`` that round to 0 in f32 are cut from the ring, as in JAX."""
    je, te = gpt.make("Taxi-v4"), gpt_torch.make("Taxi-v4", device="cpu")
    for lam, L in ((1e-30, 8), (0.5, 64), (1.0, 16)):
        jrun = jfq.make_fused_q_trainer(je, B, 4, lam=lam, trace_len=L,
                                        interpret=True)
        trun = make_fused_q_trainer(te, B, 4, lam=lam, trace_len=L)
        assert trun.trace_len == jrun.trace_len


@pytest.mark.parametrize("nsb", [4, 10])
def test_banks_layout_equals_jax(nsb):
    rng = np.random.default_rng(nsb)
    ns = nsb * W - 37
    q = rng.normal(size=(ns, 5)).astype(np.float32)
    banks = q_to_banks(q, nsb)
    np.testing.assert_array_equal(banks, jfq.q_to_banks(q, nsb))
    np.testing.assert_array_equal(banks_to_q(banks, ns, 5, nsb),
                                  jfq.banks_to_q(banks, ns, 5, nsb))
    np.testing.assert_array_equal(banks_to_q(banks, ns, 5, nsb), q)
    for idx_n in (500, 1280, 3000):
        assert bank_geometry(idx_n, 5) == jfq.bank_geometry(idx_n, 5)


def test_builder_rejects_bad_configs():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    with pytest.raises(ValueError, match="lam"):
        make_fused_q_trainer(env, 1024, 8, lam=1.5)
    with pytest.raises(ValueError, match="trace_len"):
        make_fused_q_trainer(env, 1024, 8, lam=0.5, trace_len=0)
    with pytest.raises(ValueError, match="trace_len"):
        make_fused_q_trainer(env, 1024, 8, lam=0.5, trace_len=65)
    with pytest.raises(ValueError, match="max bootstrap"):
        make_fused_q_trainer(env, 1024, 8, lam=0.5, expected_sarsa=True)
    with pytest.raises(ValueError, match="1024"):
        make_fused_q_trainer(env, 512, 8)
    with pytest.raises(ValueError, match="128"):
        make_fused_q_trainer(env, 1000, 8)
    run = make_fused_q_trainer(env, 1024, 8, rng_tape=True)
    s = torch.zeros(8, W, dtype=torch.int32)
    q = torch.zeros(32, W)
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="q banks"):
        run(0, 0.1, 0.1, s, torch.zeros(56, W), tape)
    with pytest.raises(ValueError, match="tape must have shape"):
        run(0, 0.1, 0.1, s, q, tape[:8])
    with pytest.raises(ValueError, match="tape argument"):
        run(0, 0.1, 0.1, s, q)
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, 0.1, 0.1, s.to("meta"), q.to("meta"), tape.to("meta"))


def test_out_of_range_state_takes_no_part():
    """An env whose input state is outside ``[0, ns)`` comes out as
    ``s' = -1`` with a NaN reward sum and adds nothing to Q."""
    env = gpt_torch.make("Taxi-v4", time_limit=6, device="cpu")
    run = make_fused_q_trainer(env, B, 8, average_duplicates=True)
    s0 = torch.as_tensor(start_states(env, B, 4))
    q0 = torch.zeros(32, W)
    bad = s0.clone()
    bad.view(-1)[:B // 2] = -1
    s, q, r = run(5, 0.1, 0.1, bad, q0)
    assert (s.view(-1)[:B // 2] == -1).all() and (s.view(-1)[B // 2:] >= 0).all()
    assert torch.isnan(r.view(-1)[:B // 2]).all()
    assert torch.isfinite(r.view(-1)[B // 2:]).all()
    assert torch.count_nonzero(q) > 0


@pytest.mark.parametrize("average", [False, True])
def test_apply_update_flags_terms_out_of_range(average):
    """A term past the fixed point's ``|w| <= 2^6`` (or not finite) turns
    its entry NaN; every other entry takes its exact sum."""
    q = torch.zeros(8)
    addr = torch.tensor([0, 0, 1, 2, 3, 3, 4, 5])
    w = torch.tensor([64.0, 64.0, np.nextafter(np.float32(64), np.float32(99)),
                      -np.inf, np.nan, 1.0, -64.0, 0.5])
    live = torch.tensor([True] * 7 + [False])
    out = apply_update(q, addr, w, live, average)
    assert torch.isnan(out[1:4]).all()
    assert out[0] == (64.0 if average else 128.0)
    assert out[4] == -64.0 and out[5] == 0.0 and (out[6:] == 0).all()


def test_diverging_lr_goes_non_finite_as_in_jax():
    """With summed duplicates a large lr diverges: the JAX kernel's f32 sums
    overflow to inf/NaN, and the twin's out-of-range terms turn their
    entries NaN, not into wrapped int64 sums."""
    je = gpt.make("Taxi-v4", time_limit=5)
    te = gpt_torch.make("Taxi-v4", time_limit=5, device="cpu")
    opts = dict(average_duplicates=False)
    jrun = jfq.make_fused_q_trainer(je, B, K, GAMMA, interpret=True,
                                    rng_tape=True, **opts)
    trun = make_fused_q_trainer(te, B, K, GAMMA, rng_tape=True, **opts)
    rng = np.random.default_rng(1)
    s0 = start_states(je, B, 3)
    qb0 = random_banks(je, rng)
    tape = make_tape(rng, jrun.n_sites, K, B // W)
    lr = 1e3
    _, jq, _ = jrun(jnp.asarray([3], jnp.int32), lr, 0.3, jnp.asarray(s0),
                    jnp.asarray(qb0), jnp.asarray(tape))
    _, tq, _ = trun(3, lr, 0.3, torch.as_tensor(s0), torch.as_tensor(qb0),
                    torch.as_tensor(tape))
    assert not np.isfinite(np.asarray(jq)).all()
    tq = tq.numpy()
    assert np.isnan(tq).any()
    # what stays finite took only in-range terms: no wrapped garbage
    assert np.abs(tq[np.isfinite(tq)]).max() <= 64.0 * B * K


def test_td_update_equals_jax_formula():
    """The step_vec learner's update against the JAX package's one-hot
    formula (``gym_po_tpu/agents/qlearning.py:84-99``) on the same batch,
    with many duplicate ``(obs, a)`` pairs.  Q to ``rtol=1e-5, atol=1e-6``:
    JAX sums the duplicates through a matmul, the port with ``index_add_``,
    in another f32 order."""
    rng = np.random.default_rng(7)
    n_obs, n_act, n = 500, 5, 4096
    q = rng.normal(size=(n_obs, n_act)).astype(np.float32)
    obs = rng.integers(0, n_obs, n).astype(np.int32)
    action = rng.integers(0, n_act, n).astype(np.int32)
    rew = rng.choice(np.float32([-1.0, -10.0, 20.0]), n)
    next_obs = rng.integers(0, n_obs, n).astype(np.int32)
    done = rng.random(n) < 0.1
    lr, gamma = np.float32(0.1), np.float32(0.99)

    hi = jax.lax.Precision.HIGHEST
    s_oh = jax.nn.one_hot(obs, n_obs, dtype=jnp.float32)
    q_rows = jnp.matmul(s_oh, q, precision=hi)
    next_v = jnp.max(jnp.matmul(jax.nn.one_hot(next_obs, n_obs), q,
                                precision=hi), axis=-1)
    target = rew + gamma * next_v * (1.0 - done.astype(jnp.float32))
    a_oh = jax.nn.one_hot(action, n_act, dtype=jnp.float32)
    td = target - (q_rows * a_oh).sum(-1)
    want = q + jnp.matmul(s_oh.T, a_oh * (lr * td)[:, None], precision=hi)

    got = td_update(torch.as_tensor(q.copy()), torch.as_tensor(obs),
                    torch.as_tensor(action), torch.as_tensor(rew),
                    torch.as_tensor(next_obs), torch.as_tensor(done),
                    torch.tensor(lr), torch.tensor(gamma))
    assert not np.array_equal(got.numpy(), q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Q_TOL)


def test_fused_q_learning_shapes_and_history():
    env = gpt_torch.make("HansenTaxi-v4", device="cpu")
    sched = [(0.1, 0.3, 16), (0.05, 0.1, 20)]
    q, hist = fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=8)
    assert isinstance(q, np.ndarray) and q.dtype == np.float32
    assert q.shape == (env.observation_space.n, 5)
    assert len(hist) == 2 + 3  # ceil(16 / 8) + ceil(20 / 8) chunks
    assert all(-0.5 <= h <= 1.0 for h in hist)
    assert np.count_nonzero(q) > 0
    q2, hist2 = fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=8)
    np.testing.assert_array_equal(q, q2)  # a seed fixes the whole run
    assert hist == hist2
    # q_init seeds the table
    q3, _ = fused_q_learning(env, 0, [(0.0, 0.0, 8)], num_envs=1024,
                             chunk_steps=8, q_init=q)
    np.testing.assert_array_equal(q3, q)


def test_fused_q_learning_rejects_what_is_not_ported():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    from gym_po_tpu_torch.parallel import Mesh

    # a mesh is taken (test_torch_data_parallel.py); its ranks must split
    # the batch
    with pytest.raises(ValueError, match="divisible"):
        fused_q_learning(env, 0, [(0.1, 0.1, 8)],
                         mesh=Mesh(None, 0, 3, torch.device("cpu"), dims=(3,)))
    with pytest.raises(ValueError, match="Taxi"):
        fused_q_learning(object(), 0, [(0.1, 0.1, 8)])


def test_q_learning_rejects_non_discrete():
    class Boxy:
        observation_space = gpt_torch.Box(0.0, 1.0, (2,))
        action_space = gpt_torch.Discrete(4)

    with pytest.raises(ValueError, match="Discrete"):
        q_learning(Boxy(), QConfig(num_envs=8), torch.Generator(), 1)


def test_q_learning_learns_taxi():
    """The step_vec learner finds dropoffs on classic Taxi in a short CPU
    run (a random policy completes about 0.1 per 200 steps)."""
    env = gpt_torch.make("Taxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)
    cfg = QConfig(num_envs=512, learning_rate=0.1, epsilon=0.3,
                  steps_per_update=128)
    q, hist = q_learning(env, cfg, gen, num_updates=24)
    assert len(hist) == 24 and all(len(h) == 2 for h in hist)
    q, _ = q_learning(env, cfg._replace(epsilon=0.05, learning_rate=0.05), gen,
                      16, q_init=q)
    assert q.shape == (env.observation_space.n, 5) and q.dtype == torch.float32
    traj, _ = rollout(env, torch.Generator().manual_seed(9), greedy_policy(q),
                      256, 200)
    r = traj.reward
    dropoffs_per_env = (r > 0.5).sum().item() / 256
    assert dropoffs_per_env > 2.0, dropoffs_per_env
    assert (r < -0.4).double().mean().item() < 0.05
