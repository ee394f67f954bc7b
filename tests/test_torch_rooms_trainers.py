"""The in-kernel ROOMS learners of the PyTorch port against the JAX package.

Each trainer's plain twin is held against the JAX Pallas kernel run
interpreted on the same numpy tape (``interpret=True, rng_tape=True``):
one-step Q (``make_fused_q_trainer_rooms``), Watkins and Peng Q(λ)
(``make_fused_qlambda_trainer_rooms``) and the actor-critic
(``make_fused_ac_trainer_rooms``).  Agents and reward sums must be equal.
Q must agree to ``rtol=1e-5, atol=1e-6``: JAX sums each step's updates in
f32 through ``dot_general`` with a bf16x2 split, the port exactly in int64
fixed point, rounded once, so Q differs in the last few ulps; tables start
from ``normal(0, σ)``, which has no exact ties among actions.  The
actor-critic's θ and v are held to ``rtol=1e-4, atol=1e-6``: besides the
sums, its ``exp`` and ``log`` come from torch's and XLA's own libm, which
may differ in the last ulp; its sampled actions, and so its agents, stay
exact at this size.  The CUDA kernels against the twins on the card are in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import fused_qlearning as jfq
from gym_po_tpu.ops.fused_ac import make_fused_ac_trainer_rooms as jax_ac
from gym_po_tpu.ops.fused_qlambda import make_fused_qlambda_trainer_rooms as jax_ql
from gym_po_tpu_torch.agents import fused_actor_critic, fused_q_learning
from gym_po_tpu_torch.ops import (
    apply_update,
    make_fused_ac_trainer_rooms,
    make_fused_q_trainer_rooms,
    make_fused_qlambda_trainer_rooms,
    q_to_banks,
)
from gym_po_tpu_torch.ops.fused_ac import apply_ac_update

from _tape import make_tape

W = 128
B, K = 1024, 16
LR, GAMMA = 0.2, 0.9
Q_TOL = dict(rtol=1e-5, atol=1e-6)
AC_TOL = dict(rtol=1e-4, atol=1e-6)
SEED0 = jnp.asarray([3], jnp.int32)


def start_cells(env, B, seed):
    """Flat agent cells on walkable cells, a quarter of them within two
    steps of the goal so that the goal branch runs within K steps."""
    rng = np.random.default_rng(seed)
    H, GW = env.grid_np.shape
    valid = np.flatnonzero(env.grid_np.reshape(-1) >= 0)
    agent = rng.choice(valid, B)
    goal = int(env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    near = valid[np.abs(valid // GW - goal // GW) + np.abs(valid % GW - goal % GW) <= 2]
    pick = rng.random(B) < 0.25
    agent[pick] = rng.choice(near, int(pick.sum()))
    return agent.astype(np.int32).reshape(-1, W)


def random_banks(env, rng, scale=0.1, n_act=None):
    n_obs = int(env.observation_space.n)
    A = n_act or int(env.num_actions)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=scale, size=(n_obs, A)).astype(np.float32)
    return q_to_banks(q0)


def _pair(kw, time_limit=8):
    return (gpt.make("Rooms-v0", time_limit=time_limit, **kw),
            gpt_torch.make("Rooms-v0", time_limit=time_limit, device="cpu",
                           **kw))


# env kwargs, eps, trainer options (lam=None: the one-step trainer)
CASES = [
    ({}, 0.3, dict(lam=None, average_duplicates=True)),
    ({}, 0.3, dict(lam=None, average_duplicates=False)),
    ({"obs_type": "hansen", "action_type": "cardinal", "agent_xy": (1, 1)},
     0.3, dict(lam=None, average_duplicates=True)),
    ({}, 0.3, dict(lam=0.8, trace_len=4, watkins_cut=True,
                   average_duplicates=False)),
    ({}, 0.3, dict(lam=0.8, trace_len=4, watkins_cut=False,
                   average_duplicates=True)),
    ({"layout": "16", "obs_type": "room_goal"}, 0.4,
     dict(lam=0.9, trace_len=8, watkins_cut=True, average_duplicates=True)),
    ({"layout": "16"}, 0.4,
     dict(lam=0.9, trace_len=8, watkins_cut=False, average_duplicates=False)),
]


def _trainers(je, te, opts, rng_tape=True):
    opts = dict(opts)
    lam = opts.pop("lam")
    if lam is None:
        return (jfq.make_fused_q_trainer_rooms(je, B, K, GAMMA, interpret=True,
                                               rng_tape=rng_tape, **opts),
                make_fused_q_trainer_rooms(te, B, K, GAMMA, rng_tape=rng_tape,
                                           **opts))
    return (jax_ql(je, B, K, GAMMA, lam=lam, interpret=True, rng_tape=rng_tape,
                   **opts),
            make_fused_qlambda_trainer_rooms(te, B, K, GAMMA, lam=lam,
                                             rng_tape=rng_tape, **opts))


@pytest.mark.parametrize("kw,eps,opts", CASES)
def test_q_twin_with_tape_equals_jax_kernel(kw, eps, opts):
    je, te = _pair(kw)
    jrun, trun = _trainers(je, te, opts)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites
    if opts["lam"] is not None:
        assert trun.trace_len == jrun.trace_len
    rng = np.random.default_rng(1)
    a0 = start_cells(je, B, 3)
    qb0 = random_banks(je, rng)
    tape = make_tape(rng, jrun.n_sites, K, B // W)
    ja, jq, jr = jrun(SEED0, LR, eps, jnp.asarray(a0), jnp.asarray(qb0),
                      jnp.asarray(tape))
    ta, tq, tr = trun(3, LR, eps, torch.as_tensor(a0), torch.as_tensor(qb0),
                      torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    assert ta.dtype == torch.int32 and tq.dtype == tr.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **Q_TOL)
    changed = np.count_nonzero(tq.numpy() != qb0)
    assert 0 < changed < qb0.size
    assert (tr.numpy() > 0).any()  # goals reached


@pytest.mark.parametrize("avg", [False, True])
def test_lam_zero_equals_one_step_trainer(avg):
    """``lam=0`` trims the ring to one term: the one-step trainer's sites
    and outputs, bit for bit, in the port as in JAX."""
    _, te = _pair({})
    run_l = make_fused_qlambda_trainer_rooms(te, B, K, GAMMA, lam=0.0,
                                             trace_len=8, average_duplicates=avg,
                                             rng_tape=True)
    run_1 = make_fused_q_trainer_rooms(te, B, K, GAMMA, average_duplicates=avg,
                                       rng_tape=True)
    assert run_l.trace_len == 1 and run_l.n_sites == run_1.n_sites
    rng = np.random.default_rng(2)
    a0 = torch.as_tensor(start_cells(te, B, 5))
    qb0 = torch.as_tensor(random_banks(te, rng))
    tape = torch.as_tensor(make_tape(rng, run_l.n_sites, K, B // W))
    for got, want in zip(run_l(3, LR, 0.3, a0, qb0, tape),
                         run_1(3, LR, 0.3, a0, qb0, tape)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"action_type": "cardinal",
                                     "obs_type": "room_goal"}])
def test_ac_twin_with_tape_equals_jax_kernel(kw):
    je, te = _pair(kw)
    Kac = 12
    api, apv = 0.2, 0.3
    jrun = jax_ac(je, B, Kac, GAMMA, interpret=True, rng_tape=True)
    trun = make_fused_ac_trainer_rooms(te, B, Kac, GAMMA, rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites
    rng = np.random.default_rng(9)
    a0 = start_cells(je, B, 5)
    th0 = random_banks(je, rng, scale=0.3)
    v0 = random_banks(je, rng, scale=0.2, n_act=1)
    tape = make_tape(rng, jrun.n_sites, Kac, B // W)
    jth, jv, ja, jr = jrun(SEED0, api, apv, jnp.asarray(th0), jnp.asarray(v0),
                           jnp.asarray(a0), jnp.asarray(tape))
    tth, tv, ta, tr = trun(3, api, apv, torch.as_tensor(th0),
                           torch.as_tensor(v0), torch.as_tensor(a0),
                           torch.as_tensor(tape))
    assert trun.launches == 0
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **AC_TOL)
    np.testing.assert_allclose(tth.numpy(), np.asarray(jth), **AC_TOL)
    assert 0 < np.count_nonzero(tth.numpy() != th0) < th0.size
    assert 0 < np.count_nonzero(tv.numpy() != v0) < v0.size


def test_trainers_reject_what_the_kernels_do_not_take():
    env = gpt_torch.make("Rooms-v0", device="cpu")
    makers = (make_fused_q_trainer_rooms, make_fused_qlambda_trainer_rooms,
                make_fused_ac_trainer_rooms)
    for build in makers:
        with pytest.raises(ValueError, match="1024"):
            build(env, 512, 8)
        with pytest.raises(ValueError, match="128"):
            build(env, 1000, 8)
        with pytest.raises(ValueError, match="fixed goal"):
            build(gpt_torch.make("Rooms-v0", goal_xy=None, device="cpu"), 1024, 8)
        with pytest.raises(ValueError, match="512"):  # 852 walkable cells
            build(gpt_torch.make("Rooms-v0", layout="32", device="cpu"), 1024, 8)
        with pytest.raises(ValueError, match="512"):  # 2,304 Hansen-8 codes
            build(gpt_torch.make("Rooms-v0", obs_type="hansen8_goal",
                                 device="cpu"), 1024, 8)
        with pytest.raises(ValueError, match="Discrete"):
            build(gpt_torch.make("Rooms-v0", obs_type="mdp_vector",
                                 device="cpu"), 1024, 8)
    with pytest.raises(ValueError, match="lam"):
        make_fused_qlambda_trainer_rooms(env, 1024, 8, lam=1.5)
    with pytest.raises(ValueError, match="trace_len"):
        make_fused_qlambda_trainer_rooms(env, 1024, 8, trace_len=65)
    run = make_fused_q_trainer_rooms(env, 1024, 8, rng_tape=True)
    a = torch.zeros(8, W, dtype=torch.int32)
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="q banks"):
        run(0, 0.1, 0.1, a, torch.zeros(16, W), tape)
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, 0.1, 0.1, a.to("meta"), torch.zeros(32, W, device="meta"),
            tape.to("meta"))
    ac = make_fused_ac_trainer_rooms(env, 1024, 8)
    with pytest.raises(ValueError, match="theta"):
        ac(0, 0.1, 0.1, torch.zeros(16, W), torch.zeros(32, W), a)


def test_out_of_range_agent_takes_no_part():
    env = gpt_torch.make("Rooms-v0", time_limit=6, device="cpu")
    a0 = torch.as_tensor(start_cells(env, B, 4))
    bad = a0.clone()
    bad.view(-1)[:B // 2] = -1
    run = make_fused_q_trainer_rooms(env, B, 8, average_duplicates=True)
    a, q, r = run(5, 0.1, 0.1, bad, torch.zeros(32, W))
    ac = make_fused_ac_trainer_rooms(env, B, 8)
    _, _, a2, r2 = ac(5, 0.1, 0.1, torch.zeros(32, W), torch.zeros(32, W), bad)
    for a_, r_ in ((a, r), (a2, r2)):
        assert (a_.view(-1)[:B // 2] == -1).all()
        assert (a_.view(-1)[B // 2:] >= 0).all()
        assert torch.isnan(r_.view(-1)[:B // 2]).all()
        assert torch.isfinite(r_.view(-1)[B // 2:]).all()


@pytest.mark.parametrize("lam", [0.0, 0.9])
def test_fused_q_learning_rooms_shapes_and_history(lam):
    env = gpt_torch.make("Rooms-v0", layout="1", device="cpu")
    sched = [(0.2, 0.3, 16), (0.05, 0.1, 8)]
    q, hist = fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=8,
                               lam=lam, trace_len=4)
    assert isinstance(q, np.ndarray) and q.dtype == np.float32
    assert q.shape == (env.observation_space.n, env.action_space.n)
    assert len(hist) == 3 and all(np.isfinite(h) and 0 <= h <= 1 for h in hist)
    assert np.count_nonzero(q) > 0
    q2, hist2 = fused_q_learning(env, 0, sched, num_envs=1024, chunk_steps=8,
                                 lam=lam, trace_len=4)
    np.testing.assert_array_equal(q, q2)  # a seed fixes the whole run
    assert hist == hist2


def test_fused_actor_critic_shapes_and_history():
    env = gpt_torch.make("Rooms-v0", layout="1", device="cpu")
    th, v, hist = fused_actor_critic(env, 0, [(0.1, 0.2, 16)], num_envs=1024,
                                     chunk_steps=8)
    n_obs = int(env.observation_space.n)
    assert th.shape == (n_obs, env.num_actions) and v.shape == (n_obs,)
    assert th.dtype == v.dtype == np.float32
    assert len(hist) == 2 and all(np.isfinite(h) for h in hist)
    assert np.count_nonzero(th) > 0 and np.count_nonzero(v) > 0
    with pytest.raises(ValueError, match="Rooms"):
        fused_actor_critic(gpt_torch.make("Taxi-v4", device="cpu"), 0,
                           [(0.1, 0.2, 8)], num_envs=1024)




# ------------------------------------------- the kernels' per-block sums
MASK32, MASK64 = (1 << 32) - 1, (1 << 64) - 1


def _kernel_sums(n_sum, n_cnt, envs, count_all, block, rng):
    """The kernels' update sums (``BlockSums`` in ``csrc/tabular.cuh``) in
    plain Python: the envs in blocks of ``block``, each block's terms added
    in a random order into a slab through the two 32-bit halves of each
    int64 word (the low half, then the high half plus the low half's
    carry), the blocks' slabs added into one accumulator in a random order.
    ``envs[e]`` is ``None`` (inactive) or ``(count word, [(sum index, w)])``;
    a term past the fixed point's range adds nothing and flags its count
    word.  ``count_all``: an env counts once whatever its terms (the
    actor-critic), else each term in range counts once.  Returns the int64
    sums, the counts and the flags."""
    acc = [0] * n_sum
    cnt = np.zeros(n_cnt, np.int64)
    flag = np.zeros(n_cnt, bool)
    for b in rng.permutation(-(-len(envs) // block)):
        lo, hi = [0] * n_sum, [0] * n_sum
        for e in rng.permutation(np.arange(b * block, min(len(envs), (b + 1) * block))):
            if envs[e] is None:
                continue
            o, terms = envs[e]
            cnt[o] += count_all
            for k, w in terms:
                if not abs(w) <= 64.0:
                    flag[o] = True
                    continue
                u = int(np.rint(np.float64(w) * 2.0**32)) & MASK64
                old = lo[k]
                lo[k] = (old + (u & MASK32)) & MASK32
                hi[k] = (hi[k] + (u >> 32) + int(lo[k] < (u & MASK32))) & MASK32
                cnt[o] += not count_all
        acc = [(a + (h << 32 | l)) & MASK64 for a, h, l in zip(acc, hi, lo)]
    sums = np.array(acc, np.uint64).view(np.int64)
    return sums, cnt, flag


def _kernel_delta(sums, cnt, flag, average):
    """``fix_delta``: the sum converted once, divided by the count in f32."""
    dq = (sums.astype(np.float64) * 2.0**-32).astype(np.float32)
    if average:
        dq = dq / np.maximum(cnt, 1).astype(np.float32)
    return np.where(flag, np.float32(np.nan), dq).astype(np.float32)


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("kind", ["q sum", "q average", "ac"])
def test_update_sums_do_not_depend_on_order_or_blocks(kind, overflow):
    """The property the kernels' per-block sums rest on: the twins'
    ``apply_update`` and ``apply_ac_update`` give the same table bit for
    bit when the terms are permuted, and when they are split into per-block
    int64 slabs (summed through 32-bit halves) that are added afterwards, at
    two block sizes.  Terms pile onto a few hot entries, as the greedy
    actions' do; past the range an entry turns NaN."""
    rng = np.random.default_rng(17)
    n_env, A, nsp = 3000, 8, 512
    live = rng.random(n_env) < 0.9
    hot = rng.integers(0, 40, n_env)
    w = (rng.normal(scale=3.0, size=(A + 1, n_env))
         * rng.choice([1e-7, 1e-3, 1.0, 3.0], (A + 1, n_env))).astype(np.float32)
    if overflow:  # five live envs each with a term past 2^6
        w[rng.integers(0, A + 1, 5) * (kind == "ac"),
          np.flatnonzero(live)[:5]] = np.float32(100.0)
    tl = torch.as_tensor
    if kind == "ac":
        th0 = rng.normal(size=A * nsp).astype(np.float32)
        v0 = rng.normal(size=8 * nsp).astype(np.float32)
        th0[:5] = -0.0
        want = apply_ac_update(tl(th0), tl(v0), tl(hot), tl(w[:A]), tl(w[A]),
                               tl(live), nsp)
        perm = rng.permutation(n_env)
        got = apply_ac_update(tl(th0), tl(v0), tl(hot[perm]), tl(w[:A, perm]),
                              tl(w[A, perm]), tl(live[perm]), nsp)
        for g, x in zip(got, want):
            torch.testing.assert_close(g, x, rtol=0, atol=0, equal_nan=True)
        envs = [(hot[e], [(j * nsp + hot[e], w[j, e]) for j in range(A + 1)])
                if live[e] else None for e in range(n_env)]
        for block in (256, 96):
            sums, cnt, flag = _kernel_sums((A + 1) * nsp, nsp, envs, True,
                                           block, rng)
            d = [_kernel_delta(sums[j * nsp:(j + 1) * nsp], cnt, flag, True)
                 for j in range(A + 1)]
            th = th0 + np.concatenate(d[:A])
            v = v0 + np.concatenate([d[A], np.zeros(7 * nsp, np.float32)])
            torch.testing.assert_close(tl(th), want[0], rtol=0, atol=0,
                                       equal_nan=True)
            torch.testing.assert_close(tl(v), want[1], rtol=0, atol=0,
                                       equal_nan=True)
        assert torch.isnan(want[0]).any() == overflow
        return
    average = kind == "q average"
    n = A * nsp
    addr = rng.integers(0, A, n_env) * nsp + hot
    q0 = rng.normal(size=n).astype(np.float32)
    q0[:5] = -0.0
    want = apply_update(tl(q0), tl(addr), tl(w[0]), tl(live), average)
    perm = rng.permutation(n_env)
    torch.testing.assert_close(
        apply_update(tl(q0), tl(addr[perm]), tl(w[0, perm]), tl(live[perm]),
                     average), want, rtol=0, atol=0, equal_nan=True)
    envs = [(addr[e], [(addr[e], w[0, e])]) if live[e] else None
            for e in range(n_env)]
    for block in (256, 96):
        sums, cnt, flag = _kernel_sums(n, n, envs, False, block, rng)
        q = q0 + _kernel_delta(sums, cnt, flag, average)
        torch.testing.assert_close(tl(q), want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(want).any() == overflow
