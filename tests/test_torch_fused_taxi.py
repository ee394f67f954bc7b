"""Fused Taxi rollout of the PyTorch port: its plain twin against the JAX
Pallas kernel (interpreted) on the same tape, bit for bit; the draw
contract.  The CUDA kernel against the twin on the card is in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import make_fused_taxi_rollout as jax_rollout
from gym_po_tpu.ops import state_policy_table as jax_policy_table
from gym_po_tpu_torch.maps.taxi_maps import decode_state_np
from gym_po_tpu_torch.ops import KernelRNG, make_fused_taxi_rollout, philox4x32_10
from gym_po_tpu_torch.ops import state_policy_table
from gym_po_tpu_torch.vector import rollout

from _tape import TapeOracle, make_tape

B, K = 256, 60


def _start_states(env, B, seed):
    return np.random.default_rng(seed).choice(env.tables.valid_init, B).astype(
        np.int32).reshape(-1, 128)


def _random_policy(env, seed=5):
    return np.random.default_rng(seed).integers(0, 5, env.tables.ns).astype(np.int32)


def _assert_valid(env, s):
    t = env.tables
    s = np.asarray(s).reshape(-1).astype(np.int64)
    assert ((s >= 0) & (s < t.ns)).all()
    r, c, p, d = decode_state_np(s, t.cols, t.nlocs)
    assert (t.tgrid != "|").reshape(-1)[r * t.cols + c].all()
    assert not ((p < t.nlocs) & (p == d)).any()


TAPE_CASES = [
    ("Taxi-v4", {}, 128, {}),
    ("Taxi-v4", {}, 1, {}),
    ("ExtendedTaxi-v4", {}, 128, {}),
    ("ExtendedTaxi-v4", {}, 1, {}),
    ("ExtendedTaxi-v4", {}, 128, {"policy": True}),
    ("Taxi-v4", {}, 128, {"episode_stats": True}),
    ("HansenTaxi-v4", {"num_passengers": 3}, 1, {"episode_stats": True}),
]


@pytest.mark.parametrize("env_id,kw,rows_per_tile,opts", TAPE_CASES)
def test_twin_with_tape_equals_jax_kernel(env_id, kw, rows_per_tile, opts):
    je = gpt.make(env_id, time_limit=25, **kw)
    te = gpt_torch.make(env_id, time_limit=25, **kw)
    if opts.get("policy"):
        opts = {"policy": _random_policy(je)}
    jrun = jax_rollout(je, B, K, rows_per_tile=rows_per_tile, interpret=True,
                       rng_tape=True, **opts)
    trun = make_fused_taxi_rollout(te, B, K, rows_per_tile=rows_per_tile,
                                   rng_tape=True, **opts)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites
    R = min(rows_per_tile, B // 128)
    tape = make_tape(np.random.default_rng(11), jrun.n_sites, K, R,
                     grid=B // 128 // R)
    s0 = _start_states(je, B, 1)
    jout = jrun(jnp.asarray([3], jnp.int32), jnp.asarray(s0), jnp.asarray(tape))
    tout = trun(3, torch.as_tensor(s0), torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    assert len(jout) == len(tout) == (5 if opts.get("episode_stats") else 2)
    assert tout[0].dtype == torch.int32
    for j, t in zip(jout, tout):
        assert t.shape == (B // 128, 128)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    _assert_valid(je, tout[0])
    assert len(np.unique(tout[0].numpy())) > 1
    if opts.get("episode_stats"):
        assert tout[4].sum() > 0  # time_limit=25 ends episodes within K=60


def test_rejects_bad_shapes_and_arguments():
    env = gpt_torch.make("Taxi-v4")
    with pytest.raises(ValueError):
        make_fused_taxi_rollout(env, 100, 10)  # not a multiple of 128
    with pytest.raises(ValueError):
        make_fused_taxi_rollout(env, 384, 10, rows_per_tile=2)  # 3 rows, tiles of 2
    with pytest.raises(ValueError):
        make_fused_taxi_rollout(env, 256, 8, policy=np.zeros(7, np.int32))
    with pytest.raises(ValueError, match="policy actions"):
        make_fused_taxi_rollout(env, 256, 8,
                                policy=np.full(env.tables.ns, 5, np.int32))
    run = make_fused_taxi_rollout(env, 256, 8, rng_tape=True)
    s = torch.zeros(2, 128, dtype=torch.int32)
    good_tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="tape must have shape"):
        run(0, s, torch.zeros(run.tape_shape[0] // 2, 128, dtype=torch.int32))
    with pytest.raises(ValueError):
        run(0, s, good_tape.to(torch.int64))
    with pytest.raises(ValueError):
        run(0, s)  # tape missing
    with pytest.raises(ValueError):
        run(0, s.to(torch.int64), good_tape)
    with pytest.raises(ValueError):
        run(0, torch.zeros(256, dtype=torch.int32), good_tape)
    with pytest.raises(ValueError):
        run(0, torch.zeros(128, 2, dtype=torch.int32).t(), good_tape)  # strided
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, s.to("meta"), good_tape.to("meta"))


@pytest.mark.parametrize("policy", [False, True])
def test_out_of_range_state_gives_minus_one_and_nan(policy):
    """An input state outside [0, ns) reads no table: its env comes out as
    s' = -1 with NaN sums, as in the kernel; the other envs are unaffected."""
    env = gpt_torch.make("ExtendedTaxi-v4", time_limit=25)
    opts = {"policy": _random_policy(env)} if policy else {}
    run = make_fused_taxi_rollout(env, B, 16, episode_stats=True, **opts)
    s0 = torch.as_tensor(_start_states(env, B, 3))
    idx = torch.tensor([0, 77, 200])
    bad = s0.clone()
    bad.view(-1)[idx] = torch.tensor([-1, env.tables.ns, 2**31 - 1],
                                     dtype=torch.int32)
    want, got = run(5, s0), run(5, bad)
    keep = torch.ones(B, dtype=torch.bool)
    keep[idx] = False
    assert (got[0].view(-1)[idx] == -1).all()
    for g in got[1:]:
        assert torch.isnan(g.view(-1)[idx]).all()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(-1)[keep], w.view(-1)[keep])


def test_philox_known_answers():
    """Random123's published vectors for Philox4x32-10."""
    def words(ctr, key):
        ctr = [torch.tensor([c], dtype=torch.int64) for c in ctr]
        return [int(w) for w in philox4x32_10(ctr, key)]

    assert words((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    m = 0xFFFFFFFF
    assert words((m, m, m, m), (m, m)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert words((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                 (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_kernel_rng_helpers_match_tape_oracle():
    """rbits, r24 and runiform read the tape exactly as the JAX package's
    NumPy oracle does; rnormal within 1e-6 (log and cos come from different
    libms, up to a few ULP)."""
    K, R, n_sites = 3, 2, 7  # 3 rbits, r24, runiform, rnormal (2 sites)
    tape = make_tape(np.random.default_rng(2), n_sites, K, R)
    rng = KernelRNG(0, R * 128, K, n_sites, R, tape=torch.as_tensor(tape))
    oracle = TapeOracle(tape, K, R)
    for t in range(K):
        rng.begin_step(t)
        oracle.begin_step(t)
        for n in (5, 4, 3):
            np.testing.assert_array_equal(rng.rbits(n).numpy(),
                                          oracle.rbits(n).reshape(-1))
        np.testing.assert_array_equal(rng.r24().numpy(), oracle.r24().reshape(-1))
        u = rng.runiform()
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(), oracle.runiform().reshape(-1))
        np.testing.assert_allclose(rng.rnormal().numpy(),
                                   oracle.rnormal().reshape(-1), rtol=1e-6, atol=1e-6)
    rng.finalize(n_sites)
    with pytest.raises(ValueError, match="sized for"):
        rng.finalize(n_sites + 1)


def test_philox_draws_depend_on_seed_env_step_site_only():
    a = KernelRNG(7, 256, 4, 7)
    b = KernelRNG(7, 512, 9, 5)
    c = KernelRNG(8, 256, 4, 7)
    for rng in (a, b, c):
        rng.begin_step(3)
    da = [a.draw32() for _ in range(5)]
    db = [b.draw32()[:256] for _ in range(5)]
    dc = [c.draw32() for _ in range(5)]
    for x, y, z in zip(da, db, dc):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
        assert x.dtype == torch.int64 and (x >= 0).all() and (x < 2**32).all()
    # the geometry (tape tile height) does not change Philox-mode rollouts
    env = gpt_torch.make("Taxi-v4", time_limit=25)
    s0 = torch.as_tensor(_start_states(env, B, 2))
    r1 = make_fused_taxi_rollout(env, B, 16, rows_per_tile=128)(5, s0)
    r2 = make_fused_taxi_rollout(env, B, 16, rows_per_tile=1)(5, s0)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)


@pytest.mark.parametrize("env_id", ["Taxi-v4", "ExtendedHansenTaxi-v4"])
def test_philox_rollout_state_validity(env_id):
    env = gpt_torch.make(env_id)
    run = make_fused_taxi_rollout(env, B, 64)
    _, st = env.reset_vec(torch.Generator().manual_seed(0), B)
    s2, rew = run(3, st.s.reshape(-1, 128))
    _assert_valid(env, s2)
    mean_r = rew.mean().item() / 64  # random policy: the known regime
    assert -0.25 < mean_r < 0.05, mean_r


def test_policy_eval_twin_matches_step_vec_exactly():
    """Move-only greedy table, K below the time limit: no env finishes, so
    the fused twin and the step_vec rollout must agree bit for bit."""
    env = gpt_torch.make("Taxi-v4")
    pol = (np.arange(env.tables.ns) % 4).astype(np.int32)
    run = make_fused_taxi_rollout(env, B, 32, policy=pol)
    obs, st = env.reset_vec(torch.Generator().manual_seed(2), B)
    s2, rew = run(3, st.s.reshape(-1, 128))
    pol_t = torch.as_tensor(pol)
    traj, (_, st_f) = rollout(env, torch.Generator().manual_seed(9),
                              lambda g, o: pol_t[o.long()], B, 32, init=(obs, st))
    assert torch.equal(s2.reshape(-1), st_f.s)
    torch.testing.assert_close(rew.reshape(-1), traj.reward.sum(0), rtol=1e-6,
                               atol=1e-6)


def test_state_policy_table_equals_jax():
    je, te = gpt.make("HansenTaxi-v4"), gpt_torch.make("HansenTaxi-v4")
    pol_obs = np.random.default_rng(0).integers(0, 5, je.observation_space.n)
    pj, pt = jnp.asarray(pol_obs, jnp.int32), torch.as_tensor(pol_obs, dtype=torch.int32)
    np.testing.assert_array_equal(
        jax_policy_table(je, lambda k, o: pj[o]),
        state_policy_table(te, lambda g, o: pt[o.long()]),
    )
