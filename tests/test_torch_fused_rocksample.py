"""Fused RockSample rollout of the PyTorch port: its plain twin against the
JAX Pallas kernel (interpreted) on the same tape, bit for bit.  The CUDA
kernel against the twin on the card is in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import make_fused_rocksample_rollout as jax_rollout
from gym_po_tpu_torch.ops import make_fused_rocksample_rollout, rock_bitmask

from _tape import make_tape

W = 128
SEED0 = jnp.asarray([3], jnp.int32)


def start_state(env, B, seed):
    """Flat positions (a third on a rock) and random rock bitmasks."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, env.rows * env.cols, B)
    rp = env.rock_positions_np
    on = rng.random(B) < 0.33
    pos[on] = (rp[:, 0] * env.cols + rp[:, 1])[rng.integers(0, env.k, int(on.sum()))]
    mask = rng.integers(0, 1 << env.k, B)
    return (pos.astype(np.int32).reshape(-1, W),
            mask.astype(np.int32).reshape(-1, W))


# map size, rocks, time limit, K, rows_per_tile (1: two tiles at B = 256),
# stats: the JAX tape test's case (tests/test_tape_rollouts.py:451) first
CASES = [
    ((7, 7), 8, 25, 60, 128, False),
    ((7, 7), 8, 25, 40, 1, True),
    ((5, 5), 5, 12, 40, 128, True),
    ((5, 5), 5, 200, 40, 1, False),
    ((11, 11), 11, 30, 40, 128, True),
]


@pytest.mark.parametrize("map_size,k,time_limit,K,rows_per_tile,stats", CASES)
def test_twin_with_tape_equals_jax_kernel(map_size, k, time_limit, K,
                                          rows_per_tile, stats):
    B = 256
    je = gpt.make("RockSample-v0", map_size=map_size, num_rocks=k,
                  time_limit=time_limit)
    te = gpt_torch.make("RockSample-v0", map_size=map_size, num_rocks=k,
                        time_limit=time_limit, device="cpu")
    jrun = jax_rollout(je, B, K, rows_per_tile=rows_per_tile, interpret=True,
                       episode_stats=stats, rng_tape=True)
    trun = make_fused_rocksample_rollout(te, B, K, rows_per_tile=rows_per_tile,
                                         episode_stats=stats, rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites == 3
    R = min(rows_per_tile, B // W)
    tape = make_tape(np.random.default_rng(19), 3, K, R, grid=B // W // R)
    p0, m0 = start_state(je, B, 1)
    jout = jrun(SEED0, jnp.asarray(p0), jnp.asarray(m0), jnp.asarray(tape))
    tout = trun(3, torch.as_tensor(p0), torch.as_tensor(m0),
                torch.as_tensor(tape))
    assert trun.launches == 0  # CPU tensors go through the twin
    assert len(jout) == len(tout) == (6 if stats else 3)
    assert tout[0].dtype == tout[1].dtype == torch.int32
    for j, t in zip(jout, tout):
        assert t.shape == (B // W, W)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    rew = tout[2].numpy()
    assert (rew > 0).any() and (rew < 0).any()  # good and bad outcomes
    assert ((tout[1] >= 0) & (tout[1] < (1 << k))).all()
    if stats:
        assert tout[5].sum() > 0  # episodes completed


def test_rock_bitmask_equals_the_jax_packing():
    rng = np.random.default_rng(0)
    good = rng.random((256, 11)) < 0.5
    want = (good.astype(np.int32) * (2 ** np.arange(11))).sum(-1)
    np.testing.assert_array_equal(rock_bitmask(torch.as_tensor(good)).numpy(), want)


def test_guards_and_bad_inputs():
    def make(map_size, k):
        return gpt_torch.make("RockSample-v0", map_size=map_size, num_rocks=k,
                              device="cpu")

    with pytest.raises(ValueError, match="128"):
        make_fused_rocksample_rollout(make((12, 12), 5), 256, 8)
    with pytest.raises(ValueError, match="k <= 30"):
        make_fused_rocksample_rollout(make((11, 11), 31), 256, 8)
    make_fused_rocksample_rollout(make((11, 11), 30), 256, 8)  # the widest
    env = make((7, 7), 8)
    with pytest.raises(ValueError):
        make_fused_rocksample_rollout(env, 100, 8)  # not a multiple of 128
    run = make_fused_rocksample_rollout(env, 256, 8, rng_tape=True)
    p = torch.zeros(2, W, dtype=torch.int32)
    tape = torch.zeros(run.tape_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="tape must have shape"):
        run(0, p, p, tape[:8])
    with pytest.raises(ValueError, match="unsupported device"):
        run(0, p.to("meta"), p.to("meta"), tape.to("meta"))
    run = make_fused_rocksample_rollout(env, 256, 16, episode_stats=True)
    p0, m0 = (torch.as_tensor(x) for x in start_state(env, 256, 3))
    idx = torch.tensor([0, 77, 200])
    bad = p0.clone()
    bad.view(-1)[idx] = torch.tensor([-1, 49, 2**31 - 1], dtype=torch.int32)
    want, got = run(5, p0, m0), run(5, bad, m0)
    keep = torch.ones(256, dtype=torch.bool)
    keep[idx] = False
    for g in got[:2]:
        assert (g.view(-1)[idx] == -1).all()
    for g in got[2:]:
        assert torch.isnan(g.view(-1)[idx]).all()
    for g, w in zip(got, want):
        assert torch.equal(g.view(-1)[keep], w.view(-1)[keep])


def test_philox_rollout_rock_bits_stay_fair():
    """Perf mode: after resets the rock bits are good with frequency near
    1/2 (the k-bit reset draw), and the draws do not depend on the tiles."""
    env = gpt_torch.make("RockSample-v0", map_size=(7, 7), num_rocks=8,
                         time_limit=10, device="cpu")
    run = make_fused_rocksample_rollout(env, 1024, 30)
    p0 = torch.full((8, W), 8, dtype=torch.int32)  # (1, 1)
    m0 = torch.zeros_like(p0)
    pos, mask, rew = run(11, p0, m0)
    bits = (mask.view(-1, 1) >> torch.arange(8)) & 1
    assert abs(bits.double().mean().item() - 0.5) < 0.03
    r1 = make_fused_rocksample_rollout(env, 1024, 30, rows_per_tile=1)(11, p0, m0)
    for x, y in zip(r1, (pos, mask, rew)):
        assert torch.equal(x, y)
