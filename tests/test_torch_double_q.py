"""Double Q-learning of the PyTorch port against the JAX package.

The fused double-Q trainer's plain twin is held against the JAX Pallas
kernel run interpreted on the same numpy tape.  States and reward sums must
be equal; the stacked tables agree to ``rtol=1e-5, atol=1e-6``, for the
reason given in ``test_torch_qlearning.py`` (f32 ``dot_general`` sums in
JAX, exact fixed-point sums in the port).  The CUDA kernel against the twin
on the card is in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops.fused_double_q import make_fused_double_q_trainer as jax_dq
from gym_po_tpu_torch.ops import make_fused_double_q_trainer, q_to_banks

from _tape import make_tape

W = 128
B, K = 1024, 16
LR, EPS, GAMMA = 0.2, 0.3, 0.9
Q_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("avg", [True, False])
def test_twin_with_tape_equals_jax_kernel(avg):
    je = gpt.make("Taxi-v4", time_limit=5)
    te = gpt_torch.make("Taxi-v4", time_limit=5, device="cpu")
    jrun = jax_dq(je, B, K, GAMMA, average_duplicates=avg, interpret=True,
                  rng_tape=True)
    trun = make_fused_double_q_trainer(te, B, K, GAMMA, average_duplicates=avg,
                                       rng_tape=True)
    assert trun.tape_shape == jrun.tape_shape
    assert trun.n_sites == jrun.n_sites == 9  # three Philox blocks a step
    rng = np.random.default_rng(6)
    s0 = rng.choice(je.tables.valid_init, B).astype(np.int32).reshape(-1, W)
    ns = je.tables.ns
    qa0, qb0 = (np.zeros((512, 5), np.float32) for _ in range(2))
    qa0[:ns] = rng.normal(scale=0.1, size=(ns, 5)).astype(np.float32)
    qb0[:ns] = rng.normal(scale=0.1, size=(ns, 5)).astype(np.float32)
    q20 = np.concatenate([q_to_banks(qa0), q_to_banks(qb0)])
    tape = make_tape(rng, jrun.n_sites, K, B // W)
    js, jq, jr = jrun(jnp.asarray([3], jnp.int32), LR, EPS, jnp.asarray(s0),
                      jnp.asarray(q20), jnp.asarray(tape))
    ts, tq, tr = trun(3, LR, EPS, torch.as_tensor(s0), torch.as_tensor(q20),
                      torch.as_tensor(tape))
    assert trun.launches == 0
    assert tq.shape == (64, W)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **Q_TOL)
    # the coin routed updates into both tables
    assert np.count_nonzero(tq.numpy()[:32] != q20[:32]) > 0
    assert np.count_nonzero(tq.numpy()[32:] != q20[32:]) > 0


def test_philox_run_is_seeded_and_updates_both_tables():
    env = gpt_torch.make("Taxi-v4", time_limit=25, device="cpu")
    run = make_fused_double_q_trainer(env, B, 32)
    s0 = torch.as_tensor(np.random.default_rng(1).choice(
        env.tables.valid_init, B).astype(np.int32).reshape(-1, W))
    q0 = torch.zeros(64, W)
    a = run(7, 0.1, 0.3, s0, q0)
    b = run(7, 0.1, 0.3, s0, q0)
    c = run(8, 0.1, 0.3, s0, q0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert torch.count_nonzero(a[1][:32]) > 0 and torch.count_nonzero(a[1][32:]) > 0


def test_builder_rejects_bad_configs():
    with pytest.raises(ValueError, match="classic map"):
        make_fused_double_q_trainer(
            gpt_torch.make("ExtendedTaxi-v4", device="cpu"), 1024, 8)
    env = gpt_torch.make("Taxi-v4", device="cpu")
    with pytest.raises(ValueError, match="1024"):
        make_fused_double_q_trainer(env, 512, 8)
    run = make_fused_double_q_trainer(env, 1024, 8)
    s = torch.zeros(8, W, dtype=torch.int32)
    with pytest.raises(ValueError, match="q banks"):
        run(0, 0.1, 0.1, s, torch.zeros(32, W))  # one table, not two
