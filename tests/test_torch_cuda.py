"""The port's CUDA kernels against their plain twins, on a CUDA device.

Imports only torch and the port (no jax), so it runs on a machine with a
card and no JAX.  Every test here is marked ``cuda`` and skips without a
device.  On the card::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu_torch.ops import make_fused_taxi_rollout

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("env_id,kw", [("ExtendedTaxi-v4", {}),
                                       ("HansenTaxi-v4", {"num_passengers": 3})])
def test_fused_taxi_kernel_equals_twin(cuda, mode, env_id, kw):
    env = gpt_torch.make(env_id, time_limit=25, device=cuda, **kw)
    B, K = 8192, 60
    run = make_fused_taxi_rollout(env, B, K, episode_stats=True,
                                  rng_tape=mode == "tape", rows_per_tile=4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, st = env.reset_vec(gen, B)
    s0 = st.s.reshape(-1, 128).contiguous()
    tape = ()
    if mode == "tape":
        tape = (torch.randint(-2**31, 2**31, run.tape_shape, generator=gen,
                              dtype=torch.int32, device=cuda),)
    got = run(9, s0, *tape)
    want = run.twin(9, s0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert got[4].sum() > 0  # episodes completed


def test_fused_taxi_kernel_greedy_policy_equals_twin(cuda):
    env = gpt_torch.make("ExtendedHansenTaxi-v4", time_limit=25, device=cuda)
    pol = np.random.default_rng(5).integers(0, 5, env.tables.ns).astype(np.int32)
    run = make_fused_taxi_rollout(env, 4096, 64, policy=pol)
    _, st = env.reset_vec(torch.Generator(device=cuda).manual_seed(1), 4096)
    s0 = st.s.reshape(-1, 128).contiguous()
    for g, w in zip(run(4, s0), run.twin(4, s0)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("policy", [False, True])
def test_fused_taxi_kernel_out_of_range_state_equals_twin(cuda, policy):
    """Out-of-range input states: the kernel reads no table for them and
    gives s' = -1 with NaN sums, as the twin does."""
    env = gpt_torch.make("ExtendedTaxi-v4", time_limit=25, device=cuda)
    opts = {}
    if policy:
        opts["policy"] = np.random.default_rng(5).integers(
            0, 5, env.tables.ns).astype(np.int32)
    run = make_fused_taxi_rollout(env, 4096, 32, episode_stats=True, **opts)
    _, st = env.reset_vec(torch.Generator(device=cuda).manual_seed(2), 4096)
    s0 = st.s.reshape(-1, 128).clone()
    idx = torch.tensor([0, 777, 4095], device=cuda)
    s0.view(-1)[idx] = torch.tensor([-1, env.tables.ns, 2**31 - 1],
                                    dtype=torch.int32, device=cuda)
    got, want = run(6, s0), run.twin(6, s0)
    torch.cuda.synchronize()
    assert (got[0].view(-1)[idx] == -1).all()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[1].view(-1)[idx]).all()


def test_fused_taxi_kernel_rejects_mixed_devices(cuda):
    env = gpt_torch.make("Taxi-v4", device=cuda)
    run = make_fused_taxi_rollout(env, 256, 4, rng_tape=True)
    s = torch.zeros(2, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        run(0, s, torch.zeros(run.tape_shape, dtype=torch.int32))
    assert run.launches == 0
