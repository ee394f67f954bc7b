"""The port's meshes (``gym_po_tpu_torch.parallel.mesh``) against the JAX
package's, on the CPU: two gloo ranks in local processes against the JAX
package's 2-device mesh of the virtual CPU devices.

The ranks run the jax-free targets of ``_torch_ranks.py``; one group of
two ranks serves the whole module.  Rollouts draw from each package's own
randomness, so a rank's shard is held to a one-rank rollout with that
rank's generator, as the JAX test holds a shard to a one-device rollout
with that device's key.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.parallel import make_mesh as j_make_mesh
from gym_po_tpu.parallel import shard_batch as j_shard_batch
from gym_po_tpu_torch.parallel import (
    DATA_AXIS,
    Mesh,
    Ranks,
    make_mesh,
    shard_batch,
    sharded_rollout,
    split_generator,
)
from gym_po_tpu_torch.vector import rollout

import _torch_ranks

DEVICES = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def ranks():
    with Ranks(2, "gloo", timeout=120) as r:
        yield r


def test_mesh_shape(ranks):
    facts = ranks.run(_torch_ranks.mesh_facts, DEVICES)
    assert facts == [({"data": 2}, 0, 2, "cpu"), ({"data": 2}, 1, 2, "cpu")]
    jmesh = j_make_mesh(shape=(2,), devices=jax.devices()[:2])
    assert facts[0][0] == dict(jmesh.shape)


def test_mesh_without_a_group_has_one_rank():
    mesh = make_mesh(devices=["cpu"])
    assert mesh.group is None and (mesh.rank, mesh.size) == (0, 1)
    assert mesh.shape == {DATA_AXIS: 1} and mesh.device == torch.device("cpu")
    x = torch.arange(4.0)
    assert mesh.all_mean_(x) is x and torch.equal(x, torch.arange(4.0))
    assert make_mesh(shape=(1, 1), axis_names=("data", "model"),
                     devices=["cpu"]).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="span"):
        make_mesh(shape=(2,), devices=["cpu"])
    with pytest.raises(ValueError, match="axis names"):
        make_mesh(shape=(1, 1), devices=["cpu"])
    with pytest.raises(ValueError, match="devices"):
        make_mesh(devices=["cpu", "cpu"])


def test_sharded_rollout_shard_equals_the_ranks_rollout(ranks):
    """Each rank runs the single-device rollout on its envs: rank r's shard
    equals a one-rank rollout from rank r's generator."""
    shards = ranks.run(_torch_ranks.rollout_shard, DEVICES, "Taxi-v4", 7, 16, 12)
    env = gpt_torch.make("Taxi-v4", device="cpu")
    for r, (obs, reward, final_obs) in enumerate(shards):
        assert obs.shape == (12, 8) and final_obs.shape == (8,)
        traj, (fobs, _) = rollout(env, split_generator(7, 2, "cpu")[r], None, 8, 12)
        np.testing.assert_array_equal(obs, traj.obs.numpy())
        np.testing.assert_array_equal(reward, traj.reward.numpy())
        np.testing.assert_array_equal(final_obs, fobs.numpy())
    # the ranks draw from different generators
    assert not np.array_equal(shards[0][0], shards[1][0])


def test_split_generator_is_a_function_of_the_seed():
    a = [torch.rand(3, generator=g) for g in split_generator(5, 3)]
    b = [torch.rand(3, generator=g) for g in split_generator(5, 3)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], a[1])
    gen = torch.Generator().manual_seed(5)
    c = [torch.rand(3, generator=g) for g in split_generator(gen, 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, c))  # an int seeds a generator


def test_sharded_rollout_rejects_indivisible():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    mesh = Mesh(None, 0, 4, torch.device("cpu"), dims=(4,))
    with pytest.raises(ValueError, match="divisible"):
        sharded_rollout(env, mesh, 0, None, 10, 4)


def test_shard_batch_rows_equal_jax_shards(ranks):
    x = np.arange(32.0, dtype=np.float32).reshape(16, 2)
    env = gpt_torch.make("Rooms-v0", device="cpu")
    _, st = env.reset_vec(torch.Generator().manual_seed(0), 16)
    got = ranks.run(_torch_ranks.batch_rows, DEVICES, {"x": x, "state": st})
    jmesh = j_make_mesh(shape=(2,), devices=jax.devices()[:2])
    jx = j_shard_batch(jmesh, x)
    jshards = sorted(jx.addressable_shards, key=lambda s: s.index[0].start or 0)
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["x"].numpy(), np.asarray(jshards[r].data))
        for f in dataclasses.fields(st):
            np.testing.assert_array_equal(getattr(out["state"], f.name).numpy(),
                                          getattr(st, f.name)[8 * r:8 * (r + 1)].numpy())
    with pytest.raises(ValueError, match="split"):
        shard_batch(Mesh(None, 0, 3, torch.device("cpu"), dims=(3,)), x)


def test_ranks_raise_what_a_rank_raises_and_stop():
    ranks = Ranks(2, "gloo", timeout=60)
    with pytest.raises(RuntimeError, match="fails on purpose"):
        with ranks:
            ranks.run(_torch_ranks.fail_on_rank, DEVICES, 1)
    assert not any(p.is_alive() for p in ranks._procs)
