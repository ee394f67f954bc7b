"""The port's data-parallel fused trainers
(``gym_po_tpu_torch.parallel.data_parallel``, the ``mesh`` of
``fused_q_learning`` and ``fused_actor_critic``) against the JAX
package's, on the CPU.

Two gloo ranks in local processes (one group for the module, running the
jax-free targets of ``_torch_ranks.py``) stand against the JAX package's
2-device mesh of the virtual CPU devices:

* a dummy chunk trainer through both packages' ``shard_fused_trainer``:
  exact;
* the Taxi Q twin on tapes, one per rank and chunk, against the JAX kernel
  (``interpret=True, rng_tape=True``) under JAX's ``shard_fused_trainer``:
  per shard the states and reward sums exact, Q to rtol 1e-5 (the
  single-device tolerance of ``test_torch_qlearning.py``: JAX sums its
  updates in f32, the port in int64 fixed point); and both ranks' results
  equal, bit for bit, both shards run in one process and averaged as
  ``(a + b) / 2`` (a sum of two is exact in either order);
* ``fused_q_learning`` and ``fused_actor_critic`` themselves on two ranks,
  for every fused trainer (Taxi, ROOMS one-step and Q(λ), MSRooms, CRooms
  with its four float tiles sharded, the actor-critic): both ranks equal,
  bit for bit, the two shards run in one process with their chunk seeds
  and the tables averaged as ``(a + b) / 2``.

A one-rank mesh (an in-process gloo group of one) is bit for bit no mesh,
for every fused trainer (Taxi, ROOMS one-step and
Q(λ), MSRooms, CRooms with its four float tiles, the actor-critic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import fused_qlearning as jfq
from gym_po_tpu.parallel import chunk_seeds as j_chunk_seeds
from gym_po_tpu.parallel import make_mesh as j_make_mesh
from gym_po_tpu.parallel import replicate as j_replicate
from gym_po_tpu.parallel import shard_batch as j_shard_batch
from gym_po_tpu.parallel import shard_fused_trainer as j_shard_fused_trainer
from gym_po_tpu_torch.agents import fused_actor_critic, fused_q_learning
from gym_po_tpu_torch.ops import (
    bank_geometry,
    banks_to_q,
    make_fused_ac_trainer_rooms,
    make_fused_q_trainer,
    make_fused_q_trainer_crooms,
    make_fused_q_trainer_msrooms,
    make_fused_q_trainer_rooms,
    make_fused_qlambda_trainer_rooms,
    q_to_banks,
)
from gym_po_tpu_torch.parallel import (
    Ranks,
    chunk_seeds,
    local_mesh,
    make_mesh,
    shard_fused_trainer,
)

import _torch_ranks
from _tape import make_tape

DEVICES = ["cpu", "cpu"]
W = 128
Q_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ranks():
    with Ranks(2, "gloo", timeout=180) as r:
        yield r


@pytest.fixture(scope="module")
def jmesh2():
    return j_make_mesh(shape=(2,), devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo group of one rank in this process, and its mesh."""
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    dist.init_process_group("gloo", init_method=init, rank=0, world_size=1)
    try:
        yield make_mesh(devices=["cpu"])
    finally:
        dist.destroy_process_group()


def test_chunk_seeds_equal_jax():
    for seed, chunk, n in ((0, 1, 1), (7, 3, 2), (100, 49, 8), (-5, 2, 4)):
        got = chunk_seeds(seed, chunk, n)
        want = np.asarray(j_chunk_seeds(seed, chunk, n))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_dummy_trainer_equals_jax_shard_fused_trainer(ranks, jmesh2):
    """Seeds land per rank, the state stays the rank's, the table comes back
    averaged and the same on both ranks: as JAX's, exactly."""

    def fake_chunk(seed, lr, s, q):
        return s + 1, q + lr * seed[0].astype(jnp.float32), s * 0

    jrun = j_shard_fused_trainer(fake_chunk, jmesh2, sharded_args=(1,),
                                 averaged_outs=(1,), num_outs=3)
    s0 = np.arange(4 * W, dtype=np.int32).reshape(4, W)
    q0 = np.ones((4, W), np.float32)
    seeds = chunk_seeds(100, 1, 2)  # 102, 103: the mean 102.5
    js1, jq1, _ = jrun(jnp.asarray(seeds), jnp.float32(2.0),
                       j_shard_batch(jmesh2, s0), j_replicate(jmesh2, q0))
    out = ranks.run(_torch_ranks.dummy_chunk, DEVICES, seeds, 2.0, s0,
                    torch.as_tensor(q0))
    for r, (s1, q1, zero) in enumerate(out):
        np.testing.assert_array_equal(s1.numpy(), np.asarray(js1)[2 * r:2 * (r + 1)])
        np.testing.assert_array_equal(q1.numpy(), np.asarray(jq1))
        assert not zero.any()
    np.testing.assert_array_equal(np.asarray(jq1), 1.0 + 2.0 * 102.5)


def test_shard_fused_trainer_guards():
    mesh = local_mesh("cpu")
    with pytest.raises(ValueError, match="averaged_outs"):
        shard_fused_trainer(lambda seed, s: (s,), mesh, sharded_args=(0,),
                            averaged_outs=(), num_outs=1)
    run = shard_fused_trainer(lambda seed, s: (s, s), mesh, sharded_args=(0,),
                              averaged_outs=(0,), num_outs=3)
    with pytest.raises(ValueError, match="expected 3"):
        run(chunk_seeds(0, 1, 1), torch.zeros(2))
    with pytest.raises(ValueError, match="seeds"):
        run(chunk_seeds(0, 1, 2), torch.zeros(2))


def _taxi_tape_case(K, chunks):
    env_kw = dict(time_limit=5)
    je = gpt.make("Taxi-v4", **env_kw)
    rng = np.random.default_rng(4)
    s0 = rng.choice(je.tables.valid_init, 2048).astype(np.int32).reshape(-1, W)
    nsb, _ = bank_geometry(int(je.observation_space.n), 5)
    q = np.zeros((nsb * W, 5), np.float32)
    q[:500] = rng.normal(scale=0.1, size=(500, 5)).astype(np.float32)
    qb0 = q_to_banks(q, nsb)
    jrun = jfq.make_fused_q_trainer(je, 1024, K, 0.9, interpret=True,
                                    rng_tape=True, average_duplicates=True)
    tapes = [[make_tape(rng, jrun.n_sites, K, 8) for _ in range(2)]
             for _ in range(chunks)]
    seeds = [chunk_seeds(3, c + 1, 2) for c in range(chunks)]
    return env_kw, jrun, s0, qb0, tapes, seeds


def test_two_rank_taxi_q_on_tapes_equals_jax_and_the_emulation(ranks, jmesh2):
    K, chunks, lr, eps = 8, 2, 0.2, 0.3
    env_kw, jrun, s0, qb0, tapes, seeds = _taxi_tape_case(K, chunks)
    # args after the seed: (lr, eps, s, q, tape); outs: (s, q, rew)
    jsharded = j_shard_fused_trainer(jrun, jmesh2, sharded_args=(2, 4),
                                     averaged_outs=(1,), num_outs=3)
    js, jq = j_shard_batch(jmesh2, s0), j_replicate(jmesh2, qb0)
    jouts = []
    for c in range(chunks):
        js, jq, jr = jsharded(jnp.asarray(seeds[c]), lr, eps, js, jq,
                              j_shard_batch(jmesh2, np.concatenate(tapes[c])))
        jouts.append((np.asarray(js), np.asarray(jq), np.asarray(jr)))
    got = ranks.run(_torch_ranks.taxi_q_on_tapes, DEVICES, "Taxi-v4", 5, 2048,
                    K, 0.9, seeds, lr, eps, s0, qb0, tapes)

    # the emulation: both shards in one process, the tables averaged
    te = gpt_torch.make("Taxi-v4", device="cpu", **env_kw)
    trun = make_fused_q_trainer(te, 1024, K, 0.9, rng_tape=True,
                                average_duplicates=True)
    es, eq = [torch.as_tensor(s0[:8]), torch.as_tensor(s0[8:])], torch.as_tensor(qb0)
    for c in range(chunks):
        outs = [trun(int(seeds[c][r]), lr, eps, es[r], eq,
                     torch.as_tensor(tapes[c][r])) for r in range(2)]
        es = [o[0] for o in outs]
        eq = (outs[0][1] + outs[1][1]) / 2
        for r in range(2):
            s, q, rew = got[r][c]
            rows = slice(8 * r, 8 * (r + 1))
            np.testing.assert_array_equal(s.numpy(), jouts[c][0][rows])
            np.testing.assert_array_equal(rew.numpy(), jouts[c][2][rows])
            np.testing.assert_allclose(q.numpy(), jouts[c][1], **Q_TOL)
            assert torch.equal(s, outs[r][0]) and torch.equal(rew, outs[r][2])
            assert torch.equal(q, eq)
    moved = np.count_nonzero(got[0][-1][1].numpy() != qb0)
    assert 0 < moved < qb0.size


FUSED_CASES = [
    ("q", "Taxi-v4", {}, {}),
    ("q", "Rooms-v0", dict(layout="1"), {}),
    ("q", "Rooms-v0", dict(layout="1"), dict(lam=0.9, trace_len=4)),
    ("q", "MultistoryFourRooms-v0", {}, {}),
    ("q", "CRooms-v0", dict(action_type="ordinal", time_limit=20), {}),
    ("ac", "Rooms-v0", dict(layout="1"), {}),
]
FUSED_IDS = ["taxi", "rooms", "rooms-qlambda", "msrooms", "crooms", "actor-critic"]


def _emulate_two_ranks(trainer, env, seed, schedule, num_envs, K, opts):
    """What two ranks give, in one process: the global reset from ``seed``,
    each half of the state tiles through the single-device trainer with its
    chunk seed, the tables averaged as ``(a + b) / 2`` after every chunk
    (and the chunks' mean rewards likewise).  Returns what
    ``fused_q_learning`` or ``fused_actor_critic`` returns."""
    _, st = env.reset_vec(torch.Generator().manual_seed(seed), num_envs)
    B, n_obs = num_envs // 2, int(env.observation_space.n)
    if trainer == "ac":
        a = st.agent_yx.to(torch.int32)
        tiles = [a[:, 0] * env.grid_np.shape[1] + a[:, 1]]
        run = make_fused_ac_trainer_rooms(env, B, K, 0.99)
        A = int(env.num_actions)
        tables = [torch.as_tensor(q_to_banks(np.zeros((512, k), np.float32)))
                  for k in (A, 1)]
    else:
        n_act = int(env.action_space.n)
        nsb, _ = bank_geometry(n_obs, n_act)
        tables = [torch.as_tensor(q_to_banks(np.zeros((nsb * W, n_act), np.float32),
                                             nsb))]
        if env.name.startswith("Taxi"):
            tiles = [st.s]
            run = make_fused_q_trainer(env, B, K, 0.99, average_duplicates=True)
        elif env.name.startswith("CRooms"):
            zero = torch.zeros(num_envs, dtype=torch.float32)
            tiles = [st.agent_yx[:, 0], st.agent_yx[:, 1], zero, zero]
            run = make_fused_q_trainer_crooms(env, B, K, 0.99, average_duplicates=True)
        elif env.name.startswith("Multistory"):
            a = st.agent_zyx.to(torch.int32)
            _, H, GW = env.grid_np.shape
            tiles = [a[:, 0] * H * GW + a[:, 1] * GW + a[:, 2]]
            run = make_fused_q_trainer_msrooms(env, B, K, 0.99, average_duplicates=True)
        else:
            a = st.agent_yx.to(torch.int32)
            tiles = [a[:, 0] * env.grid_np.shape[1] + a[:, 1]]
            run = (make_fused_qlambda_trainer_rooms(env, B, K, 0.99, lam=opts["lam"],
                                                    trace_len=opts["trace_len"],
                                                    average_duplicates=True)
                   if opts else
                   make_fused_q_trainer_rooms(env, B, K, 0.99, average_duplicates=True))
    shards = [[t.reshape(-1, W)[r * B // W:(r + 1) * B // W].contiguous() for t in tiles]
              for r in range(2)]
    rews = [[], []]
    i = 0
    for *sizes, steps in schedule:
        for _ in range(-(-steps // K)):
            i += 1
            outs = []
            for r in range(2):
                seed_r = int(chunk_seeds(seed, i, 2)[r])
                if trainer == "ac":
                    th, v, agent, rew = run(seed_r, *sizes, *tables, *shards[r])
                    outs.append(((th, v), [agent], rew))
                else:
                    *s, q, rew = run(seed_r, *sizes, *shards[r], *tables)
                    outs.append(((q,), s, rew))
            tables = [(a + b) / 2 for a, b in zip(outs[0][0], outs[1][0])]
            shards = [o[1] for o in outs]
            for r in range(2):
                rews[r].append(outs[r][2].mean())
    hist = [h / K for h in ((torch.stack(rews[0]) + torch.stack(rews[1])) / 2).tolist()]
    if trainer == "ac":
        return (banks_to_q(tables[0].numpy(), 512, na=A)[:n_obs],
                banks_to_q(tables[1].numpy(), 512, na=1)[:n_obs, 0], hist)
    return banks_to_q(tables[0].numpy(), nsb * W, n_act, nsb)[:n_obs], hist


@pytest.mark.parametrize("trainer,env_id,env_kw,opts", FUSED_CASES, ids=FUSED_IDS)
def test_two_rank_fused_q_learning_equals_the_emulation(ranks, trainer, env_id,
                                                        env_kw, opts):
    """``fused_q_learning(mesh=...)`` and ``fused_actor_critic(mesh=...)``
    on two ranks: each rank resets the whole batch from the seed and keeps
    its rows (CRooms: all four tiles), draws with its chunk seeds, averages
    the tables after each chunk; both ranks return, bit for bit, what the
    two shards run in one process give."""
    sched = [(0.2, 0.3, 16), (0.05, 0.1, 8)]
    kw = dict(seed=3, schedule=sched, num_envs=2048, chunk_steps=8, **opts)
    got = ranks.run(_torch_ranks.fused_trainer_run, DEVICES, trainer, env_id,
                    env_kw, kw)
    env = gpt_torch.make(env_id, device="cpu", **env_kw)
    want = _emulate_two_ranks(trainer, env, 3, sched, 2048, 8, opts)
    for out in got:
        assert len(out) == len(want)
        for x, y in zip(out[:-1], want[:-1]):
            np.testing.assert_array_equal(x, y)
        assert out[-1] == want[-1] and len(out[-1]) == 3
    assert all(np.count_nonzero(t) > 0 for t in want[:-1])
    assert all(np.isfinite(t).all() for t in want[:-1])


@pytest.mark.parametrize("trainer,env_id,env_kw,opts", FUSED_CASES, ids=FUSED_IDS)
def test_one_rank_mesh_is_bit_identical_to_no_mesh(one_rank, trainer, env_id,
                                                   env_kw, opts):
    env = gpt_torch.make(env_id, device="cpu", **env_kw)
    fn = fused_q_learning if trainer == "q" else fused_actor_critic
    sched = [(0.2, 0.3, 16), (0.05, 0.1, 8)]
    kw = dict(num_envs=1024, chunk_steps=8, **opts)
    a = fn(env, 3, sched, **kw)
    b = fn(env, 3, sched, mesh=one_rank, **kw)
    assert one_rank.group is not None and one_rank.size == 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert np.count_nonzero(a[0]) > 0


def test_fused_trainers_refuse_an_indivisible_batch():
    from gym_po_tpu_torch.parallel import Mesh

    mesh = Mesh(None, 0, 3, torch.device("cpu"), dims=(3,))
    env = gpt_torch.make("Taxi-v4", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        fused_q_learning(env, 0, [(0.1, 0.1, 8)], num_envs=2048, mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        fused_actor_critic(gpt_torch.make("Rooms-v0", device="cpu"), 0,
                           [(0.1, 0.1, 8)], num_envs=2048, mesh=mesh)
