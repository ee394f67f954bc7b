"""The port's CUDA kernels against their plain twins, on a CUDA device.

Imports only torch and the port (no jax), so it runs on a machine with a
card and no JAX.  Every test here is marked ``cuda`` and skips without a
device.  On the card::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import collections

import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu_torch.entry import entry
from gym_po_tpu_torch.ops import (
    bank_geometry,
    make_fused_ac_trainer_rooms,
    make_fused_crooms_rollout,
    make_fused_double_q_trainer,
    make_fused_heavenhell_rollout,
    make_fused_msrooms_rollout,
    make_fused_q_trainer,
    make_fused_q_trainer_crooms,
    make_fused_q_trainer_msrooms,
    make_fused_q_trainer_rooms,
    make_fused_qlambda_trainer_rooms,
    make_fused_rocksample_rollout,
    make_fused_rooms_rollout,
    make_fused_tag_rollout,
    make_fused_taxi_rollout,
    q_to_banks,
)

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


# the decoded rollout's divisors (pd, nlocs, nlocs - 1, rows, cols, n_valid):
# every cell navigable and one passenger; blocked cells (the n_valid draw)
# with three; two landmarks (nlocs - 1 = 1) on a 3 x 6 map with blocked cells
TWO_LANDMARKS = ("R  |  ", "      ", "  | G ")
DIVISOR_CASES = [("Taxi-v4", {"num_passengers": 1}),
                 ("ExtendedHansenTaxi-v4", {"num_passengers": 3}),
                 ("Taxi-v4", {"map": TWO_LANDMARKS, "num_passengers": 3})]


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("env_id,kw", DIVISOR_CASES,
                         ids=["all-valid-1", "n-valid-3", "two-landmarks-3"])
def test_fused_taxi_kernel_divisor_cases_equal_twin(cuda, mode, policy,
                                                    env_id, kw):
    env = gpt_torch.make(env_id, time_limit=25, device=cuda, **kw)
    assert env._all_cells_valid == (env_id == "Taxi-v4" and "map" not in kw)
    B, K = 8192, 60
    opts = {}
    if policy:
        opts["policy"] = np.random.default_rng(5).integers(
            0, 5, env.tables.ns).astype(np.int32)
    run = make_fused_taxi_rollout(env, B, K, episode_stats=True,
                                  rng_tape=mode == "tape", rows_per_tile=4,
                                  **opts)
    _, st = env.reset_vec(torch.Generator(device=cuda).manual_seed(3), B)
    s0 = st.s.reshape(-1, 128).contiguous()
    tape = _tape(run, 4, cuda) if mode == "tape" else ()
    got = run(9, s0, *tape)
    want = run.twin(9, s0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert got[4].sum() > 0  # episodes ended


def test_fused_taxi_kernel_rejects_mixed_devices(cuda):
    env = gpt_torch.make("Taxi-v4", device=cuda)
    run = make_fused_taxi_rollout(env, 256, 4, rng_tape=True)
    s = torch.zeros(2, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        run(0, s, torch.zeros(run.tape_shape, dtype=torch.int32))
    assert run.launches == 0


def test_entry_points_default_to_the_card(cuda):
    env = gpt_torch.make("HansenTaxi-v4")
    assert env.device.type == "cuda" and env._cell_move.is_cuda
    _, (model, _, obs, _) = entry(num_envs=256)
    assert obs.is_cuda and next(model.parameters()).is_cuda


def _trainer_inputs(env, run, B, seed, tape, double=False):
    """Start states, Q banks with ``normal(0, 0.1)`` entries (one table or
    the stacked pair) and, in tape mode, a random tape."""
    rng = np.random.default_rng(seed)
    s0 = torch.as_tensor(rng.choice(env.tables.valid_init, B).astype(np.int32),
                         device=env.device).reshape(-1, 128)
    n = env.tables.ns if double else int(env.observation_space.n)
    nsb, nb = bank_geometry(n, 5)
    q = np.zeros(((2 if double else 1) * nb, 128), np.float32)
    for half in np.split(q, 2 if double else 1):
        half[:] = q_to_banks(rng.normal(scale=0.1, size=(n, 5)).astype(
            np.float32), nsb)
    qb = torch.as_tensor(q, device=env.device)
    args = ()
    if tape:
        args = (torch.as_tensor(rng.integers(-2**31, 2**31, run.tape_shape,
                                             dtype=np.int64).astype(np.int32),
                                device=env.device),)
    return s0, qb, args


# env id, builder options ("double": double Q), lr.  Summed duplicates take
# a small lr: at B / ns duplicates an entry, lr = 0.1 diverges, and past the
# fixed point's range the table turns NaN (tested on its own below)
TRAINER_CASES = [
    ("Taxi-v4", dict(average_duplicates=True, expected_sarsa=True), 0.1),
    ("HansenTaxi-v4", dict(average_duplicates=False), 0.002),
    ("ExtendedTaxi-v4", dict(average_duplicates=True, lam=0.9, trace_len=16,
                             watkins_cut=False), 0.1),
    ("Taxi-v4", "double", 0.1),
]


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("env_id,opts,lr", TRAINER_CASES)
def test_q_trainer_kernels_equal_twin(cuda, mode, env_id, opts, lr):
    env = gpt_torch.make(env_id, time_limit=25)
    B, K = 8192, 48
    if opts == "double":
        run = make_fused_double_q_trainer(env, B, K, rng_tape=mode == "tape")
    else:
        run = make_fused_q_trainer(env, B, K, rng_tape=mode == "tape", **opts)
    s0, qb, tape = _trainer_inputs(env, run, B, 3, mode == "tape",
                                   double=opts == "double")
    if mode == "philox":
        qb = torch.zeros_like(qb)  # exact ties among actions
    got = run(11, lr, 0.3, s0, qb, *tape)
    want = run.twin(11, lr, 0.3, s0, qb, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert torch.count_nonzero(got[1] != qb) > 0


def test_q_trainer_kernel_out_of_range_state_equals_twin(cuda):
    env = gpt_torch.make("Taxi-v4", time_limit=25)
    run = make_fused_q_trainer(env, 4096, 32, average_duplicates=True)
    s0, qb, _ = _trainer_inputs(env, run, 4096, 4, False)
    s0.view(-1)[torch.tensor([0, 777, 4095], device=cuda)] = torch.tensor(
        [-1, env.tables.ns, 2**31 - 1], dtype=torch.int32, device=cuda)
    got, want = run(6, 0.1, 0.1, s0, qb), run.twin(6, 0.1, 0.1, s0, qb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert (got[0].view(-1)[[0, 777, 4095]] == -1).all()


@pytest.mark.parametrize("average", [False, True])
def test_q_trainer_kernel_diverging_lr_equals_twin(cuda, average):
    """Past the fixed point's range (|lr * td| > 2^6) an entry becomes NaN
    in the kernel as in the twin, and the run goes on identically."""
    env = gpt_torch.make("Taxi-v4", time_limit=25)
    run = make_fused_q_trainer(env, 8192, 16, average_duplicates=average)
    s0, qb, _ = _trainer_inputs(env, run, 8192, 5, False)
    got, want = run(7, 1e3, 0.3, s0, qb), run.twin(7, 1e3, 0.3, s0, qb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[1]).any()


@pytest.mark.parametrize("which", ["taxi", "double", "rooms", "msrooms"])
def test_one_step_trainers_largest_batch_equal_twin(cuda, which):
    """B = 2^20: the one-step trainers launch at the most envs per thread
    (their registers decide how many blocks are co-resident) and equal
    their twins."""
    B, K = 1 << 20, 4
    if which in ("taxi", "double"):
        env = gpt_torch.make("Taxi-v4", time_limit=25)
        run = (make_fused_double_q_trainer(env, B, K) if which == "double"
               else make_fused_q_trainer(env, B, K, average_duplicates=True))
        s0, qb, _ = _trainer_inputs(env, run, B, 3, False,
                                    double=which == "double")
    else:
        kw = dict(average_duplicates=True)
        if which == "rooms":
            env = gpt_torch.make("Rooms-v0", time_limit=30)
            run = make_fused_q_trainer_rooms(env, B, K, **kw)
            s0, _ = _rooms_cells(env, B, 3)
        else:
            env = gpt_torch.make("MultistoryFourRooms-v0", grid_z=3,
                                 time_limit=30)
            run = make_fused_q_trainer_msrooms(env, B, K, **kw)
            s0, _ = _msrooms_cells(env, B, 3)
        qb = torch.zeros((32, 128), device=cuda)
    got = run(11, 0.1, 0.3, s0, qb)
    want = run.twin(11, 0.1, 0.3, s0, qb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert run.grid[1] >= 4


# ------------------------------------------------------------------ ROOMS
def _rooms_cells(env, B, seed, random_goal=False):
    """Flat agent (and goal) cells on walkable cells, on the env's device."""
    rng = np.random.default_rng(seed)
    GW = env.grid_np.shape[1]
    valid = env.valid_states
    agent = rng.choice(valid, B).astype(np.int32)
    if random_goal or env.fixed_goal_yx is None:
        goal = rng.choice(valid, B).astype(np.int32)
    else:
        goal = np.full(B, env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1],
                       np.int32)
    return (torch.as_tensor(agent, device=env.device).reshape(-1, 128),
            torch.as_tensor(goal, device=env.device).reshape(-1, 128))


def _tape(run, seed, device):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(-2**31, 2**31, run.tape_shape,
                                         dtype=np.int64).astype(np.int32),
                            device=device),)


ROLLOUT_CASES = [
    ("4", {}, 128, True),
    ("16", {"goal_xy": None, "action_type": "cardinal"}, 4, True),
    ("32b", {"agent_xy": (1, 1)}, 4, False),
]


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("layout,kw,rows_per_tile,stats", ROLLOUT_CASES)
def test_fused_rooms_kernel_equals_twin(cuda, mode, layout, kw, rows_per_tile,
                                        stats):
    env = gpt_torch.make("Rooms-v0", layout=layout, time_limit=20, **kw)
    B, K = 8192, 48
    run = make_fused_rooms_rollout(env, B, K, rows_per_tile=rows_per_tile,
                                   episode_stats=stats, rng_tape=mode == "tape")
    a0, g0 = _rooms_cells(env, B, 1)
    tape = _tape(run, 2, cuda) if mode == "tape" else ()
    got = run(9, a0, g0, *tape)
    want = run.twin(9, a0, g0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert torch.unique(got[0]).numel() > 1


def test_fused_rooms_kernel_out_of_range_agent_equals_twin(cuda):
    env = gpt_torch.make("Rooms-v0", goal_xy=None, time_limit=20)
    run = make_fused_rooms_rollout(env, 4096, 32, episode_stats=True)
    a0, g0 = _rooms_cells(env, 4096, 3)
    idx = torch.tensor([0, 777, 4095], device=cuda)
    a0.view(-1)[idx] = torch.tensor([-1, env.grid_np.size, 2**31 - 1],
                                    dtype=torch.int32, device=cuda)
    got, want = run(6, a0, g0), run.twin(6, a0, g0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert (got[0].view(-1)[idx] == -1).all()


# env kwargs, trainer kind ("q", "qlambda" or "ac"), options, lr.  Summed
# duplicates take a small lr: at lr = 0.1 they diverge at B = 8,192 and the
# table turns NaN (tested on Taxi above)
ROOMS_TRAINER_CASES = [
    ({}, "q", dict(average_duplicates=True), 0.1),
    ({"obs_type": "hansen", "action_type": "cardinal"}, "q",
     dict(average_duplicates=False), 0.002),
    ({}, "qlambda", dict(lam=0.9, trace_len=16, average_duplicates=True), 0.1),
    ({"layout": "16"}, "qlambda", dict(lam=0.8, trace_len=4,
                                       watkins_cut=False), 0.002),
    ({}, "ac", {}, 0.1),
    ({"action_type": "cardinal", "agent_xy": (1, 1)}, "ac", {}, 0.1),
]


def _rooms_trainer(env, kind, B, K, opts, rng_tape):
    build = {"q": make_fused_q_trainer_rooms,
             "qlambda": make_fused_qlambda_trainer_rooms,
             "ac": make_fused_ac_trainer_rooms}[kind]
    return build(env, B, K, rng_tape=rng_tape, **opts)


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("kw,kind,opts,lr", ROOMS_TRAINER_CASES)
def test_rooms_trainer_kernels_equal_twin(cuda, mode, kw, kind, opts, lr):
    """Agents, reward sums and tables exact, the actor-critic's included:
    its logf/expf are the library calls torch's log/exp make on the card."""
    env = gpt_torch.make("Rooms-v0", time_limit=30, **kw)
    B, K = 8192, 48
    run = _rooms_trainer(env, kind, B, K, opts, mode == "tape")
    a0, _ = _rooms_cells(env, B, 3)
    tape = _tape(run, 4, cuda) if mode == "tape" else ()
    rng = np.random.default_rng(5)
    A = env.num_actions
    if kind == "ac":
        th = np.zeros((512, A), np.float32)
        th[:env.observation_space.n] = rng.normal(
            scale=0.3, size=(env.observation_space.n, A))
        th = torch.as_tensor(q_to_banks(th), device=cuda)
        if mode == "philox":
            th = torch.zeros_like(th)
        v = torch.zeros_like(th)
        got = run(11, lr, 0.2, th, v, a0, *tape)
        want = run.twin(11, lr, 0.2, th, v, a0, *tape)
        moved = got[0] != th
    else:
        q = np.zeros((512, A), np.float32)
        q[:env.observation_space.n] = rng.normal(
            scale=0.1, size=(env.observation_space.n, A))
        qb = torch.as_tensor(q_to_banks(q), device=cuda)
        if mode == "philox":
            qb = torch.zeros_like(qb)  # exact ties among actions
        got = run(11, lr, 0.3, a0, qb, *tape)
        want = run.twin(11, lr, 0.3, a0, qb, *tape)
        moved = got[1] != qb
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert torch.count_nonzero(moved) > 0
    assert all(torch.isfinite(g).all() for g in got)


def test_rooms_trainers_refuse_what_the_kernels_do_not_take(cuda):
    """n_obs > 512, no fixed goal, B not a multiple of 1024: refused before
    any launch."""
    for build in (make_fused_q_trainer_rooms, make_fused_qlambda_trainer_rooms,
                  make_fused_ac_trainer_rooms):
        with pytest.raises(ValueError, match="512"):
            build(gpt_torch.make("Rooms-v0", layout="32"), 1024, 8)
        with pytest.raises(ValueError, match="fixed goal"):
            build(gpt_torch.make("Rooms-v0", goal_xy=None), 1024, 8)
        with pytest.raises(ValueError, match="1024"):
            build(gpt_torch.make("Rooms-v0"), 1536, 8)



# The trainers whose updates go through per-block sums in shared memory and
# one grid barrier per step (csrc/tabular.cuh BlockSums): Watkins and Peng
# Q(lambda) [12] and the actor-critic [13] on Rooms-v0; the one-step
# trainers, ROOMS Q [3] (duplicates summed and averaged), MSRooms Q [4] at
# grid_z = 3, Taxi Q [2] and double Q [11] on Taxi-v4, whose sums go
# through the block's slab where a launch with it takes the batch and
# straight into the step's global accumulator otherwise (run.grid[2]: 1 for
# the slab).  Each is held to its twin exactly where the design could go
# wrong
REDESIGNED = [
    ("qlambda", dict(lam=0.9, trace_len=16, watkins_cut=True)),
    ("qlambda", dict(lam=0.9, trace_len=16, watkins_cut=False)),
    ("ac", {}),
    ("q", dict(average_duplicates=False)),
    ("q", dict(average_duplicates=True)),
    ("msrooms", dict(average_duplicates=True)),
    ("taxi", dict(average_duplicates=True)),
    ("double", dict(average_duplicates=True)),
]
REDESIGNED_IDS = ["watkins", "peng", "ac", "rooms-q-sum", "rooms-q-average",
                  "msrooms-q", "taxi-q", "double-q"]
ONE_STEP = ("q", "msrooms", "taxi", "double")


def _redesigned_env(kind, taxi_id="Taxi-v4"):
    if kind in ("taxi", "double"):
        return gpt_torch.make(taxi_id, time_limit=25)
    if kind == "msrooms":
        return gpt_torch.make("MultistoryFourRooms-v0", grid_z=3, time_limit=30)
    return gpt_torch.make("Rooms-v0", time_limit=30)


def _redesigned_starts(kind, env, B, one=False):
    """Seeded random start tiles, or (``one``) every env on one start: next
    to the fixed goal on ROOMS and MSRooms, Taxi's first initial state."""
    if not one:
        if kind in ("taxi", "double"):
            return _trainer_inputs(env, None, B, 3, False)[0]
        if kind == "msrooms":
            return _msrooms_cells(env, B, 3)[0]
        return _rooms_cells(env, B, 3)[0]
    if kind in ("taxi", "double"):
        start = int(env.tables.valid_init[0])
    elif kind == "msrooms":
        _, H, GW = env.grid_np.shape
        gz, gy, gx = env.fixed_goal_zyx
        walk = np.flatnonzero(env.grid_np[gz].reshape(-1) > 0)
        dist = np.abs(walk // GW - gy) + np.abs(walk % GW - gx)
        start = gz * H * GW + int(walk[dist == 1][0])
    else:
        start = _next_to_goal(env)
    return torch.full((B // 128, 128), start, dtype=torch.int32,
                      device=env.device)


def _redesigned_call(env, kind, opts, B, K, a0, mode="philox", lr=0.1,
                     seed=11):
    """One call of the kernel and one of its twin on the same inputs:
    ``(run, got, want, tables in)``; Philox from zero tables (exact ties
    among actions), a tape from ``normal(0, 0.1)`` ones.  At K = 0, where
    the twin draws nothing and refuses, ``want`` is the inputs handed back
    with zero reward sums."""
    rng_tape = mode == "tape"
    rng = np.random.default_rng(5)
    if kind in ("taxi", "double"):
        double = kind == "double"
        run = (make_fused_double_q_trainer if double else make_fused_q_trainer)(
            env, B, K, rng_tape=rng_tape, **opts)
        n = env.tables.ns if double else int(env.observation_space.n)
        q = np.zeros(((2 if double else 1) * bank_geometry(n, 5)[1], 128),
                     np.float32)
        if rng_tape:
            q[:] = rng.normal(scale=0.1, size=q.shape)
    else:
        run = (make_fused_q_trainer_msrooms(env, B, K, rng_tape=rng_tape,
                                            **opts) if kind == "msrooms"
               else _rooms_trainer(env, kind, B, K, opts, rng_tape))
        A, n_obs = env.num_actions, env.observation_space.n
        q = np.zeros((512, A), np.float32)
        if rng_tape:
            q[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A))
        q = q_to_banks(q)
    tape = _tape(run, 4, env.device) if rng_tape else ()
    tables = (torch.as_tensor(q, device=env.device),)
    twin = run.twin if K else (
        lambda *args: None)
    if kind == "ac":
        tables += (torch.zeros_like(tables[0]),)
        got = run(seed, lr, 0.2, *tables, a0, *tape)
        want = twin(seed, lr, 0.2, *tables, a0, *tape)
    else:
        got = run(seed, lr, 0.3, a0, *tables, *tape)
        want = twin(seed, lr, 0.3, a0, *tables, *tape)
    if not K:
        zero = torch.zeros(a0.shape, dtype=torch.float32, device=a0.device)
        want = (*tables, a0, zero) if kind == "ac" else (a0, tables[0], zero)
    torch.cuda.synchronize()
    assert run.launches == 1
    return run, got, want, tables


def _next_to_goal(env):
    """A walkable cell one step from the fixed goal: from there the envs
    reach it within a few steps, so the tables move from zero."""
    GW = env.grid_np.shape[1]
    gy, gx = env.fixed_goal_yx
    cells = np.asarray(env.valid_states)
    dist = np.abs(cells // GW - gy) + np.abs(cells % GW - gx)
    return int(cells[dist == 1][0])


def _assert_exact(got, want):
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("kind,opts", REDESIGNED, ids=REDESIGNED_IDS)
def test_redesigned_trainers_one_start_cell_equal_twin(cuda, kind, opts, mode):
    """Every env starts on one cell next to the goal (Taxi: on one state):
    the most same-address adds inside a block; B = 65,536, one env per
    thread, the ring and the one-step slab in shared memory.  Summed
    one-step duplicates take a small lr: all of them land on the same few
    entries."""
    env = _redesigned_env(kind)
    B = 65536
    a0 = _redesigned_starts(kind, env, B, one=True)
    opts = dict(opts, average_duplicates=True) if kind == "qlambda" else opts
    lr = 0.1 if opts.get("average_duplicates", True) else 1e-5
    run, got, want, tables = _redesigned_call(env, kind, opts, B, 12, a0, mode,
                                              lr=lr)
    _assert_exact(got, want)
    assert all(torch.isfinite(g).all() for g in got)
    assert torch.count_nonzero(got[0 if kind == "ac" else 1] != tables[0]) > 0
    if kind != "ac":
        assert run.grid[1:] == (1, 1)  # one env per thread, ring/slab on chip


@pytest.mark.parametrize("kind,opts", REDESIGNED, ids=REDESIGNED_IDS)
def test_redesigned_trainers_diverging_step_equal_twin(cuda, kind, opts):
    """Summed duplicates with a large step: terms past the fixed point's
    range flag their entries NaN through the global count words, as in the
    twin, and the run goes on identically."""
    env = _redesigned_env(kind)
    B = 8192
    a0 = _redesigned_starts(kind, env, B)
    opts = dict(opts, average_duplicates=False) if kind != "ac" else opts
    _, got, want, _ = _redesigned_call(env, kind, opts, B, 16, a0, "tape",
                                       lr=1e3)
    _assert_exact(got, want)
    assert torch.isnan(got[0 if kind == "ac" else 1]).any()


@pytest.mark.parametrize("K", [0, 1, 2, 4])
@pytest.mark.parametrize("kind,opts", REDESIGNED, ids=REDESIGNED_IDS)
def test_redesigned_trainers_few_steps_equal_twin(cuda, kind, opts, K):
    """K = 0, 1, 2 and 4 steps: the three rotating accumulators before and
    after their first reuse; K = 0 hands the tables back unchanged."""
    env = _redesigned_env(kind)
    B = 8192
    a0 = _redesigned_starts(kind, env, B)
    _, got, want, _ = _redesigned_call(env, kind, opts, B, K, a0, "tape")
    _assert_exact(got, want)


@pytest.mark.parametrize("kind,opts", REDESIGNED, ids=REDESIGNED_IDS)
def test_redesigned_trainers_partial_last_slot_equal_twin(cuda, kind, opts):
    """A batch above the co-resident threads and not a multiple of them:
    two or more envs per thread, the last slot partly filled; Q(lambda)'s
    ring then goes to its global buffer, the one-step slab stays on chip."""
    env = _redesigned_env(kind)
    B = 136192
    a0 = _redesigned_starts(kind, env, B)
    run, got, want, _ = _redesigned_call(env, kind, opts, B, 8, a0)
    _assert_exact(got, want)
    blocks, ept = run.grid[:2]
    assert ept >= 2 and B % (blocks * 256) != 0 and B > blocks * 256 * (ept - 1)
    if kind != "ac":
        assert run.grid[2] == (kind in ONE_STEP)


@pytest.mark.parametrize("kind,opts", REDESIGNED, ids=REDESIGNED_IDS)
def test_redesigned_trainers_largest_batch_equal_twin(cuda, kind, opts):
    """B = 2^20, K = 16: the most envs per thread.  Q(lambda)'s ring no
    longer fits in shared memory and goes to its global buffer.  The
    one-step slab's two sides: ROOMS, MSRooms and Taxi keep it on chip at
    8 envs per thread; double Q's stacked pair (5,000 sum words, 60 KB of
    slab beside 32 KB of table) would leave too few blocks for the batch,
    so its terms go straight into the global accumulator."""
    env = _redesigned_env(kind)
    B = 1 << 20
    a0 = _redesigned_starts(kind, env, B)
    run, got, want, _ = _redesigned_call(env, kind, opts, B, 16, a0)
    _assert_exact(got, want)
    assert run.grid[1] >= 4
    if kind != "ac":
        assert run.grid[2] == (kind in ONE_STEP and kind != "double")


def test_one_step_global_side_large_table_equal_twin(cuda):
    """The global side of the one-step slab's choice with one large table:
    ExtendedTaxi-v4's 7,168 entries (6,400 sum words, 76.8 KB of slab
    beside 28 KB of table) at B = 2^20, K = 16."""
    env = _redesigned_env("taxi", "ExtendedTaxi-v4")
    B = 1 << 20
    a0 = _redesigned_starts("taxi", env, B)
    run, got, want, tables = _redesigned_call(
        env, "taxi", dict(average_duplicates=True), B, 16, a0)
    _assert_exact(got, want)
    assert run.grid[1] >= 4 and run.grid[2] == 0
    assert torch.count_nonzero(got[1] != tables[0]) > 0


# ------------------------------------------------------ MultistoryFourRooms
def _msrooms_cells(env, B, seed):
    """Flat agents on every floor, goals from the top-floor bank (or the
    fixed one), on the env's device."""
    rng = np.random.default_rng(seed)
    walk = np.flatnonzero(env.grid_np.reshape(-1) > 0)
    agent = rng.choice(walk, B).astype(np.int32)
    goal = rng.choice(env.valid_goal_states, B).astype(np.int32)
    if env.fixed_goal_zyx is not None:
        goal[:] = np.ravel_multi_index(tuple(env.fixed_goal_zyx), env.grid_np.shape)
    return (torch.as_tensor(agent, device=env.device).reshape(-1, 128),
            torch.as_tensor(goal, device=env.device).reshape(-1, 128))


MSROOMS_CASES = [
    (dict(grid_z=3), 128, True),
    (dict(grid_z=3, goal_xyz=None), 4, True),
    (dict(grid_z=1, action_type="ordinal", agent_xyz=(1, 1, 0)), 4, False),
]


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("kw,rows_per_tile,stats", MSROOMS_CASES)
def test_fused_msrooms_kernel_equals_twin(cuda, mode, kw, rows_per_tile, stats):
    env = gpt_torch.make("MultistoryFourRooms-v0", time_limit=20, **kw)
    B, K = 8192, 48
    run = make_fused_msrooms_rollout(env, B, K, rows_per_tile=rows_per_tile,
                                     episode_stats=stats, rng_tape=mode == "tape")
    a0, g0 = _msrooms_cells(env, B, 1)
    tape = _tape(run, 2, cuda) if mode == "tape" else ()
    got = run(9, a0, g0, *tape)
    want = run.twin(9, a0, g0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert torch.unique(got[0]).numel() > 1


def test_fused_msrooms_kernel_out_of_range_agent_equals_twin(cuda):
    env = gpt_torch.make("MultistoryFourRooms-v0", grid_z=2, goal_xyz=None,
                         time_limit=20)
    run = make_fused_msrooms_rollout(env, 4096, 32, episode_stats=True)
    a0, g0 = _msrooms_cells(env, 4096, 3)
    idx = torch.tensor([0, 777, 4095], device=cuda)
    a0.view(-1)[idx] = torch.tensor([-1, env.grid_np.size, 2**31 - 1],
                                    dtype=torch.int32, device=cuda)
    got, want = run(6, a0, g0), run.twin(6, a0, g0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert (got[0].view(-1)[idx] == -1).all()


# env kwargs, averaged duplicates, lr (summed duplicates take a small lr)
MSROOMS_TRAINER_CASES = [
    (dict(grid_z=3), True, 0.1),
    (dict(grid_z=3), False, 0.002),
    (dict(grid_z=2, action_type="ordinal", obs_type="hansen",
          agent_xyz=(1, 1, 0)), True, 0.1),
]


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("kw,average,lr", MSROOMS_TRAINER_CASES)
def test_msrooms_trainer_kernel_equals_twin(cuda, mode, kw, average, lr):
    env = gpt_torch.make("MultistoryFourRooms-v0", time_limit=30, **kw)
    B, K = 8192, 48
    run = make_fused_q_trainer_msrooms(env, B, K, average_duplicates=average,
                                       rng_tape=mode == "tape")
    a0, _ = _msrooms_cells(env, B, 3)
    tape = _tape(run, 4, cuda) if mode == "tape" else ()
    A = env.num_actions
    q = np.zeros((512, A), np.float32)
    q[:env.observation_space.n] = np.random.default_rng(5).normal(
        scale=0.1, size=(env.observation_space.n, A))
    qb = torch.as_tensor(q_to_banks(q), device=cuda)
    if mode == "philox":
        qb = torch.zeros_like(qb)  # exact ties among actions
    got = run(11, lr, 0.3, a0, qb, *tape)
    want = run.twin(11, lr, 0.3, a0, qb, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert torch.count_nonzero(got[1] != qb) > 0
    assert all(torch.isfinite(g).all() for g in got)


def test_msrooms_trainer_refuses_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError, match="512"):
        make_fused_q_trainer_msrooms(
            gpt_torch.make("MultistoryFourRooms-v0", grid_z=5), 1024, 8)
    with pytest.raises(ValueError, match="fixed goal"):
        make_fused_q_trainer_msrooms(
            gpt_torch.make("MultistoryFourRooms-v0", goal_xyz=None), 1024, 8)
    with pytest.raises(ValueError, match="1024"):
        make_fused_q_trainer_msrooms(
            gpt_torch.make("MultistoryFourRooms-v0"), 1536, 8)


# --------------------------------------------------------------- RockSample
def _rocksample_state(env, B, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, env.rows * env.cols, B).astype(np.int32)
    mask = rng.integers(0, 1 << env.k, B).astype(np.int32)
    return (torch.as_tensor(pos, device=env.device).reshape(-1, 128),
            torch.as_tensor(mask, device=env.device).reshape(-1, 128))


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("map_size,k,stats", [((5, 5), 5, True),
                                              ((7, 7), 8, False),
                                              ((11, 11), 11, True)])
def test_fused_rocksample_kernel_equals_twin(cuda, mode, map_size, k, stats):
    env = gpt_torch.make("RockSample-v0", map_size=map_size, num_rocks=k,
                         time_limit=25)
    B, K = 8192, 48
    run = make_fused_rocksample_rollout(env, B, K, rows_per_tile=4,
                                        episode_stats=stats,
                                        rng_tape=mode == "tape")
    p0, m0 = _rocksample_state(env, B, 1)
    tape = _tape(run, 2, cuda) if mode == "tape" else ()
    got = run(9, p0, m0, *tape)
    want = run.twin(9, p0, m0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert (got[2] > 0).any() and (got[2] < 0).any()


# the action's divisor 5 + k: 6, 9, 16 (a power of two) and 35, on maps with
# rows != cols (and 128 cells, the kernel's most)
@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("map_size,k,stats", [((3, 7), 1, True),
                                              ((4, 9), 4, False),
                                              ((8, 16), 11, True),
                                              ((12, 10), 30, True)])
def test_fused_rocksample_kernel_divisor_cases_equal_twin(cuda, mode, map_size,
                                                          k, stats):
    env = gpt_torch.make("RockSample-v0", map_size=map_size, num_rocks=k,
                         time_limit=25)
    B, K = 8192, 48
    run = make_fused_rocksample_rollout(env, B, K, rows_per_tile=4,
                                        episode_stats=stats,
                                        rng_tape=mode == "tape")
    p0, m0 = _rocksample_state(env, B, 5)
    tape = _tape(run, 6, cuda) if mode == "tape" else ()
    got = run(9, p0, m0, *tape)
    want = run.twin(9, p0, m0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    # rewards and resets happened (at k = 1 the illegal samples' -100 outweigh
    # every exit's +10 in the sums)
    assert (got[2] < 0).any() and (got[1] != m0).any()


def test_fused_rocksample_kernel_out_of_range_pos_equals_twin(cuda):
    env = gpt_torch.make("RockSample-v0", map_size=(7, 7), num_rocks=8)
    run = make_fused_rocksample_rollout(env, 4096, 32, episode_stats=True)
    p0, m0 = _rocksample_state(env, 4096, 3)
    idx = torch.tensor([0, 777, 4095], device=cuda)
    p0.view(-1)[idx] = torch.tensor([-1, 49, 2**31 - 1], dtype=torch.int32,
                                    device=cuda)
    got, want = run(6, p0, m0), run.twin(6, p0, m0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert (got[0].view(-1)[idx] == -1).all()


# ------------------------------------------------- continuous envs (path 5)
def _crooms_state(env, B, seed):
    """(py, px, vy, vx, gy, gx) tiles from reset_vec, with random
    velocities when the env integrates them."""
    _, st = env.reset_vec(torch.Generator(device=env.device).manual_seed(seed), B)
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)
    vel = (torch.rand((B, 2), generator=gen, device=env.device) * 2 - 1
           if env.use_velocity else st.vel_yx)
    cols = (st.agent_yx[:, 0], st.agent_yx[:, 1], vel[:, 0], vel[:, 1],
            st.goal_yx[:, 0], st.goal_yx[:, 1])
    return tuple(c.reshape(-1, 128).contiguous() for c in cols)


CROOMS_CASES = [
    ({}, 128, False),
    ({"use_velocity": True, "goal_xy": None}, 4, True),
    ({"layout": "16", "cell_size": 0.5, "goal_xy": None, "agent_xy": (1, 1),
      "step_reward": -0.01, "wall_reward": -0.1}, 128, True),
]


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("kw,rows_per_tile,stats", CROOMS_CASES)
def test_fused_crooms_kernel_equals_twin(cuda, mode, kw, rows_per_tile, stats):
    env = gpt_torch.make("CRooms-v0", time_limit=20, **kw)
    B, K = 8192, 48
    run = make_fused_crooms_rollout(env, B, K, rows_per_tile=rows_per_tile,
                                    episode_stats=stats, rng_tape=mode == "tape")
    state = _crooms_state(env, B, 3)
    tape = _tape(run, 4, cuda) if mode == "tape" else ()
    got, want = run(9, *state, *tape), run.twin(9, *state, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert torch.unique(got[0]).numel() > 100  # wall resamples and moves


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("stats", [False, True])
def test_fused_tag_kernels_equal_twins(cuda, mode, stats):
    B, K = 8192, 48
    tag = gpt_torch.make("TagContinuous-v0", time_limit=20)
    run = make_fused_tag_rollout(tag, B, K, rows_per_tile=4, episode_stats=stats,
                                 rng_tape=mode == "tape")
    _, st = tag.reset_vec(torch.Generator(device=cuda).manual_seed(5), B)
    state = tuple(c.reshape(-1, 128).contiguous() for c in (
        st.agent_xy[:, 0], st.agent_xy[:, 1], st.target_xy[:, 0],
        st.target_xy[:, 1]))
    tape = _tape(run, 6, cuda) if mode == "tape" else ()
    got, want = run(9, *state, *tape), run.twin(9, *state, *tape)
    hh = gpt_torch.make("HeavenHellContinuous-v0", time_limit=20)
    run_h = make_fused_heavenhell_rollout(hh, B, K, episode_stats=stats,
                                          rng_tape=mode == "tape")
    _, st = hh.reset_vec(torch.Generator(device=cuda).manual_seed(7), B)
    state_h = (st.agent_xy[:, 0].reshape(-1, 128).contiguous(),
               st.agent_xy[:, 1].reshape(-1, 128).contiguous(),
               st.heaven_right.to(torch.int32).reshape(-1, 128))
    tape_h = _tape(run_h, 8, cuda) if mode == "tape" else ()
    got_h, want_h = run_h(9, *state_h, *tape_h), run_h.twin(9, *state_h, *tape_h)
    torch.cuda.synchronize()
    assert run.launches == run_h.launches == 1
    for g, w in zip(got + got_h, want + want_h):
        assert g.is_cuda and torch.equal(g, w)
    assert got_h[2].dtype == torch.int32
    if stats:  # every env truncated at least twice
        assert (got[7] >= 2).all() and (got_h[6] >= 2).all()


# The redesigned rollouts [9] and [8] draw and compute only what a step
# uses, the respawn and the wall hit's resample under branches: held to
# their twins (which draw every site every step) where no env resets, where
# every env resets as often as it can, in warps half resetting or half
# hitting, over short calls, at every kind of cell size and at the largest
# batch.
def _tag_state(env, B, seed):
    _, st = env.reset_vec(torch.Generator(device=env.device).manual_seed(seed), B)
    return [c.reshape(-1, 128).contiguous() for c in (
        st.agent_xy[:, 0], st.agent_xy[:, 1], st.target_xy[:, 0],
        st.target_xy[:, 1])]


def _equal(run, state, tape, K=None, seed=9):
    """The kernel's outputs == the twin's (at K = 0, where the twin refuses
    a call that draws nothing, == the state handed in and zero sums)."""
    got = run(seed, *state, *tape)
    if K != 0:
        want = run.twin(seed, *state, *tape)
    else:
        want = [*state] + [torch.zeros_like(state[0])] * (len(got) - len(state))
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    return got


# (time limit, even lanes tagged at the start, steps); episode stats on
TAG_RESET_CASES = {"no-resets": (500, False, 16), "every-step": (1, False, 16),
                   "half-warps": (500, True, 4)}


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("case", list(TAG_RESET_CASES))
def test_fused_tag_kernel_resets_equal_twin(cuda, mode, case):
    limit, half, K = TAG_RESET_CASES[case]
    B = 8192
    env = gpt_torch.make("TagContinuous-v0", time_limit=limit)
    run = make_fused_tag_rollout(env, B, K, episode_stats=True,
                                 rng_tape=mode == "tape")
    state = _tag_state(env, B, 21)
    if half:  # the target on the agent: a tag at the first step
        for i in (0, 1):
            state[2 + i].view(-1)[0::2] = state[i].view(-1)[0::2]
    tape = _tape(run, 22, cuda) if mode == "tape" else ()
    ep_cnt = _equal(run, state, tape)[7].view(-1)
    if case == "no-resets":
        assert ep_cnt.sum() < B // 100
    elif case == "every-step":
        assert (ep_cnt == K).all()
    else:
        assert (ep_cnt[0::2] >= 1).all() and ep_cnt[1::2].sum() < B // 100


@pytest.mark.parametrize("K", [0, 1, 2, 4])
@pytest.mark.parametrize("mode", ["tape", "philox"])
def test_fused_tag_kernel_few_steps_equal_twin(cuda, mode, K):
    B = 8192
    env = gpt_torch.make("TagContinuous-v0", time_limit=2)
    run = make_fused_tag_rollout(env, B, K, rows_per_tile=4,
                                 episode_stats=True, rng_tape=mode == "tape")
    state = _tag_state(env, B, 23)
    state[2].view(-1)[0::2] = state[0].view(-1)[0::2]
    state[3].view(-1)[0::2] = state[1].view(-1)[0::2]
    _equal(run, state, _tape(run, 24, cuda) if mode == "tape" else (), K)


# env kwargs and what the start does: time limit 1 (CRooms truncates at >,
# so every env resets every second step); even lanes in the wall corner
# (hitting at almost every step) and odd lanes free; even lanes on the goal
# with a wide goal threshold (resetting at the first step)
CROOMS_EDGE_CASES = {
    "no-resets": ({"goal_xy": None}, None),
    "every-second-step": ({"time_limit": 1, "goal_xy": None}, None),
    "half-hitting": ({"wall_reward": -1.0}, "corner"),
    "half-resetting": ({"goal_threshold": 3.0, "goal_xy": None}, "goal"),
}


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("case", list(CROOMS_EDGE_CASES))
def test_fused_crooms_kernel_edge_cases_equal_twin(cuda, mode, case):
    kw, start = CROOMS_EDGE_CASES[case]
    B, K = 8192, 16
    env = gpt_torch.make("CRooms-v0", **{"time_limit": 500, **kw})
    run = make_fused_crooms_rollout(env, B, K, episode_stats=True,
                                    rng_tape=mode == "tape")
    state = list(_crooms_state(env, B, 25))
    if start == "corner":
        state[0].view(-1)[0::2] = 0.05
        state[1].view(-1)[0::2] = 0.05
    elif start == "goal":
        state[0].view(-1)[0::2] = state[4].view(-1)[0::2]
        state[1].view(-1)[0::2] = state[5].view(-1)[0::2]
    tape = _tape(run, 26, cuda) if mode == "tape" else ()
    got = _equal(run, state, tape)
    ep_cnt = got[9].view(-1)
    if case == "no-resets":
        assert ep_cnt.sum() < B // 10
    elif case == "every-second-step":  # a goal reached resets early
        assert (ep_cnt >= K // 2).all()
    elif case == "half-hitting":  # every hit costs 1
        racc = got[6].view(-1)
        assert racc[0::2].mean() < 4 * racc[1::2].mean() < 0
    else:
        assert (ep_cnt[0::2] >= 1).float().mean() > 0.9


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("spawns", ["random", "fixed"])
@pytest.mark.parametrize("vel", [False, True])
@pytest.mark.parametrize("cs", [0.5, 1.0, 2.0, 0.75])
def test_fused_crooms_kernel_cell_sizes_equal_twin(cuda, mode, spawns, vel, cs):
    kw = ({"goal_xy": None} if spawns == "random"
          else {"goal_xy": (3, 3), "agent_xy": (1, 1)})
    env = gpt_torch.make("CRooms-v0", time_limit=12, cell_size=cs,
                         use_velocity=vel, **kw)
    B, K = 8192, 32
    run = make_fused_crooms_rollout(env, B, K, rows_per_tile=4,
                                    episode_stats=True, rng_tape=mode == "tape")
    assert (run.inv_cs != 0) == (cs != 0.75)
    state = _crooms_state(env, B, 27)
    _equal(run, state, _tape(run, 28, cuda) if mode == "tape" else ())


@pytest.mark.parametrize("K", [0, 1, 2, 4])
@pytest.mark.parametrize("mode", ["tape", "philox"])
def test_fused_crooms_kernel_few_steps_equal_twin(cuda, mode, K):
    B = 8192
    env = gpt_torch.make("CRooms-v0", time_limit=1, goal_xy=None)
    run = make_fused_crooms_rollout(env, B, K, episode_stats=True,
                                    rng_tape=mode == "tape")
    state = list(_crooms_state(env, B, 29))
    state[0].view(-1)[0::2] = 0.05
    _equal(run, state, _tape(run, 30, cuda) if mode == "tape" else (), K)


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("which", ["tag", "crooms"])
def test_redesigned_rollouts_largest_batch_equal_twin(cuda, mode, which):
    B, K = 1 << 20, 8
    if which == "tag":
        env = gpt_torch.make("TagContinuous-v0", time_limit=4)
        run = make_fused_tag_rollout(env, B, K, rng_tape=mode == "tape")
        state = _tag_state(env, B, 31)
    else:
        env = gpt_torch.make("CRooms-v0", time_limit=4)
        run = make_fused_crooms_rollout(env, B, K, rng_tape=mode == "tape")
        state = _crooms_state(env, B, 31)
    _equal(run, state, _tape(run, 32, cuda) if mode == "tape" else ())


CROOMS_TRAINER_CASES = [
    ({}, True, 0.1),
    ({"use_velocity": True}, False, 0.002),
    ({"action_type": "cardinal", "agent_xy": (1, 1), "obs_type": "hansen",
      "step_reward": -0.01}, True, 0.1),
]


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("kw,average,lr", CROOMS_TRAINER_CASES)
def test_crooms_trainer_kernel_equals_twin(cuda, mode, kw, average, lr):
    kw = {"action_type": "ordinal", **kw}
    env = gpt_torch.make("CRooms-v0", time_limit=30, **kw)
    B, K = 8192, 32
    run = make_fused_q_trainer_crooms(env, B, K, average_duplicates=average,
                                      rng_tape=mode == "tape")
    py, px, vy, vx, _, _ = _crooms_state(env, B, 11)
    gen = torch.Generator(device=cuda).manual_seed(12)
    qb = (torch.zeros((32, 128), device=cuda) if mode == "philox"
          else 0.1 * torch.randn((32, 128), generator=gen, device=cuda))
    tape = _tape(run, 13, cuda) if mode == "tape" else ()
    got = run(5, lr, 0.3, py, px, vy, vx, qb, *tape)
    want = run.twin(5, lr, 0.3, py, px, vy, vx, qb, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert 0 < int((got[4] != qb).sum()) < qb.numel()


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("cs", [0.5, 1.0, 2.0, 0.75])
def test_crooms_trainer_kernel_cell_sizes_equal_twin(cuda, mode, cs):
    """The trainer's cell lookups and resample multiply by the inverse of a
    power-of-two cell size and divide by any other; its respawn reduces by
    invariant divisors."""
    env = gpt_torch.make("CRooms-v0", action_type="ordinal", time_limit=12,
                         cell_size=cs)
    B, K = 8192, 32
    run = make_fused_q_trainer_crooms(env, B, K, rng_tape=mode == "tape")
    assert (run.inv_cs != 0) == (cs != 0.75)
    py, px, vy, vx, _, _ = _crooms_state(env, B, 33)
    tape = _tape(run, 34, cuda) if mode == "tape" else ()
    qb = torch.zeros((32, 128), device=cuda)
    got = run(7, 0.1, 0.3, py, px, vy, vx, qb, *tape)
    want = run.twin(7, 0.1, 0.3, py, px, vy, vx, qb, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


# [14] on the one-barrier step protocol (per-block update sums in a
# shared-memory slab, or straight into the step's global accumulator where
# the slab does not fit beside a launch that takes the batch; run.grid[2]:
# 1 for the slab) with lazy draws: held to its twin exactly where that
# design could go wrong
def _crooms_redesign_call(mode, B, K, kw=None, q=None, start=None, seed=21,
                          lr=0.1, average=True):
    """``(run, got, want, q in)``: one call of the CRooms Q trainer and of
    its twin on the same inputs (at K = 0, where the twin draws nothing and
    refuses, ``want`` is the inputs handed back with zero reward sums)."""
    env = gpt_torch.make("CRooms-v0", **{"action_type": "ordinal",
                                         "time_limit": 30, **(kw or {})})
    run = make_fused_q_trainer_crooms(env, B, K, average_duplicates=average,
                                      rng_tape=mode == "tape")
    py, px, vy, vx, _, _ = _crooms_state(env, B, seed)
    if start is not None:
        py, px = torch.full_like(py, start[0]), torch.full_like(px, start[1])
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)
    if q is None:
        q = (torch.zeros((32, 128), device=env.device) if mode == "philox"
             else 0.1 * torch.randn((32, 128), generator=gen, device=env.device))
    tape = _tape(run, seed + 2, env.device) if mode == "tape" else ()
    got = run(5, lr, 0.3, py, px, vy, vx, q, *tape)
    want = (run.twin(5, lr, 0.3, py, px, vy, vx, q, *tape) if K
            else (py, px, vy, vx, q, torch.zeros_like(py)))
    torch.cuda.synchronize()
    assert run.launches == 1
    return run, got, want, q


def _next_to_crooms_goal(env):
    """The centre of a walkable cell next to the fixed goal's cell."""
    gy, gx = (float(v) for v in env.fixed_goal_coord)
    for dy, dx in ((-1, 0), (0, -1), (1, 0), (0, 1)):
        y, x = gy + dy, gx + dx
        if env.grid_np[int(y), int(x)] != -1:
            return y, x
    raise AssertionError("the goal has no walkable neighbour")


@pytest.mark.parametrize("mode", ["tape", "philox"])
def test_crooms_trainer_one_start_equals_twin(cuda, mode):
    """Every env starts at one position next to the goal: every term of a
    step lands on the same few entries of the block's slab."""
    env = gpt_torch.make("CRooms-v0", action_type="ordinal")
    run, got, want, q = _crooms_redesign_call(
        mode, 8192, 16, start=_next_to_crooms_goal(env))
    _assert_exact(got, want)
    assert run.grid[1:] == (1, 1)  # one env per thread, the slab on chip
    assert torch.count_nonzero(got[4] != q) > 0


@pytest.mark.parametrize("K", [0, 1, 2, 4])
@pytest.mark.parametrize("mode", ["tape", "philox"])
def test_crooms_trainer_few_steps_equal_twin(cuda, mode, K):
    """K = 0, 1, 2 and 4: the three rotating accumulators before and after
    their first reuse; K = 0 hands the inputs back unchanged."""
    _, got, want, _ = _crooms_redesign_call(mode, 8192, K)
    _assert_exact(got, want)


@pytest.mark.parametrize("mode", ["tape", "philox"])
def test_crooms_trainer_time_limit_1_equals_twin(cuda, mode):
    """Every env resets every second step (truncation at elapsed > 1): the
    respawn's block 3 and its spawn on half the env-steps."""
    run, got, want, _ = _crooms_redesign_call(mode, 8192, 16,
                                              kw={"time_limit": 1})
    _assert_exact(got, want)
    assert run.grid[2] == 1


@pytest.mark.parametrize("mode", ["tape", "philox"])
def test_crooms_trainer_negative_zeros_equal_twin(cuda, mode):
    """-0 entries in q_in (all padding and a third of the used entries):
    the kernel's table load adds + 0, as the twin's whole-table add does,
    so every zero comes out +0 on both."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    q = 0.1 * torch.randn((32, 128), generator=gen, device=cuda)
    q[torch.rand(q.shape, generator=gen, device=cuda) < 0.33] = -0.0
    q[:, 100:] = -0.0
    _, got, want, _ = _crooms_redesign_call(mode, 8192, 4, q=q)
    _assert_exact(got, want)
    zeros = got[4] == 0
    assert zeros.sum() > 1000 and not torch.signbit(got[4][zeros]).any()
    assert torch.equal(torch.signbit(got[4]), torch.signbit(want[4]))


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("side", ["slab", "global"])
def test_crooms_trainer_slab_sides_equal_twin(cuda, mode, side):
    """Both sides of the slab's choice: CRooms-v0 (200 observations, a slab
    of 1,600 words) at B = 8,192 keeps it on chip; layout '16' (422
    observations, 3,392 words, 41 KB of slab beside 16 KB of table) at
    B = 2^20 leaves too few blocks per SM for the batch, so its terms go
    straight into the global accumulator."""
    if side == "slab":
        run, got, want, _ = _crooms_redesign_call(mode, 8192, 8)
    else:
        run, got, want, _ = _crooms_redesign_call(mode, 1 << 20, 8,
                                                  kw={"layout": "16"})
        assert run.grid[1] >= 4
    _assert_exact(got, want)
    assert run.grid[2] == (side == "slab")


@pytest.mark.parametrize("mode", ["tape", "philox"])
def test_crooms_trainer_diverging_step_equals_twin(cuda, mode):
    """Summed duplicates with a large step: terms past the fixed point's
    range flag their entries NaN through the count words, as in the twin."""
    _, got, want, _ = _crooms_redesign_call(mode, 8192, 12, lr=1e3,
                                            average=False)
    _assert_exact(got, want)
    assert torch.isnan(got[4]).any()


# [6] without runtime integer division and with its respawns drawn only
# where an episode ends
@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("time_limit", [20, 1])
@pytest.mark.parametrize("goal", ["fixed", "random"])
@pytest.mark.parametrize("agent", ["fixed", "random"])
def test_fused_msrooms_kernel_spawns_equal_twin(cuda, mode, time_limit, goal,
                                                agent):
    """All four spawn combinations, at time limit 20 and at 1 (every env
    resets every second step)."""
    kw = {} if goal == "fixed" else {"goal_xyz": None}
    if agent == "fixed":
        kw["agent_xyz"] = (1, 1, 0)
    env = gpt_torch.make("MultistoryFourRooms-v0", grid_z=3,
                         time_limit=time_limit, **kw)
    B, K = 8192, 48
    run = make_fused_msrooms_rollout(env, B, K, rows_per_tile=4,
                                     episode_stats=True, rng_tape=mode == "tape")
    a0, g0 = _msrooms_cells(env, B, 5)
    tape = _tape(run, 6, cuda) if mode == "tape" else ()
    got = run(9, a0, g0, *tape)
    want = run.twin(9, a0, g0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    _assert_exact(got, want)
    if time_limit == 1:
        assert (got[5] >= K // 2).all()  # episodes per env


# [10] and [5] with their respawns drawn only where an episode ends ([5]
# also without runtime integer division): held to their twins, which draw
# every site every step
HH_RESET_CASES = {"defaults": (500, False), "every-step": (1, False),
                  "half-warps": (500, True)}


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("case", list(HH_RESET_CASES))
def test_fused_heavenhell_kernel_resets_equal_twin(cuda, mode, case):
    """At the registry's defaults (no env can reach a site in 8 steps from
    the spawn region), at time limit 1 (every env resets every step) and
    with the even lanes started on the heaven site (a reset at the first
    step in every warp, the odd lanes walking on)."""
    limit, half = HH_RESET_CASES[case]
    B, K = 8192, 8
    env = gpt_torch.make("HeavenHellContinuous-v0", time_limit=limit)
    run = make_fused_heavenhell_rollout(env, B, K, rows_per_tile=4,
                                        episode_stats=True,
                                        rng_tape=mode == "tape")
    _, st = env.reset_vec(torch.Generator(device=cuda).manual_seed(33), B)
    state = [st.agent_xy[:, 0].reshape(-1, 128).contiguous(),
             st.agent_xy[:, 1].reshape(-1, 128).contiguous(),
             st.heaven_right.to(torch.int32).reshape(-1, 128).contiguous()]
    if half:
        state[0].view(-1)[0::2] = -6.25
        state[1].view(-1)[0::2] = 6.0
    ep_cnt = _equal(run, state, _tape(run, 34, cuda) if mode == "tape" else ())[6]
    ep_cnt = ep_cnt.view(-1)
    if case == "defaults":
        assert (ep_cnt == 0).all()
    elif case == "every-step":
        assert (ep_cnt == K).all()
    else:
        assert (ep_cnt[0::2] >= 1).all() and (ep_cnt[1::2] == 0).all()


@pytest.mark.parametrize("mode", ["tape", "philox"])
@pytest.mark.parametrize("time_limit", [500, 1])
@pytest.mark.parametrize("goal", ["fixed", "random"])
@pytest.mark.parametrize("agent", ["fixed", "random"])
def test_fused_rooms_kernel_spawns_equal_twin(cuda, mode, time_limit, goal,
                                              agent):
    """All four spawn combinations on layout '4', at the registry's time
    limit and at 1 (every env resets every second step), a third of the
    agents next to their goals."""
    kw = {} if goal == "fixed" else {"goal_xy": None}
    if agent == "fixed":
        kw["agent_xy"] = (1, 1)
    env = gpt_torch.make("Rooms-v0", time_limit=time_limit, **kw)
    B, K = 8192, 48
    run = make_fused_rooms_rollout(env, B, K, rows_per_tile=4,
                                   episode_stats=True, rng_tape=mode == "tape")
    a0, g0 = _rooms_cells(env, B, 7)
    near = g0.view(-1)[0::3] - 1  # west of the goal, where that is walkable
    walk = torch.as_tensor(env.grid_np.reshape(-1) >= 0, device=cuda)
    a0.view(-1)[0::3] = torch.where(walk[near.long()], near, a0.view(-1)[0::3])
    tape = _tape(run, 8, cuda) if mode == "tape" else ()
    got = run(9, a0, g0, *tape)
    want = run.twin(9, a0, g0, *tape)
    torch.cuda.synchronize()
    assert run.launches == 1
    _assert_exact(got, want)
    if time_limit == 1:
        assert (got[5] >= K // 2).all()  # episodes per env
    else:
        assert got[5].sum() > 0


# ---------------------------------------------------------------- PPO
PPO_ENVS = [("ExtendedHansenTaxi-v4", {}), ("DiscreteCarFlag-v0", {}),
            ("CarFlag-v0", {}), ("HeavenHellContinuous-v0", {"time_limit": 20})]


def _ppo(dev, env_id, kw, B=512, T=16, seed=0):
    from gym_po_tpu_torch.agents import ppo

    env = gpt_torch.make(env_id, device=dev, **kw)
    cfg = ppo.PPOConfig(num_envs=B, rollout_steps=T, epochs=2, minibatches=2,
                        hidden=(32, 32))
    model, ts = ppo.init_train_state(
        env, cfg, torch.Generator(device=dev).manual_seed(seed))
    return ppo, env, cfg, model, ts


def _generator_at(state, device):
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def _assert_collect_equal(got, want):
    (gb, gr, gobs, gst), (wb, wr, wobs, wst) = got, want
    for g, w in zip((*gb, *gr, gobs), (*wb, *wr, wobs)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for f in wst.__dataclass_fields__:
        assert torch.equal(getattr(gst, f), getattr(wst, f)), f


@pytest.mark.parametrize("env_id,kw", PPO_ENVS)
def test_ppo_collect_graph_replay_equals_eager(cuda, env_id, kw):
    """The train step's graph replays the eager collect bit for bit from one
    generator state, at its first replay and after updates have changed
    the weights in place (the graph reads them where they lie)."""
    ppo, env, cfg, model, ts = _ppo(cuda, env_id, kw)
    step = ppo.make_train_step(env, model, cfg)
    for _ in range(3):
        start = ts.generator.get_state()
        eager = ppo.collect(env, model, cfg, ts.env_obs, ts.env_state,
                            _generator_at(start, cuda))
        if step.graph is not None:
            replay = step.graph(ts.env_obs, ts.env_state, ts.generator)
            _assert_collect_equal(replay, eager)
            ts.generator.set_state(start)
        before = ts.params.clone()
        ts, metrics = step(ts)
        assert step.graph is not None
        assert not torch.equal(before, ts.params)
        assert all(torch.isfinite(v) for v in metrics.values())
        collect_ms, learn_ms = ppo.halves_ms(step)
        assert collect_ms > 0 and learn_ms > 0
        # the update's collect was the replay of the eager one above
        assert torch.equal(ts.env_obs, eager[2])
    with pytest.raises(ValueError):
        step.graph(ts.env_obs, ts.env_state, torch.Generator(device=cuda))


def test_ppo_learn_on_card_equals_cpu(cuda):
    """The learn half on the card from the CPU's batch, weights and row
    orders equals the CPU's to atol 1e-6: the card's matmuls sum in
    another order, and so does the first layer's backward (``embed_grad``'s
    kernel, in blocks of rows, against the twin's row order)."""
    ppo, env, cfg, model, ts = _ppo(torch.device("cpu"), "ExtendedHansenTaxi-v4",
                                    {}, B=256, T=16)
    cfg = cfg._replace(epochs=4, minibatches=4)
    batch, _, _, _ = ppo.collect(env, model, cfg, ts.env_obs, ts.env_state,
                                 ts.generator)
    orders = ppo.row_orders(cfg, batch.obs.shape[0], ts.generator)
    from gym_po_tpu_torch.agents.networks import (AdamState, flatten_parameters,
                                                  make_actor_critic)

    card = make_actor_critic(env, cfg.hidden, device=cuda)
    flat = flatten_parameters(card)
    flat.copy_(ts.params)
    opt = AdamState.zeros_like(flat)
    got = ppo.learn(card, flat, opt, cfg, ppo.Batch(*(x.to(cuda) for x in batch)),
                    [o.to(cuda) for o in orders])
    want = ppo.learn(model, ts.params, ts.opt_state, cfg, batch, orders)
    torch.testing.assert_close(flat.cpu(), ts.params, atol=1e-6, rtol=0)
    torch.testing.assert_close(opt.mu.cpu(), ts.opt_state.mu, atol=1e-6, rtol=1e-4)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5, atol=1e-6)
    assert int(opt.count) == int(ts.opt_state.count) == 16


def test_ppo_train_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the collect half is a CUDA graph")
    from gym_po_tpu_torch.agents import ppo

    env = gpt_torch.make("Taxi-v4")
    cfg = ppo.PPOConfig(num_envs=64, rollout_steps=8, epochs=1, minibatches=2,
                        hidden=(16,))
    model, ts, history = ppo.train(env, cfg, seed=0, num_updates=3, log_every=2)
    assert ts.update_idx == 3 and len(history) == 2
    assert ts.env_obs.is_cuda and next(model.parameters()).is_cuda
    assert all(np.isfinite(h["loss"]) for h in history)


def _assert_train_states_equal(a, b):
    """Parameters, Adam state, env observations and state, generator state
    and update count, bit for bit."""
    assert a.update_idx == b.update_idx
    for x, y in ((a.params, b.params), (a.opt_state.count, b.opt_state.count),
                 (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
                 (a.env_obs, b.env_obs),
                 (a.generator.get_state(), b.generator.get_state())):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for f in a.env_state.__dataclass_fields__:
        assert torch.equal(getattr(a.env_state, f), getattr(b.env_state, f)), f


UPDATE_GRAPH_CASES = [("ExtendedHansenTaxi-v4", {}),
                      ("AntTagPhysics-v0", {"frame_skip": 2, "integrator": "euler",
                                            "time_limit": 3})]


@pytest.mark.parametrize("env_id,kw", UPDATE_GRAPH_CASES)
def test_update_graph_replay_equals_eager_updates(cuda, env_id, kw):
    """make_multi_train_step's three replays of one UpdateGraph (collect,
    row orders, learn, metrics in one CUDA graph) equal three eager updates
    from the same state bit for bit: parameters, Adam state, observations,
    env state, generator state and each metric row; a replay counts the
    kernels it launches: the ant kernels, and the taxi's ``embed_grad``
    once a minibatch."""
    from gym_po_tpu_torch.ops._build import LAUNCHES

    ant = env_id.startswith("Ant")
    B, T = (64, 2) if ant else (512, 16)
    ppo, env, cfg, model, ts = _ppo(cuda, env_id, kw, B=B, T=T)
    _, _, _, model_e, ts_e = _ppo(cuda, env_id, kw, B=B, T=T)
    multi = ppo.make_multi_train_step(env, model, cfg, 3)
    ts, got = multi(ts)
    rows = []
    for _ in range(3):
        ts_e, m = ppo.eager_update(env, model_e, cfg, ts_e)
        rows.append(m)
    _assert_train_states_equal(ts, ts_e)
    assert set(got) == set(ppo.METRIC_NAMES)
    for i, m in enumerate(rows):
        for k in ppo.METRIC_NAMES:
            assert got[k].shape == (3,) and torch.equal(got[k][i], m[k]), (i, k)
    per_replay = collections.Counter()
    for (_, name), n in multi.graph.launches.items():
        per_replay[name] += n
    # the taxi's first layer is an index: its backward a kernel a minibatch
    assert per_replay["embed_grad"] == (0 if ant else cfg.epochs * cfg.minibatches)
    assert (per_replay["ant_newton"] > 0) == ant
    before = LAUNCHES.copy()
    ts, _ = multi(ts)  # a second call replays the same graph, from ts
    assert ts.update_idx == 6
    for name in ("ant_newton", "embed_grad"):
        assert LAUNCHES[name] - before[name] == 3 * per_replay[name]
    if ant:
        assert per_replay["ant_newton"] == T * 2 * 1
    _, _, _, _, other = _ppo(cuda, env_id, kw, B=B, T=T)
    with pytest.raises(ValueError):
        multi(other)  # another train state's parameters


def test_multi_bounded_equals_plain_on_card(cuda):
    """bounded(5) with limit 3 replays three updates: the state and the
    generator equal plain(3)'s, rows 3-4 are NaN; at the limit it replays
    none."""
    ppo, env, cfg, model, ts = _ppo(cuda, "ExtendedHansenTaxi-v4", {})
    _, _, _, model_p, ts_p = _ppo(cuda, "ExtendedHansenTaxi-v4", {})
    ts, got = ppo.make_multi_train_step(env, model, cfg, 5, bounded=True)(ts, 3)
    ts_p, want = ppo.make_multi_train_step(env, model_p, cfg, 3)(ts_p)
    _assert_train_states_equal(ts, ts_p)
    for k in want:
        assert torch.equal(got[k][:3], want[k]) and torch.isnan(got[k][3:]).all()


def test_chunked_train_step_collect_graph_equals_eager_chunks(cuda, monkeypatch):
    """The chunked train step replays one collect graph per chunk; with the
    graph swapped for the eager collect (one eager collect per chunk from
    the same generator) the update is the same bit for bit."""
    from gym_po_tpu_torch.agents import ppo

    def chunked(seed=0):
        env = gpt_torch.make("ExtendedHansenTaxi-v4", device=cuda)
        cfg = ppo.PPOConfig(num_envs=256, rollout_steps=8, epochs=2,
                            minibatches=4, hidden=(32, 32))
        model, ts = ppo.init_train_state(
            env, cfg, torch.Generator(device=cuda).manual_seed(seed))
        return ts, ppo.make_chunked_train_step(env, model, cfg, dispatch_batch=64)

    ts, step = chunked()
    ts, got = step(ts)
    assert step.graph is not None

    class EagerCollect:
        def __init__(self, env, model, config, obs, state, generator):
            self.args = env, model, config

        def __call__(self, obs, state, generator):
            return ppo.collect(*self.args, obs, state, generator)

    monkeypatch.setattr(ppo, "CollectGraph", EagerCollect)
    ts_e, step_e = chunked()
    ts_e, want = step_e(ts_e)
    assert isinstance(step_e.graph, EagerCollect)
    _assert_train_states_equal(ts, ts_e)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------- recurrent PPO
RNN_CASES = [("ExtendedHansenTaxi-v4", {}, torch.float32),
             ("HeavenHellContinuous-v0", {"time_limit": 20}, torch.float32),
             ("DiscreteCarFlag-v0", {}, torch.bfloat16)]


def _rnn(dev, env_id, kw, dtype=torch.float32, B=512, T=16, seed=0):
    from gym_po_tpu_torch.agents import ppo, ppo_rnn

    env = gpt_torch.make(env_id, device=dev, **kw)
    cfg = ppo.PPOConfig(num_envs=B, rollout_steps=T, epochs=2, minibatches=2,
                        compute_dtype=dtype)
    model, ts = ppo_rnn.init_rnn_state(
        env, cfg, torch.Generator(device=dev).manual_seed(seed), hidden=32)
    return ppo_rnn, env, cfg, model, ts


def _assert_rnn_collect_equal(got, want):
    (gseq, gro, *gfinal), (wseq, wro, *wfinal) = got, want
    for g, w in zip((*gseq, *gro), (*wseq, *wro)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    gobs, gst, gh, gr = gfinal
    wobs, wst, wh, wr = wfinal
    for g, w in ((gobs, wobs), (gh, wh), (gr, wr)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for f in wst.__dataclass_fields__:
        assert torch.equal(getattr(gst, f), getattr(wst, f)), f


@pytest.mark.parametrize("env_id,kw,dtype", RNN_CASES)
def test_rnn_collect_graph_replay_equals_eager(cuda, env_id, kw, dtype):
    """The recurrent train step's graph replays the eager ``collect_rnn``
    bit for bit from one generator state, hidden state and reset flags, at
    its first replay and after updates."""
    from gym_po_tpu_torch.agents.ppo import halves_ms

    ppo_rnn, env, cfg, model, ts = _rnn(cuda, env_id, kw, dtype)
    step = ppo_rnn.make_rnn_train_step(env, model, cfg)
    for _ in range(3):
        start = ts.generator.get_state()
        eager = ppo_rnn.collect_rnn(env, model, cfg, ts.env_obs, ts.env_state,
                                    _generator_at(start, cuda), ts.hidden,
                                    ts.prev_reset)
        if step.graph is not None:
            replay = step.graph(ts.env_obs, ts.env_state, ts.generator,
                                ts.hidden, ts.prev_reset)
            _assert_rnn_collect_equal(replay, eager)
            ts.generator.set_state(start)
        before = ts.params.clone()
        ts, metrics = step(ts)
        assert not torch.equal(before, ts.params)
        assert all(torch.isfinite(v) for v in metrics.values())
        assert ts.hidden.dtype == dtype and torch.isfinite(ts.hidden).all()
        assert min(halves_ms(step)) > 0
        assert torch.equal(ts.env_obs, eager[2]) and torch.equal(ts.hidden, eager[4])
    with pytest.raises(ValueError):
        step.graph(ts.env_obs, ts.env_state, ts.generator)  # no carry


@pytest.mark.parametrize("recurrent", [False, True], ids=["ppo", "recurrent"])
def test_resume_on_card_is_exact(cuda, tmp_path, recurrent):
    """save -> the next update straight through; restore into a fresh state
    (its own step, its own graph) -> the same update, bit for bit."""
    from gym_po_tpu_torch.agents import ppo
    from gym_po_tpu_torch.utils import restore_checkpoint, save_checkpoint

    def fresh(seed):
        if recurrent:
            ppo_rnn, env, cfg, model, ts = _rnn(cuda, "ExtendedHansenTaxi-v4", {},
                                                seed=seed)
            return model, ts, ppo_rnn.make_rnn_train_step(env, model, cfg)
        ppo_, env, cfg, model, ts = _ppo(cuda, "ExtendedHansenTaxi-v4", {},
                                         seed=seed)
        return model, ts, ppo.make_train_step(env, model, cfg)

    model, ts, step = fresh(0)
    ts, _ = step(ts)
    save_checkpoint(str(tmp_path), 1, ts)
    ts_a, m_a = step(ts)
    _, ts_b, step_b = fresh(7)
    ts_b, m_b = step_b(restore_checkpoint(str(tmp_path), ts_b))
    assert torch.equal(ts_a.params, ts_b.params)
    assert torch.equal(ts_a.opt_state.nu, ts_b.opt_state.nu)
    assert torch.equal(ts_a.env_obs, ts_b.env_obs)
    assert torch.equal(ts_a.generator.get_state(), ts_b.generator.get_state())
    if recurrent:
        assert torch.equal(ts_a.hidden, ts_b.hidden)
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)


# ------------------------------------------------------------ data parallel
@pytest.fixture
def nccl_one_rank(cuda, tmp_path):
    """An NCCL group of one rank in this process, and its mesh."""
    import torch.distributed as dist

    from gym_po_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield make_mesh(devices=[cuda])
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_taxi_q_equals_no_mesh(nccl_one_rank):
    """The fused Taxi Q trainer [2] through ``fused_q_learning``: a one-rank
    NCCL mesh (its all-reduce the identity) gives what no mesh gives, bit
    for bit, through the kernel."""
    from gym_po_tpu_torch.agents import fused_q_learning
    from gym_po_tpu_torch.ops._build import LAUNCHES

    env = gpt_torch.make("Taxi-v4", device=nccl_one_rank.device)
    kw = dict(seed=5, schedule=[(0.2, 0.3, 128), (0.05, 0.1, 64)],
              num_envs=8192, chunk_steps=64)
    before = LAUNCHES["fused_qlearning"]
    q_a, h_a = fused_q_learning(env, **kw)
    q_b, h_b = fused_q_learning(env, mesh=nccl_one_rank, **kw)
    assert LAUNCHES["fused_qlearning"] - before == 6
    np.testing.assert_array_equal(q_a, q_b)
    assert h_a == h_b and np.count_nonzero(q_a) > 0


def test_one_rank_nccl_mesh_ppo_update_equals_no_mesh(nccl_one_rank):
    """Two PPO updates with a one-rank NCCL mesh (the gradient and metric
    all-reduces) equal the same without it, bit for bit."""
    from gym_po_tpu_torch.agents import ppo

    dev = nccl_one_rank.device
    env = gpt_torch.make("ExtendedHansenTaxi-v4", device=dev)
    cfg = ppo.PPOConfig(num_envs=512, rollout_steps=16, epochs=2, minibatches=4)
    out = []
    for mesh in (None, nccl_one_rank):
        # one state for both: shard_train_state would give the mesh's run a
        # generator of its own
        model, ts = ppo.init_train_state(env, cfg,
                                         torch.Generator(device=dev).manual_seed(3))
        step = ppo.make_train_step(env, model, cfg, mesh)
        for _ in range(2):
            ts, metrics = step(ts)
        out.append((ts.params.clone(), metrics))
    (pa, ma), (pb, mb) = out
    assert torch.equal(pa, pb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_one_rank_nccl_mesh_multi_step_equals_no_mesh(nccl_one_rank):
    """make_multi_train_step with a one-rank NCCL mesh (its all-reduces
    captured in the update's graph) equals it without a mesh, bit for bit,
    over two updates."""
    from gym_po_tpu_torch.agents import ppo

    dev = nccl_one_rank.device
    env = gpt_torch.make("ExtendedHansenTaxi-v4", device=dev)
    cfg = ppo.PPOConfig(num_envs=512, rollout_steps=16, epochs=2, minibatches=4)
    out = []
    for mesh in (None, nccl_one_rank):
        model, ts = ppo.init_train_state(env, cfg,
                                         torch.Generator(device=dev).manual_seed(3))
        multi = ppo.make_multi_train_step(env, model, cfg, 2, mesh)
        out.append(multi(ts) + (multi.graph,))
    (ta, ma, ga), (tb, mb, gb) = out
    assert ga is not None and gb is not None
    _assert_train_states_equal(ta, tb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


# ------------------------------------------------------- the articulated ant
ANT_IDS = ["AntTagPhysics-v0", "AntHeavenHellPhysics-v0"]


def _ant_states(n, seed):
    from gym_po_tpu_torch.envs.ant_physics import STAND_POSE

    rng = np.random.default_rng(seed)
    qpos = np.tile(STAND_POSE.astype(np.float64), (n, 1))
    qpos[:, :2] = rng.uniform(-3.5, 3.5, (n, 2))
    qpos[:, 2] += rng.uniform(-0.1, 0.05, n)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, 8))
    qpos[n // 2:, 0] = 4.4  # against the east wall
    return (qpos, 0.5 * rng.normal(size=(n, 14)), rng.uniform(-1, 1, (n, 8)),
            0.1 * rng.normal(size=(n, 14)))


def test_ant_engine_on_card_equals_cpu(cuda):
    """The engine on the card against the CPU's at f64, with either
    pipeline on the card (``"scalar"``: the per-env kernels; ``"array"``:
    the batched engine): a forward and an RK4 step (frame_skip 2, 15
    iterations), relative to max(1, |x|) within 1e-9."""
    from gym_po_tpu_torch.physics import TAG_WALLS, make_ant_model
    from gym_po_tpu_torch.physics.engine import PhysicsState, forward, step

    model = make_ant_model(TAG_WALLS)
    arrays = _ant_states(32, 0)
    for pipeline in ("scalar", "array"):
        for fn in (lambda q, v, c, w: forward(model, q, v, c, w, iters=15,
                                              pipeline=pipeline),
                   lambda q, v, c, w: tuple(step(
                       model, PhysicsState(q, v, w), c, frame_skip=2, iters=15,
                       pipeline=pipeline))):
            got = fn(*(torch.as_tensor(x, device=cuda) for x in arrays))
            want = fn(*(torch.as_tensor(x) for x in arrays))
            for g, w in zip(got, want):
                assert g.dtype == torch.float64
                err = ((g.cpu() - w).abs() / w.abs().clamp_min(1.0)).max()
                assert err <= 1e-9


@pytest.mark.parametrize("env_id", ANT_IDS)
def test_ant_step_vec_waits_on_no_host_sync(cuda, env_id):
    env = gpt_torch.make(env_id, frame_skip=2, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, st = env.reset_vec(gen, 256)
    act = torch.rand(256, 8, generator=gen, device=cuda) * 2 - 1
    env.step_vec(gen, st, act)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        obs, st, *_ = env.step_vec(gen, st, act)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(obs).all() and obs.is_cuda


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_ant_ppo_collect_graph_replay_equals_eager(cuda, integrator):
    """The ant's env step captured in PPO's collect graph replays the eager
    collect bit for bit, and a replay counts the kernel launches it makes
    (the capture counts none)."""
    from gym_po_tpu_torch.ops import ant_forward as af

    ppo, env, cfg, model, ts = _ppo(cuda, "AntTagPhysics-v0",
                                    {"frame_skip": 2, "integrator": integrator,
                                     "time_limit": 3}, B=64, T=4)
    step = ppo.make_train_step(env, model, cfg)
    ts, _ = step(ts)
    start = ts.generator.get_state()
    n0 = af.ant_newton.launches
    eager = ppo.collect(env, model, cfg, ts.env_obs, ts.env_state,
                        _generator_at(start, cuda))
    n_eager = af.ant_newton.launches - n0
    assert n_eager == 4 * 2 * (4 if integrator == "rk4" else 1)
    assert step.graph.launches[af.ant_newton, "ant_newton"] == n_eager
    replay = step.graph(ts.env_obs, ts.env_state, ts.generator)
    assert af.ant_newton.launches - n0 == 2 * n_eager
    _assert_collect_equal(replay, eager)
    ts.generator.set_state(start)
    ts, metrics = step(ts)
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("env_id", ANT_IDS)
def test_ant_render_of_a_card_state_equals_its_cpu_copy(cuda, env_id):
    """render_ant of 4 rows of a B = 4,096 card state after one step equals
    render_ant of the state's CPU copy; the card's f64 ``fk`` matches the
    renderer's NumPy FK to 1e-12."""
    from gym_po_tpu_torch.core import map_tensors
    from gym_po_tpu_torch.physics.dynamics import fk
    from gym_po_tpu_torch.render import render_ant
    from gym_po_tpu_torch.render.renderers import _np_fk

    env = gpt_torch.make(env_id, frame_skip=2, integrator="euler", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, st = env.reset_vec(gen, 4096)
    act = torch.rand(4096, 8, generator=gen, device=cuda) * 2 - 1
    _, st, *_ = env.step_vec(gen, st, act)
    rows = [0, 1, 2047, 4095]
    got = render_ant(env, st, rows)
    want = render_ant(env, map_tensors(lambda t: t.cpu(), st), rows)
    np.testing.assert_array_equal(got, want)
    q = st.qpos[rows].double()
    xpos, _, xmat = fk(env.model, q)
    for k in range(len(rows)):
        p, m = _np_fk(env.model, q[k].cpu().numpy())
        np.testing.assert_allclose(xpos[k].cpu().numpy(), p, rtol=0, atol=1e-12)
        np.testing.assert_allclose(xmat[k].cpu().numpy(), m, rtol=0, atol=1e-12)


# ------------------------------------------- the ant's scalar forward kernels
def _rel(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


def _ant_kernel_inputs(cuda, walls, dtype, n=64, seed=0):
    from gym_po_tpu_torch.physics import HEAVEN_HELL_WALLS, TAG_WALLS, make_ant_model

    model = make_ant_model(TAG_WALLS if walls == "tag" else HEAVEN_HELL_WALLS)
    arrays = _ant_states(n, seed)
    return model, [torch.as_tensor(x, dtype=dtype, device=cuda) for x in arrays]


@pytest.mark.parametrize("walls", ["tag", "hh"])
def test_ant_kernels_equal_twins_f64(cuda, walls):
    """Each of ant_smooth, ant_rows and ant_newton against its plain twin
    on the same inputs at f64, relative to max(1, |x|) within 1e-9: M,
    qacc_smooth and the kinematics; the rows densified through the support
    table (every entry off it zero in the twin) and aref, r, the active
    flags exactly; qacc and the warm start out of 8 iterations."""
    from gym_po_tpu_torch.ops import ant_forward as af

    model, (qpos, qvel, ctrl, warm) = _ant_kernel_inputs(cuda, walls,
                                                         torch.float64)
    n0 = (af.ant_smooth.launches, af.ant_rows.launches, af.ant_newton.launches)
    sm = af.ant_smooth(model, qpos, qvel, ctrl)
    tw = af.smooth_twin(model, qpos, qvel, ctrl)
    for g, w in zip(sm, tw):
        assert _rel(g, w) <= 1e-9
    rows = af.ant_rows(model, sm.skin, qpos, qvel)
    rt = af.rows_twin(model, sm.skin, qpos, qvel)
    full = af._contact.constraint_rows(model, af._skin_kinematics(model, sm.skin),
                                       qpos, qvel)
    assert _rel(af.dense_rows(model, rows).jac, full.jac) <= 1e-9
    for name in ("aref", "r"):
        assert _rel(getattr(rows, name), getattr(rt, name)) <= 1e-9, name
    assert torch.equal(rows.active, rt.active)
    assert rows.active[8:].sum() > 0
    got = af.ant_newton(model, sm, rows, warm, iters=8)
    want = af.newton_twin(model, sm, rows, warm, iters=8)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9
    assert (af.ant_smooth.launches, af.ant_rows.launches,
            af.ant_newton.launches) == tuple(x + 1 for x in n0)


@pytest.mark.parametrize("walls", ["tag", "hh"])
def test_ant_kernels_equal_twins_f32(cuda, walls):
    """At f32: the kernels' rows against the twin's on the same kinematics,
    the active flags equal except on rows whose candidate lies within 1e-5
    of its threshold and on the capsule-box slots whose validity is a
    coincidence test of two f32 parameters
    (``chip_smoke.ant_coincidence_rows``); the physics stage of a step (RK4, frame_skip 3, 8 iterations) with
    "scalar" against "array" from one state of the env in motion: qpos
    and qvel within 1e-4, the warm start within 2e-3 relative to
    max(1, |x|)."""
    from gym_po_tpu_torch.ops import ant_forward as af
    from gym_po_tpu_torch.physics.engine import PhysicsState, step

    model, (qpos, qvel, ctrl, warm) = _ant_kernel_inputs(cuda, walls,
                                                         torch.float32)
    sm = af.ant_smooth(model, qpos, qvel, ctrl)
    rows = af.ant_rows(model, sm.skin, qpos, qvel)
    rt = af.rows_twin(model, sm.skin, qpos, qvel)
    differ = rows.active != rt.active
    from chip_smoke import ant_coincidence_rows, ant_row_margin

    coincide = torch.as_tensor(ant_coincidence_rows(model), device=cuda)[:, None]
    margin = ant_row_margin(model, sm.skin, qpos).abs()
    assert not (differ & ~coincide & (margin > 1e-5)).any()
    # the step gates hold on states of the env in motion (on the random
    # contact states above f32 strays from f64 by 1e-2 m either way)
    env = gpt_torch.make(ANT_IDS[walls == "hh"], frame_skip=3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    _, st = env.reset_vec(gen, 64)
    act = torch.rand(64, 8, generator=gen, device=cuda) * 2 - 1
    for _ in range(2):
        _, st, *_ = env.step_vec(gen, st, act)
    out = {p: step(env.model, PhysicsState(st.qpos, st.qvel, st.warm), act,
                   frame_skip=3, iters=8, pipeline=p) for p in ("scalar", "array")}
    for k, lim in zip(range(3), (1e-4, 1e-4, 2e-3)):
        g, w = out["scalar"][k], out["array"][k]
        err = (g - w).abs() if k < 2 else (g - w).abs() / w.abs().clamp_min(1.0)
        assert torch.isfinite(g).all() and err.max().item() <= lim


def test_ant_scalar_forward_runs_no_array_code(cuda, monkeypatch):
    """On a CUDA tensor pipeline="scalar" launches the three kernels once a
    forward and never the batched engine; "array" launches none."""
    from gym_po_tpu_torch.ops import ant_forward as af
    from gym_po_tpu_torch.physics import contact, dynamics, engine

    model, (qpos, qvel, ctrl, warm) = _ant_kernel_inputs(cuda, "tag",
                                                         torch.float32)
    engine.forward(model, qpos, qvel, ctrl, warm)  # the first call, eager

    def refuse(*a, **k):
        raise AssertionError("the array engine ran")

    n0 = (af.ant_smooth.launches, af.ant_rows.launches, af.ant_newton.launches)
    with monkeypatch.context() as m:
        for mod, name in ((engine, "smooth_forward"),
                          (engine, "constraint_rows"),
                          (engine, "solve_constraints_newton")):
            m.setattr(mod, name, refuse)
        engine.forward(model, qpos, qvel, ctrl, warm)
    assert (af.ant_smooth.launches, af.ant_rows.launches,
            af.ant_newton.launches) == tuple(x + 1 for x in n0)
    engine.forward(model, qpos, qvel, ctrl, warm, pipeline="array")
    assert af.ant_newton.launches == n0[2] + 1
    with pytest.raises(ValueError):
        af.ant_smooth(model, qpos, qvel, ctrl.double())


@pytest.mark.parametrize("env_id", ANT_IDS)
def test_ant_scalar_step_graph_replay_equals_eager(cuda, env_id):
    """One env step (the envs' default "scalar" pipeline, frame_skip 2)
    captured in a CUDA graph after an eager warm-up and replayed equals
    the eager step from the same state and action, bit for bit."""
    env = gpt_torch.make(env_id, frame_skip=2, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, st = env.reset_vec(gen, 256)
    act = torch.rand(256, 8, generator=gen, device=cuda) * 2 - 1
    qpos, qvel, warm = (x.clone() for x in (st.qpos, st.qvel, st.warm))
    env.physics(qpos, qvel, warm, act)  # eager warm-up: the buffers, the build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = env.physics(qpos, qvel, warm, act)
    graph.replay()
    torch.cuda.synchronize()
    want = env.physics(qpos, qvel, warm, act)
    for g, w in zip(out, want):
        assert torch.equal(g, w)


# ------------------------- the ant kernels' geometry: a thread per (unit, env)
# in ant_rows, a warp per env in ant_newton, at the envs' batch and ragged
@pytest.mark.parametrize("B", [4096, 4097, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("walls", ["tag", "hh"])
def test_ant_rows_and_newton_equal_twins_at_batch(cuda, walls, dtype, B):
    """ant_rows and ant_newton against their twins on the same inputs at
    B = 4,096 and at batches whose last block is partly empty (4,097: one
    env in it; 100).  f64: the rows densified through the support table,
    aref and r within 1e-9 relative to max(1, |x|), the flags equal; the
    solve after 16 iterations (converged) within 1e-9.  f32: the gates of
    ``chip_smoke.ant_f32_errs`` (rows 2e-3, the solve after 8 iterations
    1e-4; flags may differ only within 1e-5 of a threshold or on the
    capsule-box coincidence slots)."""
    from chip_smoke import ant_f32_errs
    from gym_po_tpu_torch.ops import ant_forward as af

    model, (qpos, qvel, ctrl, warm) = _ant_kernel_inputs(cuda, walls, dtype,
                                                         n=B, seed=3)
    sm = af.ant_smooth(model, qpos, qvel, ctrl)
    rows = af.ant_rows(model, sm.skin, qpos, qvel)
    assert rows.active[8:].sum() > 0
    if dtype == torch.float32:
        got = af.ant_newton(model, sm, rows, warm, iters=8)
        ant_f32_errs(model, cuda, qpos, qvel, ctrl, warm, sm, rows, got)
        return
    rt = af.rows_twin(model, sm.skin, qpos, qvel)
    full = af._contact.constraint_rows(model, af._skin_kinematics(model, sm.skin),
                                       qpos, qvel)
    assert _rel(af.dense_rows(model, rows).jac, full.jac) <= 1e-9
    for name in ("aref", "r"):
        assert _rel(getattr(rows, name), getattr(rt, name)) <= 1e-9, name
    assert torch.equal(rows.active, rt.active)
    got = af.ant_newton(model, sm, rows, warm, iters=16)
    want = af.newton_twin(model, sm, rows, warm, iters=16)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9


@pytest.mark.parametrize("B", [4096, 4097, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("walls", ["tag", "hh"])
def test_ant_smooth_equals_twin_at_batch(cuda, walls, dtype, B):
    """ant_smooth (a warp per env, 8 envs a block at f32, 4 at f64)
    against smooth_twin on the same inputs at B = 4,096 and at batches
    whose last block is partly empty (4,097: one env in it; 100): M,
    qacc_smooth and the kinematics within 1e-9 (f64) and 1e-5 (f32)
    relative to max(1, |x|); M symmetric and exactly zero off
    ``mass_support``."""
    from gym_po_tpu_torch.ops import ant_forward as af

    model, (qpos, qvel, ctrl, _) = _ant_kernel_inputs(cuda, walls, dtype,
                                                      n=B, seed=3)
    sm = af.ant_smooth(model, qpos, qvel, ctrl)
    tw = af.smooth_twin(model, qpos, qvel, ctrl)
    tol = 1e-9 if dtype == torch.float64 else 1e-5
    for name, g, w in zip(af.Smooth._fields, sm, tw):
        assert torch.isfinite(g).all() and _rel(g, w) <= tol, name
    M = af._batch_mass(sm.M)
    assert torch.equal(M, M.mT)
    off = torch.as_tensor(~af.mass_support(model), device=cuda)
    assert (M[:, off] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("walls", ["tag", "hh"])
def test_ant_newton_every_row_active_equals_twin(cuda, walls, dtype):
    """ant_newton on rows whose active flags are all 1, so every env has
    ne active rows (404 on the tag arena, 848 on heaven-hell), past what
    the kernel keeps in shared memory: every pass takes the rows chunk by
    chunk.  Against newton_twin on the same rows: f64 after 16 iterations
    within 1e-9, f32 after 8 within 1e-4, relative to max(1, |x|)."""
    from gym_po_tpu_torch.ops import ant_forward as af

    model, (qpos, qvel, ctrl, warm) = _ant_kernel_inputs(cuda, walls, dtype,
                                                         n=100, seed=5)
    sm = af.ant_smooth(model, qpos, qvel, ctrl)
    rows = af.ant_rows(model, sm.skin, qpos, qvel)
    rows = rows._replace(active=torch.ones_like(rows.active))
    iters, tol = (16, 1e-9) if dtype == torch.float64 else (8, 1e-4)
    got = af.ant_newton(model, sm, rows, warm, iters=iters)
    want = af.newton_twin(model, sm, rows, warm, iters=iters)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel(g, w) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ant_forward_on_every_card(cuda, dtype):
    """The three ant kernels on each visible card in turn, with card 0 the
    current device: ``ant_newton`` opts into its shared memory (66,560 B a
    block on heaven-hell at f32, above the default 48 KB) on each card, and
    each wrapper launches on its tensors' card.  Each card's forward (16
    iterations) equals card 0's bit for bit, and card 0's equals the twins'
    within 1e-9 at f64."""
    from gym_po_tpu_torch.ops import ant_forward as af

    model, arrays = _ant_kernel_inputs(cuda, "hh", dtype, n=100, seed=7)
    assert af.newton_smem_bytes(model, dtype) > 48 * 1024
    first = None
    with torch.cuda.device(0):
        for k in range(torch.cuda.device_count()):
            dev = torch.device("cuda", k)
            q, v, c, w = (x.to(dev) for x in arrays)
            sm = af.ant_smooth(model, q, v, c)
            rows = af.ant_rows(model, sm.skin, q, v)
            got = [g.cpu() for g in af.ant_newton(model, sm, rows, w, iters=16)]
            assert torch.cuda.current_device() == 0
            if first is None:
                first = got
                if dtype == torch.float64:
                    want = af.newton_twin(model, sm, rows, w, iters=16)
                    for g, x in zip(got, want):
                        assert _rel(g, x.cpu()) <= 1e-9
            for g, x in zip(got, first):
                assert torch.isfinite(g).all() and torch.equal(g, x), k


# ------------------------------------------------------------------ spans
def _profiled_replay(multi, ts, spans):
    """One call of ``multi`` (one replay) under torch.profiler, with spans
    on or off: its device ops' names, its span markers apart (name, start,
    duration in ns), and the starts of the host's ``ppo.replay`` spans."""
    from torch.profiler import ProfilerActivity, profile

    from gym_po_tpu_torch.utils.profiling import enable_spans, parse_marker

    def ns(e, what):
        fn = getattr(e, f"{what}_ns", None)
        return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")() * 1000)

    torch.cuda.synchronize()
    enable_spans(spans)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            multi(ts)
            torch.cuda.synchronize()
    finally:
        enable_spans(False)
    ops, marks, replays = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if parse_marker(name) is not None:
                marks.append((name, ns(e, "start"), ns(e, "duration")))
            elif not getattr(e, "is_user_annotation", lambda: False)():
                ops.append(name)
        elif name == "ppo.replay":
            replays.append(ns(e, "start"))
    return ops, marks, replays


@pytest.mark.parametrize("env_id,kw", UPDATE_GRAPH_CASES)
def test_update_graph_spans_on_the_device_timeline(cuda, env_id, kw):
    """An UpdateGraph captured with spans on: two replays equal a graph
    captured with spans off, bit for bit; one traced replay holds one
    ppo.collect around its T env.step spans (on the ant, frame_skip
    ant.forward spans inside each), then one ppo.learn, and besides the
    markers the same device ops as the graph without spans (ant_newton in
    its counting build), which holds no marker; the device's ppo.collect
    begins within a millisecond before and 100 ms after the host's
    ppo.replay (one clock)."""
    from gym_po_tpu_torch.utils.profiling import enable_spans, pair_markers

    ant = env_id.startswith("Ant")
    B, T = (64, 2) if ant else (512, 16)
    ppo, env, cfg, model, ts = _ppo(cuda, env_id, kw, B=B, T=T)
    _, _, _, model_off, ts_off = _ppo(cuda, env_id, kw, B=B, T=T)
    enable_spans(True)
    try:
        multi = ppo.make_multi_train_step(env, model, cfg, 2)
        ts, got = multi(ts)
    finally:
        enable_spans(False)
    multi_off = ppo.make_multi_train_step(env, model_off, cfg, 2)
    ts_off, want = multi_off(ts_off)
    _assert_train_states_equal(ts, ts_off)
    for k in ppo.METRIC_NAMES:
        assert torch.equal(got[k], want[k]), k
    one, one_off = (ppo.make_multi_train_step(env, m, cfg, 1) for m in (model, model_off))
    one.graph, one_off.graph = multi.graph, multi_off.graph
    ops, marks, replays = _profiled_replay(one, ts, True)
    ops_off, marks_off, replays_off = _profiled_replay(one_off, ts_off, False)
    # the graph with spans runs ant_newton's build that counts the active rows
    ops = [o.replace("ant_newton_kernel<float, 8, true>", "ant_newton_kernel<float, 8, false>")
           for o in ops]
    assert marks_off == [] and replays_off == [] and sorted(ops) == sorted(ops_off)
    spans = pair_markers(marks)
    assert {k: len(v) for k, v in spans.items()} == {
        "ppo.collect": 1, "env.step": T, "ppo.learn": 1,
        **({"ant.forward": T * kw["frame_skip"]} if ant else {})}
    (c0, c1), (l0, _) = spans["ppo.collect"][0], spans["ppo.learn"][0]
    assert all(c0 < a and b < c1 for a, b in spans["env.step"]) and c1 < l0
    assert all(any(s0 < a and b < s1 for s0, s1 in spans["env.step"])
               for a, b in spans.get("ant.forward", ()))
    # one clock: the device's collect starts just after the host's replay
    # span opens.  The profiler aligns the device's clock to the host's only
    # to a fraction of a millisecond (one run read the collect 0.18 ms
    # before the replay span), and a clock of its own would put it seconds off.
    assert len(replays) == 1 and -1e6 < c0 - replays[0] < 1e8


@pytest.mark.parametrize("walls", ["tag", "hh"])
def test_ant_active_rows_counter_equals_rows(cuda, walls):
    """With spans on, one forward adds to ant.active_rows the active rows
    of its ant_rows; with spans off it adds nothing."""
    from gym_po_tpu_torch.ops import ant_forward as af
    from gym_po_tpu_torch.utils.profiling import enable_spans, read_counters

    model, (qpos, qvel, ctrl, warm) = _ant_kernel_inputs(cuda, walls, torch.float32)
    want = af.forward(model, qpos, qvel, ctrl, warm, iters=8)
    enable_spans(True)
    try:
        before = read_counters().get("ant.active_rows", 0)
        got = af.forward(model, qpos, qvel, ctrl, warm, iters=8)
        after = read_counters()["ant.active_rows"]
    finally:
        enable_spans(False)
    sm = af.ant_smooth(model, qpos, qvel, ctrl)
    rows = af.ant_rows(model, sm.skin, qpos, qvel)
    assert after - before == int((rows.active != 0).sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    af.forward(model, qpos, qvel, ctrl, warm, iters=8)
    assert read_counters()["ant.active_rows"] == after


# ------------------------------------------- the discrete first layer's backward
EMBED_CASES = {  # rows, observations, width, gradient type, law
    "uniform": (131072, 320, 64, torch.float32, "uniform"),
    "one_observation": (131072, 320, 64, torch.float32, "one"),
    "concentrated": (131072, 320, 64, torch.float32, "concentrated"),
    "past_one_tile": (131072, 1000, 64, torch.float32, "uniform"),
    "h128": (131072, 320, 128, torch.float32, "uniform"),
    "bf16": (131072, 320, 64, torch.bfloat16, "uniform"),
    "bf16_one_observation": (131072, 320, 64, torch.bfloat16, "one"),
    "ragged": (1000, 7, 20, torch.float32, "uniform"),
}
# an entry's error over its sum of absolute values: the kernel's sums are
# chains of at most a few hundred float32 adds (a tree over a set's rows, a
# part's sets, the parts, the slices' partials), each rounding by at most
# 2^-24 of that sum, and the roundings mostly cancel (the largest reading
# at the cell's shape 1.03e-7, about 2^-23); the twin's row order chains up
# to all the rows
EMBED_KERNEL_TOL = 2.0 ** -17
EMBED_TWIN_TOL = 2.0 ** -14


@pytest.mark.parametrize("case", list(EMBED_CASES))
def test_embed_grad_kernel_equals_twin(cuda, case):
    """``embed_grad``'s kernel against its twin (on the CPU, row order) and
    both against the float64 sums: float32 within ``EMBED_KERNEL_TOL`` of
    each entry's sum of absolute values; bfloat16 the float32 sum rounded
    once, so within half a bfloat16 ulp (2^-8 relative) of the exact sum
    besides, and within one ulp of the twin."""
    from gym_po_tpu_torch.ops import probe_embed
    from gym_po_tpu_torch.ops.embed import embed_grad, embed_grad_twin, plan

    rows, n, H, dtype, law = EMBED_CASES[case]
    g, idx = probe_embed.inputs(law, cuda, dtype, seed=7, n=n, H=H, rows=rows)
    if case == "past_one_tile":
        assert plan(g, idx, n)[1] > 1
    gw, gb = embed_grad(g, idx, n)
    torch.cuda.synchronize()
    assert gw.shape == (H, n) and gb.shape == (H,) and gw.dtype == gb.dtype == torch.float32
    assert gw.is_contiguous()
    tw, tb = embed_grad_twin(g.cpu(), idx.cpu(), n)
    ew, eb, aw, ab = probe_embed.exact(g, idx, n)
    for got, twin, want, mag in ((gw, tw, ew, aw), (gb, tb, eb, ab)):
        got, twin = got.cpu().double(), twin.double()
        rounding = 0.0 if dtype == torch.float32 else 2.0 ** -8 * want.abs()
        assert ((got - want).abs() <= EMBED_KERNEL_TOL * mag + rounding).all()
        assert ((twin - want).abs() <= EMBED_TWIN_TOL * mag + rounding).all()
        ulp = 0.0 if dtype == torch.float32 else 2.0 ** -7 * twin.abs()
        assert ((got - twin).abs() <= (EMBED_KERNEL_TOL + EMBED_TWIN_TOL) * mag + ulp).all()


@pytest.mark.parametrize("law", ["uniform", "one"])
def test_embed_grad_calls_equal_bit_for_bit(cuda, law):
    """Two calls on the same inputs give the same gradients bit for bit:
    the kernel's sums have a fixed order (no atomics)."""
    from gym_po_tpu_torch.ops import probe_embed
    from gym_po_tpu_torch.ops.embed import embed_grad

    g, idx = probe_embed.inputs(law, cuda, seed=3)
    a, b = embed_grad(g, idx, 320), embed_grad(g, idx, 320)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_embed_discrete_backward_runs_the_kernel(cuda):
    """The discrete first layer's backward on the card: one ``embed_grad``
    launch, the forward the index expression bit for bit, the gradients
    the twin's on the CPU copy within the kernel test's bound."""
    from torch import nn

    from gym_po_tpu_torch.agents.networks import embed_discrete
    from gym_po_tpu_torch.ops.embed import embed_grad

    gen = torch.Generator(device=cuda).manual_seed(0)
    layer = nn.Linear(320, 64, device=cuda)
    obs = torch.randint(0, 320, (4096,), generator=gen, device=cuda, dtype=torch.int32)
    up = torch.randn(4096, 64, generator=gen, device=cuda)
    before = embed_grad.launches
    y = embed_discrete(layer, obs, torch.float32)
    assert torch.equal(y, layer.weight.t()[obs.long()] + layer.bias)
    y.backward(up)
    assert embed_grad.launches == before + 1
    cpu = nn.Linear(320, 64)
    cpu.load_state_dict(layer.state_dict())
    embed_discrete(cpu, obs.cpu(), torch.float32).backward(up.cpu())
    for p, q in ((layer.weight, cpu.weight), (layer.bias, cpu.bias)):
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-4, rtol=0)
