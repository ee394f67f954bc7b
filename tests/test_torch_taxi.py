"""Taxi in the PyTorch port against the JAX package, on identical inputs.

Tables must be equal array for array; the deterministic stages must give
exactly equal ints, bools and f32 rewards on the same numpy states, actions
and draws.  Perf-mode sampling (the port's own ``torch.Generator`` stream)
is held only by its distributions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs.taxi import TaxiState as JTaxiState
from gym_po_tpu.maps import taxi_maps as jmaps
from gym_po_tpu_torch.envs.taxi import TaxiState as TTaxiState
from gym_po_tpu_torch.maps import taxi_maps as tmaps

CASES = [
    ("Taxi-v4", {}),
    ("HansenTaxi-v4", {}),
    ("ExtendedTaxi-v4", {}),
    ("ExtendedHansenTaxi-v4", {}),
    ("HansenTaxi-v4", {"num_passengers": 3}),
]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(), err_msg=what)


def _random_states(env, rng, B):
    """Valid encoded states with random completed counts and elapsed times
    around the time limit, so goal, pickup, done and truncation all occur:
    half the taxis sit on their destination's or passenger's landmark."""
    t = env.tables
    s = rng.choice(t.valid_init, B).astype(np.int64)
    r, c, p, d = tmaps.decode_state_np(s, t.cols, t.nlocs)
    in_taxi = rng.random(B) < 0.5
    at_landmark = rng.random(B) < 0.5
    lm = t.np_locs[np.where(in_taxi, d, p)]
    r = np.where(at_landmark, lm[:, 0], r)
    c = np.where(at_landmark, lm[:, 1], c)
    p = np.where(in_taxi, t.nlocs, p)
    s = tmaps.encode_state_np(r, c, p, d, t.cols, t.nlocs).astype(np.int32)
    completed = rng.integers(0, env.num_passengers, B).astype(np.int32)
    elapsed = rng.integers(env.time_limit - 3, env.time_limit + 1, B).astype(np.int32)
    return s, completed, elapsed


@pytest.mark.parametrize("map_rows", ["TAXI_MAP", "EXTENDED_TAXI_MAP"])
def test_compiled_tables_equal(map_rows):
    jt = jmaps.compile_taxi_map(getattr(jmaps, map_rows))
    tt = tmaps.compile_taxi_map(getattr(tmaps, map_rows))
    assert getattr(jmaps, map_rows) == getattr(tmaps, map_rows)
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("env_id,kw", CASES)
def test_derived_tables_equal(env_id, kw):
    je, te = gpt.make(env_id, **kw), gpt_torch.make(env_id, **kw, device="cpu")
    for name in ("_cell_move", "_loc_at", "_hansen_cell", "_valid_init"):
        _eq(getattr(je, name), getattr(te, name), name)
        assert getattr(te, name).dtype == torch.int32
    assert je._all_cells_valid == te._all_cells_valid
    assert je._pd == te._pd
    assert je.observation_space.n == te.observation_space.n
    assert je.action_space.n == te.action_space.n


@pytest.mark.parametrize("env_id,kw", CASES)
def test_stages_exactly_equal(env_id, kw):
    je, te = gpt.make(env_id, **kw), gpt_torch.make(env_id, **kw, device="cpu")
    rng = np.random.default_rng(0)
    B = 4096
    s, completed, elapsed = _random_states(je, rng, B)
    a = rng.integers(0, 5, B).astype(np.int32)
    jst = JTaxiState(elapsed=jnp.asarray(elapsed), s=jnp.asarray(s),
                     completed=jnp.asarray(completed))
    tst = TTaxiState(elapsed=_t(elapsed), s=_t(s), completed=_t(completed))

    jmid, jrew, jdone, jtrunc, jtask = jax.jit(je.advance)(jst, jnp.asarray(a))
    tmid, trew, tdone, ttrunc, ttask = te.advance(tst, _t(a))
    for f in ("s", "completed", "elapsed"):
        _eq(getattr(jmid, f), getattr(tmid, f), f)
        assert getattr(tmid, f).dtype == torch.int32
    assert trew.dtype == torch.float32
    for name, j, t in (("rew", jrew, trew), ("done", jdone, tdone),
                       ("trunc", jtrunc, ttrunc), ("task", jtask, ttask)):
        _eq(j, t, name)
    # every branch was exercised
    rew = np.asarray(jrew)
    assert (rew == 1.0).any() and (rew == -0.5).any() and (rew == -0.05).any()
    assert np.asarray(jdone).any() and np.asarray(jtrunc).any()
    assert np.asarray(jtask).any() == (je.num_passengers > 1)

    mask = rng.random(B) < 0.5
    p_new = rng.integers(0, je.nlocs, B).astype(np.int32)
    d0 = rng.integers(0, je.nlocs - 1, B).astype(np.int32)
    d_new = d0 + (d0 >= p_new)
    jtr = je.apply_task_reset(jmid, jnp.asarray(mask), jnp.asarray(p_new),
                              jnp.asarray(d_new))
    ttr = te.apply_task_reset(tmid, _t(mask), _t(p_new), _t(d_new))
    _eq(jtr.s, ttr.s, "task reset")

    s_new = rng.choice(je.tables.valid_init, B).astype(np.int32)
    jfr = je.apply_full_reset(jtr, jnp.asarray(~mask), jnp.asarray(s_new))
    tfr = te.apply_full_reset(ttr, _t(~mask), _t(s_new))
    for f in ("s", "completed", "elapsed"):
        _eq(getattr(jfr, f), getattr(tfr, f), f)
    _eq(je.observe(jfr), te.observe(tfr), "observe")
    _eq(je.observe(jst), te.observe_vec(tst), "observe_vec")


def test_stage_composed_trajectory_extended_hansen():
    """300 steps of advance -> task reset -> full reset -> observe with the
    same numpy actions and draws: obs, reward, done and trunc equal."""
    env_id, B, T = "ExtendedHansenTaxi-v4", 256, 300
    je, te = gpt.make(env_id), gpt_torch.make(env_id, device="cpu")
    nlocs, valid = je.nlocs, je.tables.valid_init
    rng = np.random.default_rng(1)

    def compose(env, state, a, p, d0, s_new):
        mid, rew, done, trunc, task = env.advance(state, a)
        mid = env.apply_task_reset(mid, task, p, d0 + (d0 >= p))
        nxt = env.apply_full_reset(mid, done | trunc, s_new)
        return env.observe(nxt), nxt, rew, done, trunc

    jcompose = jax.jit(lambda *args: compose(je, *args))
    s0 = rng.choice(valid, B).astype(np.int32)
    z = np.zeros(B, np.int32)
    jst = JTaxiState(elapsed=jnp.asarray(z), s=jnp.asarray(s0), completed=jnp.asarray(z))
    tst = TTaxiState(elapsed=_t(z), s=_t(s0), completed=_t(z))
    n_done = 0
    for _ in range(T):
        a = rng.integers(0, 5, B).astype(np.int32)
        p = rng.integers(0, nlocs, B).astype(np.int32)
        d0 = rng.integers(0, nlocs - 1, B).astype(np.int32)
        s_new = rng.choice(valid, B).astype(np.int32)
        jo, jst, jr, jd, jt = jcompose(jst, *map(jnp.asarray, (a, p, d0, s_new)))
        to, tst, tr, td, tt = compose(te, tst, *map(_t, (a, p, d0, s_new)))
        for name, j, t in (("obs", jo, to), ("rew", jr, tr), ("done", jd, td),
                           ("trunc", jt, tt), ("s", jst.s, tst.s)):
            _eq(j, t, name)
        n_done += int(np.asarray(jd).sum())
    assert n_done > 0  # random play finishes some episodes in 300 steps


def test_perf_mode_task_draws_uniform_over_d_ne_p():
    env = gpt_torch.make("ExtendedTaxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)
    N = 240_000
    p, d = env.sample_passenger_destination(gen, (N,))
    assert p.dtype == d.dtype == torch.int32
    assert (p != d).all()
    k = env.nlocs
    freq = torch.bincount((p * k + d).long(), minlength=k * k).double() / N
    off_diag = ~torch.eye(k, dtype=torch.bool).reshape(-1)
    np.testing.assert_allclose(freq[off_diag].numpy(), 1 / (k * (k - 1)), atol=0.005)


@pytest.mark.parametrize("env_id", ["Taxi-v4", "ExtendedHansenTaxi-v4"])
def test_perf_mode_init_uniform_over_valid_states(env_id):
    env = gpt_torch.make(env_id, device="cpu")
    t = env.tables
    gen = torch.Generator().manual_seed(1)
    N = 200_000
    obs, st = env.reset_vec(gen, N)
    s = st.s.numpy().astype(np.int64)
    assert np.isin(s, t.valid_init).all()
    assert (st.elapsed == 0).all() and (st.completed == 0).all()
    r, c, _, _ = tmaps.decode_state_np(s, t.cols, t.nlocs)
    cells = np.bincount(r * t.cols + c, minlength=t.rows * t.cols) / N
    n_valid = int((t.tgrid != "|").sum())
    valid = (t.tgrid != "|").reshape(-1)
    np.testing.assert_allclose(cells[valid], 1 / n_valid, atol=0.003)
    assert (cells[~valid] == 0).all()
    _eq(env.observe(st), obs)
    # the single-instance path samples the same distribution
    one = torch.stack([env.reset(gen)[1].s for _ in range(2000)])
    assert np.isin(one.numpy(), t.valid_init).all()


def test_perf_mode_step_vec_keeps_states_valid():
    env = gpt_torch.make("HansenTaxi-v4", time_limit=20, device="cpu")
    gen = torch.Generator().manual_seed(2)
    obs, st = env.reset_vec(gen, 512)
    t = env.tables
    finished = 0
    valid_cell = (t.tgrid != "|").reshape(-1)
    for _ in range(100):
        a = env.action_space.sample_vec(gen, 512)
        obs, st, rew, done, trunc, info = env.step_vec(gen, st, a)
        r, c, p, d = tmaps.decode_state_np(st.s.numpy().astype(np.int64),
                                           t.cols, t.nlocs)
        assert valid_cell[r * t.cols + c].all()
        assert not ((p < t.nlocs) & (p == d)).any()  # waiting passenger has d != p
        finished += int((done | trunc).sum())
        assert (obs >= 0).all() and (obs < env.observation_space.n).all()
        assert (st.elapsed[done | trunc] == 0).all()
    assert finished >= 512 * 4  # time_limit=20 truncates every env at least 4x


def test_environment_base_class_batched_defaults():
    """The protocol's generic reset_vec / step_vec / observe_vec (a loop
    over instances) agree with Taxi's batched versions where no draw is
    used: move-only actions, far from the time limit."""
    from gym_po_tpu_torch.core import Environment

    env = gpt_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(4)
    obs, st = Environment.reset_vec(env, gen, 16)
    assert obs.shape == (16,) and st.s.shape == (16,)
    assert np.isin(st.s.numpy(), env.tables.valid_init).all()
    a = torch.arange(16, dtype=torch.int32) % 4
    base = Environment.step_vec(env, gen, st, a)
    fast = env.step_vec(gen, st, a)
    for x, y in zip(base[:5], fast[:5]):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    for f in ("s", "elapsed", "completed"):
        assert torch.equal(getattr(base[1], f), getattr(fast[1], f))
    assert torch.equal(base[5]["terminal_state"].s, fast[5]["terminal_state"].s)
    assert torch.equal(Environment.observe_vec(env, base[1]), env.observe(fast[1]))
