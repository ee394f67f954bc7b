"""CarFlag-v0 and DiscreteCarFlag-v0 in the PyTorch port against the JAX
package (``gym_po_tpu.envs.car_flag``).

Every stage must equal the JAX stage exactly on identical inputs:

* perf mode (float32 throughout): the port's ``advance``, ``apply_reset``
  and ``observe`` on the draws that the JAX ``step_vec`` takes from its key
  reproduce that ``step_vec``: observations, states, rewards, dones,
  truncations and the pre-reset state;
* f64 parity mode (``parity=True`` here, the JAX side under the ``x64``
  fixture): float64 priests and discrete forces, driven as the JAX
  package's parity driver drives them (numpy reset draws, float64).

The port's own ``step_vec`` is held to its stages by replaying its
generator, and to the JAX package's perf-mode invariants.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.envs import car_flag as jcar
from gym_po_tpu_torch.envs import car_flag as tcar
from gym_po_tpu_torch.envs.car_flag import CarFlagState as TState


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(j, t, what=""):
    t = t.cpu().numpy()
    j = np.asarray(j)
    assert j.dtype == t.dtype or (j.dtype == np.int32 and t.dtype == np.int32), (
        what, j.dtype, t.dtype)
    np.testing.assert_array_equal(j, t, err_msg=what)


def _port_state(js) -> TState:
    return TState(elapsed=_t(js.elapsed), pos=_t(js.pos), vel=_t(js.vel),
                  dirn=_t(js.dirn), heaven=_t(js.heaven), priest=_t(js.priest))


def _states_eq(js, ts, what):
    for f in ("elapsed", "pos", "vel", "dirn", "heaven", "priest"):
        _eq(getattr(js, f), getattr(ts, f), f"{what}.{f}")


def _envs(env_id, **kw):
    return (gpt.make(env_id, **kw),
            gpt_torch.make(env_id, device="cpu", **kw))


def test_constants_and_spaces_equal_jax():
    for name in ("MAX_POS", "MIN_POS", "MAX_SPEED", "MIN_ACT", "MAX_ACT", "PRIEST",
                 "PRIEST_THRESHOLD", "POWER"):
        assert getattr(tcar, name) == getattr(jcar, name), name
    for env_id, kw in (("CarFlag-v0", {}), ("DiscreteCarFlag-v0", {"num_actions": 5})):
        je, te = _envs(env_id, time_limit=33, **kw)
        assert te.name == je.name and te.time_limit == 33
        np.testing.assert_array_equal(te.observation_space.low_arr,
                                      je.observation_space.low_arr)
        np.testing.assert_array_equal(te.observation_space.high_arr,
                                      je.observation_space.high_arr)
    np.testing.assert_array_equal(te.forces_np, je.forces_np)
    assert te.action_space.n == je.action_space.n == 5
    for cls in (tcar.CarFlag, tcar.DiscreteCarFlag):
        assert inspect.signature(cls).parameters["device"].default == "cuda"


def _edge_state(je, B, seed):
    """JAX reset_vec states moved to the edges: the left wall at rest and
    moving left, near both terminals, inside and on the priest windows."""
    _, js = je.reset_vec(jax.random.PRNGKey(seed), B)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.1, 1.1, B).astype(np.float32)
    vel = rng.uniform(-0.07, 0.07, B).astype(np.float32)
    pos[:8] = np.float32(-1.1)
    vel[:4] = np.float32(-0.07)
    pos[8:16] = np.float32(0.95)
    pos[16:24] = np.float32(0.3)  # the window edge of priest 0.5
    pos[24:32] = np.float32(-0.7)
    return js.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                      elapsed=jnp.asarray(rng.integers(0, 12, B).astype(np.int32)))


@pytest.mark.parametrize("env_id,kw", [("CarFlag-v0", {}),
                                       ("DiscreteCarFlag-v0", {"num_actions": 5})])
def test_stages_reproduce_jax_step_vec(env_id, kw):
    je, te = _envs(env_id, time_limit=12, **kw)
    B = 512
    js = _edge_state(je, B, 3)
    ts = _port_state(js)
    _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), "obs")
    key = jax.random.PRNGKey(5)
    n_done = n_trunc = 0
    for t in range(30):
        key, ka, ks = jax.random.split(key, 3)
        if env_id == "CarFlag-v0":
            a = jax.random.uniform(ka, (B, 1), jnp.float32, -1.3, 1.3)
        else:
            a = jax.random.randint(ka, (B,), 0, kw["num_actions"])
        jobs, js2, jrew, jdone, jtrunc, jinfo = je.step_vec(ks, js, a)
        pos, heaven, priest = je._sample_reset_vec(ks, B)  # step_vec's draws
        force = te._force(_t(a))
        _eq(jax.vmap(je._force)(a), force, "force")
        mid, rew, done, trunc = te.advance(ts, force)
        ts2 = te.apply_reset(mid, done | trunc, _t(pos), _t(heaven), _t(priest))
        _states_eq(jinfo["terminal_state"], mid, f"mid t={t}")
        _states_eq(js2, ts2, f"state t={t}")
        _eq(jobs, te.observe_vec(ts2), f"obs t={t}")
        _eq(jrew, rew, f"rew t={t}")
        _eq(jdone, done, f"done t={t}")
        _eq(jtrunc, trunc, f"trunc t={t}")
        n_done += int(done.sum())
        n_trunc += int(trunc.sum())
        js, ts = js2, ts2
    assert n_done > 0 and n_trunc > 0


@pytest.mark.usefixtures("x64")
@pytest.mark.parametrize("env_id,kw", [("CarFlag-v0", {}),
                                       ("DiscreteCarFlag-v0", {"num_actions": 5})])
def test_parity_mode_stages_match_jax_x64(env_id, kw):
    """float64 priests and, for the discrete env, float64 forces: the
    window test and the physics promote as NumPy's do.  Driven as the JAX
    parity driver drives the stages (numpy reset draws, one per reset)."""
    je = gpt.make(env_id, time_limit=60, **kw)
    te = gpt_torch.make(env_id, time_limit=60, parity=True, device="cpu", **kw)
    B = 64
    rng = np.random.default_rng(11)

    def draws(b):
        return (rng.uniform(-0.2, 0.2, b), rng.choice([-1.0, 1.0], b),
                rng.choice([-0.5, 0.5], b))

    pos, heaven, priest = draws(B)
    js = jcar.CarFlagState(elapsed=jnp.zeros(B, jnp.int32),
                           pos=jnp.asarray(pos, jnp.float32),
                           vel=jnp.zeros(B, jnp.float32),
                           dirn=jnp.zeros(B, jnp.float32),
                           heaven=jnp.asarray(heaven, jnp.float32),
                           priest=jnp.asarray(priest, jnp.float64))
    ts = _port_state(js)
    assert ts.priest.dtype == torch.float64
    advance = jax.jit(je.advance)
    apply_reset = jax.jit(je.apply_reset)
    seen = dict(done=0, trunc=0, window=0)
    push = rng.choice([-1, 1], B)  # most envs drive on to an end
    push[:16] = 0
    for t in range(140):
        if env_id == "CarFlag-v0":
            a = np.clip(0.9 * push + rng.uniform(-0.5, 0.5, B), -1.2, 1.2)
            a = a.astype(np.float32)[:, None]
        else:
            a = np.where(rng.random(B) < 0.8, 2 + 2 * push,
                         rng.integers(0, kw["num_actions"], B))
        jforce = jax.vmap(je._force)(jnp.asarray(a))
        force = te._force(_t(a))
        _eq(jforce, force, "force")
        assert force.dtype == (torch.float32 if env_id == "CarFlag-v0"
                               else torch.float64)
        jmid, jrew, jdone, jtrunc = advance(js, jforce)
        mid, rew, done, trunc = te.advance(ts, force)
        _states_eq(jmid, mid, f"mid t={t}")
        for j, p, w in ((jrew, rew, "rew"), (jdone, done, "done"),
                        (jtrunc, trunc, "trunc")):
            _eq(j, p, f"{w} t={t}")
        mask = np.asarray(jdone) | np.asarray(jtrunc)
        new = [np.zeros(B, np.float64) for _ in range(3)]
        if mask.any():
            for col, d in zip(new, draws(int(mask.sum()))):
                col[mask] = d
        js = apply_reset(jmid, jnp.asarray(mask), *map(jnp.asarray, new))
        ts = te.apply_reset(mid, _t(mask), *map(_t, new))
        _states_eq(js, ts, f"state t={t}")
        _eq(jax.vmap(je.observe)(js), te.observe_vec(ts), f"obs t={t}")
        seen["done"] += int(np.asarray(jdone).sum())
        seen["trunc"] += int(np.asarray(jtrunc).sum())
        seen["window"] += int((np.asarray(jmid.dirn) != 0).sum())
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("env_id", ["CarFlag-v0", "DiscreteCarFlag-v0"])
def test_step_vec_replays_its_stages(env_id, parity):
    te = gpt_torch.make(env_id, time_limit=9, parity=parity, device="cpu")
    B = 256
    gen = torch.Generator().manual_seed(2)
    obs, st = te.reset_vec(gen, B)
    assert st.priest.dtype == (torch.float64 if parity else torch.float32)
    assert obs.shape == (B, 3) and obs.dtype == torch.float32
    agen = torch.Generator().manual_seed(9)
    for t in range(20):
        if env_id == "CarFlag-v0":
            a = torch.rand((B, 1), generator=agen) * 2.6 - 1.3
        else:
            a = torch.randint(0, 3, (B,), generator=agen)
        replay = torch.Generator().manual_seed(100 + t)
        draws = te._sample_reset_vec(replay, B)
        mid, rew, done, trunc = te.advance(st, te._force(a))
        want = te.apply_reset(mid, done | trunc, *draws)
        obs, st2, rew2, done2, trunc2, info = te.step_vec(
            torch.Generator().manual_seed(100 + t), st, a)
        for f in ("elapsed", "pos", "vel", "dirn", "heaven", "priest"):
            assert torch.equal(getattr(want, f), getattr(st2, f)), f
            assert torch.equal(getattr(mid, f), getattr(info["terminal_state"], f))
        assert torch.equal(obs, te.observe_vec(want))
        assert torch.equal(rew, rew2) and torch.equal(done, done2)
        assert torch.equal(info["reset_mask"], done | trunc)
        st = st2


def test_perf_mode_invariants():
    """tests/test_car_flag.py's perf-mode invariants on the port's step."""
    te = gpt_torch.make("CarFlag-v0", time_limit=40, device="cpu")
    B = 16
    gen = torch.Generator().manual_seed(0)
    obs, state = te.reset_vec(gen, B)
    saw_done = False
    for _ in range(90):
        a = torch.rand((B, 1), generator=gen) * 2 - 1
        obs, state, r, d, tr, info = te.step_vec(gen, state, a)
        saw_done |= bool((d | tr).any())
    o = obs.numpy()
    assert (np.abs(o[:, 0]) <= 1.1).all()
    assert (np.abs(o[:, 1]) <= 0.07).all()
    assert np.isin(o[:, 2], [-1.0, 0.0, 1.0]).all()
    assert saw_done
    assert np.isin(state.heaven.numpy(), [-1.0, 1.0]).all()
    assert np.isin(state.priest.numpy(), [-0.5, 0.5]).all()
    assert (np.abs(state.pos.numpy()[state.elapsed.numpy() == 0]) <= 0.2).all()


def test_single_instance_protocol():
    te = gpt_torch.make("DiscreteCarFlag-v0", device="cpu")
    gen = torch.Generator().manual_seed(1)
    obs, st = te.reset(gen)
    assert obs.shape == (3,) and st.pos.shape == ()
    obs, st, r, d, tr, info = te.step(gen, st, torch.tensor(2))
    assert obs.shape == (3,) and r.shape == () and info["reset_mask"].shape == ()
    pos, heaven, priest = te.sample_reset(gen)
    assert abs(float(pos)) <= 0.2 and float(heaven) in (-1.0, 1.0)
    assert float(priest) in (-0.5, 0.5)
