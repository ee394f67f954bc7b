"""The port's gymnasium vector API (``gym_po_tpu_torch.compat``) against the
JAX package's (``tests/test_compat_api.py``), on the CPU.

The same surface and quirks: class names, constructor signatures, the
bare-obs reset of Rooms and CRooms, ``CRoomsEnv.seed()``, ``info_mode``,
NumPy out; the gymnasium spaces equal the JAX package's ``to_gymnasium()``.
Each package steps its own randomness, so the trajectories are held to the
spaces, not to each other.
"""

import gymnasium
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu import compat as jcompat
from gym_po_tpu_torch.compat import (
    CarVecEnv,
    CRoomsEnv,
    DiscreteActionCarVecEnv,
    ExtendedHansenTaxiVecEnv,
    ExtendedTaxiVecEnv,
    GymnasiumVecAdapter,
    HansenTaxiVecEnv,
    MultistoryFourRoomsEnv,
    RoomsEnv,
    TaxiVecEnv,
)
from gym_po_tpu_torch.vector import RecordEpisodeStatistics

CPU = dict(device="cpu")


@pytest.mark.parametrize("env_id", [
    "Taxi-v4", "HansenTaxi-v4", "ExtendedHansenTaxi-v4", "Rooms-v0",
    "CRooms-v0", "MultistoryFourRooms-v0", "RockSample-v0", "TagContinuous-v0",
    "HeavenHellContinuous-v0", "CarFlag-v0", "DiscreteCarFlag-v0"])
def test_spaces_equal_jax_to_gymnasium(env_id):
    je, te = gpt.make(env_id), gpt_torch.make(env_id, **CPU)
    for attr in ("observation_space", "action_space"):
        want = getattr(je, attr).to_gymnasium()
        got = getattr(te, attr).to_gymnasium()
        assert type(got) is type(want) and got == want, (attr, got, want)
        if isinstance(want, gymnasium.spaces.Box):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.low, want.low)
            np.testing.assert_array_equal(got.high, want.high)


def test_adapter_surface_equals_jax():
    names = [n for n in jcompat.gym_api.__all__]
    from gym_po_tpu_torch.compat import gym_api

    assert gym_api.__all__ == names
    for ours, theirs in ((TaxiVecEnv(num_envs=4, **CPU), jcompat.TaxiVecEnv(num_envs=4)),
                         (RoomsEnv(4, layout="4", **CPU), jcompat.RoomsEnv(4, layout="4")),
                         (CarVecEnv(4, **CPU), jcompat.CarVecEnv(4))):
        assert isinstance(ours, gymnasium.Env)
        assert ours.single_observation_space == theirs.single_observation_space
        assert ours.single_action_space == theirs.single_action_space
        assert ours.observation_space == theirs.observation_space
        assert ours.action_space == theirs.action_space
    assert TaxiVecEnv.ACTION_DICT == jcompat.TaxiVecEnv.ACTION_DICT
    d = DiscreteActionCarVecEnv(5, 4, **CPU)
    assert d.action_names == jcompat.DiscreteActionCarVecEnv(5, 4).action_names


def test_taxi_adapter_matches_reference_surface():
    env = TaxiVecEnv(num_envs=8, hansen_obs=True, **CPU)
    assert env.is_vector_env and env.num_envs == 8
    obs, info = env.reset(seed=0)
    assert obs.shape == (8,) and isinstance(info, dict)
    assert env.single_action_space.n == 5
    assert env.observation_space.shape == (8,)
    for _ in range(5):
        a = np.random.default_rng(0).integers(0, 5, 8)
        obs, rew, done, trunc, info = env.step(a)
    assert obs.shape == rew.shape == done.shape == trunc.shape == (8,)
    assert all(isinstance(x, np.ndarray) for x in (obs, rew, done, trunc))
    assert env.single_observation_space.contains(int(obs[0]))


def test_reset_seed_fixes_the_run():
    env = TaxiVecEnv(num_envs=8, **CPU)
    runs = []
    for _ in range(2):
        out = [env.reset(seed=3)[0]]
        for _ in range(4):
            out.append(env.step(np.arange(8) % 5)[0])
        runs.append(np.stack(out))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_rooms_adapter_bare_reset_quirk():
    env = RoomsEnv(4, layout="4", obs_type="mdp", **CPU)
    out = env.reset(seed=1)
    assert isinstance(out, np.ndarray) and out.shape == (4,)
    obs, rew, done, trunc, _ = env.step(np.zeros(4, np.int64))
    assert rew.shape == (4,)


def test_crooms_adapter_seed_method():
    env = CRoomsEnv(4, layout="4", obs_type="vector_mdp", **CPU)
    env.seed(3)
    obs = env.reset()
    assert obs.shape == (4, 2)
    env.seed(3)
    np.testing.assert_array_equal(env.reset(), obs)
    obs, *_ = env.step(np.zeros((4, 2), np.float32))
    assert obs.shape == (4, 2)


def test_msrooms_adapter():
    env = MultistoryFourRoomsEnv(4, grid_z=2, obs_type="hansen", **CPU)
    obs, info = env.reset(seed=0)
    assert obs.shape == (4,)
    obs, *_ = env.step(np.zeros(4, np.int64))


def test_car_adapters():
    env = CarVecEnv(4, time_limit=30, **CPU)
    obs, _ = env.reset(seed=0)
    assert obs.shape == (4, 3)
    obs, rew, done, trunc, _ = env.step(np.zeros((4, 1), np.float32))
    denv = DiscreteActionCarVecEnv(5, 4, time_limit=30, **CPU)
    obs, _ = denv.reset(seed=0)
    obs, *_ = denv.step(np.array([0, 1, 2, 3]))
    assert obs.shape == (4, 3)


def test_taxi_partials():
    for ctor, name in ((HansenTaxiVecEnv, "HansenTaxi-v4"),
                       (ExtendedTaxiVecEnv, "Taxi-v4"),
                       (ExtendedHansenTaxiVecEnv, "HansenTaxi-v4")):
        env = ctor(num_envs=2, **CPU)
        obs, _ = env.reset(seed=0)
        assert obs.shape == (2,) and env.env.name == name
    assert ExtendedTaxiVecEnv(num_envs=1, **CPU).env.tables.rows == 8


def test_adapters_default_to_the_card():
    import inspect

    for cls in (TaxiVecEnv, RoomsEnv, CRoomsEnv, MultistoryFourRoomsEnv,
                CarVecEnv, DiscreteActionCarVecEnv):
        assert inspect.signature(cls).parameters["device"].default == "cuda"


@pytest.mark.parametrize("ctor,kw", [
    (TaxiVecEnv, {"num_envs": 3}),
    (RoomsEnv, {"num_envs": 3, "layout": "4"}),
    (CRoomsEnv, {"num_envs": 3, "layout": "4"}),
    (MultistoryFourRoomsEnv, {"num_envs": 3, "grid_z": 2}),
    (CarVecEnv, {"num_envs": 3}),
])
def test_render_rgb(ctor, kw):
    env = ctor(**kw, **CPU)
    env.reset(seed=0)
    img = env.render(idx=range(kw["num_envs"]))
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    assert img.shape[0] > 8 and img.shape[1] > 8
    assert img.max() > 0


def test_info_mode_reference_returns_empty_dict():
    env = TaxiVecEnv(num_envs=4, **CPU)
    env.reset(seed=0)
    *_, info = env.step(np.zeros(4, int))
    assert info == {}


def test_info_mode_full_exposes_terminal_state():
    env = TaxiVecEnv(num_envs=4, info_mode="full", **CPU)
    env.reset(seed=0)
    obs, rew, done, trunc, info = env.step(np.zeros(4, int))
    assert "terminal_state" in info
    # leaves converted to NumPy; the pre-reset successor's obs equals the
    # next obs wherever no episode ended
    term = info["terminal_state"]
    assert isinstance(term.s, np.ndarray)
    term_obs = env.env.observe_vec(term.replace(s=torch.as_tensor(term.s))).numpy()
    boundary = done | trunc
    np.testing.assert_array_equal(term_obs[~boundary], obs[~boundary])


def test_info_mode_full_with_episode_stats_wrapper():
    from gym_po_tpu_torch.envs.taxi import Taxi

    env = GymnasiumVecAdapter(RecordEpisodeStatistics(Taxi(time_limit=5, **CPU)),
                              8, info_mode="full")
    env.reset(seed=0)
    rng = np.random.default_rng(0)
    seen_done = False
    for _ in range(12):
        *_, info = env.step(rng.integers(0, 5, 8))
        assert {"episode_return", "episode_length", "episode_done"} <= set(info)
        if info["episode_done"].any():
            seen_done = True
            fin = info["episode_done"]
            assert (info["episode_length"][fin] >= 1).all()
    assert seen_done


def test_info_mode_rejects_unknown():
    with pytest.raises(ValueError, match="info_mode"):
        TaxiVecEnv(num_envs=2, info_mode="bogus", **CPU)
