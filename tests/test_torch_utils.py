"""The port's utilities against the JAX package's, on the CPU: the grid
helpers (``utils/grid.py``, equal outputs), the throughput meter, the
profiler helpers, and the debug checks (``tests/test_debug.py``: a clean
step passes, a NaN state raises; also an index out of range and an integer
division by zero, as checkify's index and division checks)."""

import json

import numpy as np
import pytest
import torch

import gym_po_tpu.utils.grid as jgrid
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu_torch.utils import (
    Timer,
    annotate,
    assert_finite,
    checked,
    grid,
    steps_per_second,
    trace,
)
from gym_po_tpu_torch.utils.debug import CheckError
from gym_po_tpu_torch.vector import rollout


def test_grid_helpers_equal_jax():
    np.testing.assert_array_equal(grid.DIRECTIONS_2D, jgrid.DIRECTIONS_2D)
    np.testing.assert_array_equal(grid.DIRECTIONS_3D, jgrid.DIRECTIONS_3D)
    c2 = np.array([[2, 2], [4, 4], [8, 8]]).T
    c3 = np.array([[0, 2, 2], [1, 4, 4]]).T
    for c in (c2, c3, np.array([5, 7])):
        for surround in (0, 1, 2):
            np.testing.assert_array_equal(grid.surrounding_indices(c, surround),
                                          jgrid.surrounding_indices(c, surround))
        np.testing.assert_array_equal(grid.hansen_indices(c),
                                      jgrid.hansen_indices(c))
    shape = (3, 7, 5)
    flats = np.arange(3 * 7 * 5)
    coords = grid.flat_to_coord(shape)(flats)
    np.testing.assert_array_equal(coords, jgrid.flat_to_coord(shape)(flats))
    np.testing.assert_array_equal(grid.coord_to_flat(shape)(coords), flats)
    np.testing.assert_array_equal(grid.coord_to_flat(shape)(coords + 7),
                                  jgrid.coord_to_flat(shape)(coords + 7))


def test_steps_per_second_meter_and_timer():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)
    calls = []

    def run():
        calls.append(1)
        return rollout(env, gen, None, 32, 16)[0].reward.sum()

    sps = steps_per_second(run, steps_per_call=32 * 16, iters=2)
    assert sps > 0 and len(calls) == 3  # one warm-up, two timed
    t = Timer()
    with t:
        run()
    first = t.elapsed
    with t:
        run()
    assert 0 < first < t.elapsed


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    env = gpt_torch.make("Taxi-v4", device="cpu")
    with trace(str(tmp_path)):
        with annotate("taxi-rollout"):
            rollout(env, torch.Generator().manual_seed(0), None, 8, 4)
    path = tmp_path / "trace.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "taxi-rollout" in names


def test_checked_step_passes_clean():
    env = gpt_torch.make("CarFlag-v0", time_limit=20, device="cpu")
    gen = torch.Generator().manual_seed(0)
    obs, st = env.reset_vec(gen, 8)
    obs, st, r, d, tr, _ = checked(env.step_vec)(gen, st, torch.zeros(8, 1))
    assert_finite((obs, r), "step outputs")
    for env_id in ("Taxi-v4", "Rooms-v0", "CRooms-v0", "MultistoryFourRooms-v0",
                   "RockSample-v0", "TagContinuous-v0", "HeavenHellContinuous-v0"):
        env = gpt_torch.make(env_id, device="cpu")
        _, st = env.reset_vec(gen, 8)
        checked(env.step_vec)(gen, st, env.action_space.sample_vec(gen, 8))


def test_checked_step_catches_nan():
    env = gpt_torch.make("CarFlag-v0", time_limit=20, device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, st = env.reset_vec(gen, 8)
    pos = st.pos.clone()
    pos[0] = float("nan")
    with pytest.raises(CheckError, match="nan"):
        checked(env.step_vec)(gen, st.replace(pos=pos), torch.zeros(8, 1))


def test_checked_catches_out_of_range_indices_and_integer_division_by_zero():
    x = torch.arange(4)
    for fn, args in ((lambda x, i: x[i], (x, torch.tensor([4]))),
                     (lambda x, i: x[i], (x, torch.tensor([-5]))),
                     (lambda x, i: x.gather(0, i), (x, torch.tensor([9]))),
                     (lambda x, i: torch.zeros(4).index_add_(0, i, torch.ones(1)),
                      (x, torch.tensor([4])))):
        with pytest.raises(CheckError, match="out of range"):
            checked(fn)(*args)
        assert torch.equal(x, torch.arange(4))
    assert int(checked(lambda x, i: x[i])(x, torch.tensor([-4]))) == 0
    for fn in (lambda a, b: a // b, lambda a, b: a % b):
        with pytest.raises(CheckError, match="division by zero"):
            checked(fn)(torch.tensor([3]), torch.tensor([0]))
    # a float division by zero is IEEE (inf), as checkify's div check allows
    assert torch.isinf(checked(lambda a, b: a / b)(torch.tensor([1.0]),
                                                  torch.tensor([0.0]))).all()


def test_assert_finite_raises():
    with pytest.raises(FloatingPointError):
        assert_finite({"x": np.array([1.0, np.inf])})
    assert_finite({"x": np.array([1.0, 2.0]), "i": np.array([1, 2])})
