"""The port's utilities against the JAX package's, on the CPU: the grid
helpers (``utils/grid.py``, equal outputs), the timer, the profiler
helpers and the span markers' naming contract, and the debug checks
(``tests/test_debug.py``: a clean step passes, a NaN state raises; also an
index out of range and an integer division by zero, as checkify's index
and division checks)."""

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
    profiling,
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


def test_timer_accumulates():
    env = gpt_torch.make("Taxi-v4", device="cpu")
    gen = torch.Generator().manual_seed(0)

    def run():
        return rollout(env, gen, None, 32, 16)[0].reward.sum()

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


def test_annotate_with_spans_off_is_one_shared_noop(monkeypatch):
    """Spans off (the default): every annotate is the same do-nothing
    context, opens no record_function and times nothing; on, it opens one
    and adds its host seconds, and a device span takes a name that has
    markers."""
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    assert not profiling.spans_enabled()
    before = profiling.host_seconds()
    a, b = annotate("ppo.collect", torch.device("cpu")), annotate("env.step")
    assert a is b
    with a:
        pass
    assert calls == [] and profiling.host_seconds() == before
    assert profiling.counter("ant.active_rows", "cpu") is None
    profiling.enable_spans(True)
    try:
        with annotate("ppo.learn", torch.device("cpu")):
            pass
        with pytest.raises(ValueError):  # no device markers for this name
            annotate("taxi-rollout", torch.device("cuda"))
    finally:
        profiling.enable_spans(False)
    assert calls[0] == "ppo.learn"
    assert profiling.host_seconds()["ppo.learn"] > before.get("ppo.learn", 0.0)


def test_span_markers_name_and_pair():
    """A marker's device name gives back its span and kind; markers fed in
    any order pair by nesting on one stream (the n-th span of a name in
    time order first); an unmatched begin or end raises."""
    for span in ("ppo.collect", "env.step", "ant.forward", "a_b.c1"):
        for begin in (True, False):
            name = profiling.marker_name(span, begin)
            assert name.startswith(profiling.MARKER_PREFIX)
            assert name.isidentifier() and profiling.parse_marker(name) == (span, begin)
    for bad in ("taxi-rollout", "a..b", "a__b", "_a", "a."):
        with pytest.raises(ValueError):
            profiling.marker_name(bad, True)
    assert profiling.parse_marker("indexing_backward_kernel") is None
    assert profiling.parse_marker(profiling.MARKER_PREFIX + "middle_x") is None

    def m(span, begin, t):
        return (profiling.marker_name(span, begin), t, 2)

    events = [m("ppo.collect", True, 0), m("env.step", True, 10), m("env.step", False, 20),
              m("env.step", True, 30), m("ant.forward", True, 31),
              m("ant.forward", False, 40), m("env.step", False, 50),
              m("ppo.collect", False, 60), m("ppo.learn", True, 70),
              m("ppo.learn", False, 90)]
    spans = profiling.pair_markers(events[::-1])
    assert spans == {"ppo.collect": [(0, 62)], "env.step": [(10, 22), (30, 52)],
                     "ant.forward": [(31, 42)], "ppo.learn": [(70, 92)]}
    for broken in (events[:-1], events[1:], events[:2] + events[3:]):
        with pytest.raises(ValueError):
            profiling.pair_markers(broken)


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
