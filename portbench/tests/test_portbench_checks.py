"""Each cell's check at sizes a CPU test run can hold: sound runs come out
correct; the control (the reference at the precision below the
configuration's, in the program's place) and each fault the cell can
have, planted under the harness, come out not correct."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import tiny_spec

from portbench import core, faults, run

SEED = 2**31 + 12345


def _run(name):
    line, checks = run.run_cell(tiny_spec(name), SEED, 0.3, False, "cpu")
    return json.loads(line), checks


def _cell(name):
    spec = tiny_spec(name)
    cell = core.driver(spec["traffic"]["kind"]).Cell(spec, SEED, torch.device("cpu"))
    core.run_window(cell.enqueue, 0.2, torch, False)
    cell.close_window()
    cell.release()
    return cell


@pytest.mark.parametrize("name", ["ext_hansen_taxi.rollout", "ext_hansen_taxi.qlearn",
                                  "ext_hansen_taxi.ppo", "ant_tag.ppo"])
def test_sound_run_is_correct(name):
    line, checks = _run(name)
    assert line["correct"], checks
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name", ["ext_hansen_taxi.rollout", "ext_hansen_taxi.qlearn",
                                  "ext_hansen_taxi.ppo", "ant_tag.ppo"])
def test_control_fails(name):
    checks = _cell(name).check(control=True)
    assert not all(core.check_ok(c) for c in checks), checks


@pytest.mark.parametrize("kind,name,fault", [
    (kind, name, fault)
    for kind, name in (("rollout", "ext_hansen_taxi.rollout"),
                       ("qlearn", "ext_hansen_taxi.qlearn"),
                       ("ppo", "ext_hansen_taxi.ppo"), ("ppo", "ant_tag.ppo"))
    for fault in faults.FAULTS_OF[kind]
    # the draws of a tiny run are too few to show a sampler's fault:
    # test_sampling_faults holds the statistic at the cells' own sizes
    if fault not in ("greedy", "hot")])
def test_faults_fail(kind, name, fault):
    with faults.plant(kind, fault):
        line, _ = _run(name)
    assert not line["correct"]


@pytest.mark.parametrize("name,rows", [("ant_tag.ppo", 16 * 4096),
                                       ("ext_hansen_taxi.ppo", 128 * 4096)])
def test_sampling_faults(name, rows):
    """``sampling_z`` of draws from a policy like the first update's, at
    the cell's rows: under the limit for sound draws, over it for greedy
    draws and, on the ant, for draws at a temperature of 1.2."""
    from portbench.reference import ppo as ref_ppo

    limit = tiny_spec(name)["own"]["limits"]["sampling_z"]
    g = torch.Generator().manual_seed(7)
    if name == "ant_tag.ppo":
        mean = 0.05 * torch.randn(rows, 8, generator=g)
        pi = ("gaussian", mean, torch.zeros(8))
        draw = {"sound": mean + torch.randn(rows, 8, generator=g), "greedy": mean,
                "hot": mean + faults.HOT * torch.randn(rows, 8, generator=g)}
    else:
        logits = 0.05 * torch.randn(rows, 5, generator=g)
        pi = ("categorical", logits)
        gumbel = -torch.log(-torch.log(torch.rand(rows, 5, generator=g)))
        draw = {"sound": torch.argmax(logits + gumbel, -1),
                "greedy": torch.argmax(logits, -1)}
    z = {k: ref_ppo.sampling_z(pi, a) for k, a in draw.items()}
    assert z.pop("sound") < limit < min(z.values()), z


def test_ppo_unchanged_state_reads_one():
    with faults.plant("ppo", "unchanged"):
        _, checks = _run("ext_hansen_taxi.ppo")
    change = {c["name"]: c["value"] for c in checks}["change_gap"]
    assert change == pytest.approx(1.0)


def test_ant_physics_fault(monkeypatch):
    from gym_po_tpu_torch.envs import ant_physics

    real = ant_physics._AntPhysicsBase.physics

    def physics(self, qpos, qvel, warm, action):
        q, v, w = real(self, qpos, qvel, warm, action)
        return q, v * 1.1, w
    monkeypatch.setattr(ant_physics._AntPhysicsBase, "physics", physics)
    line, _ = _run("ant_tag.ppo")
    assert not line["correct"]


@pytest.mark.cuda
def test_control_on_the_card(cuda_device):
    """The control at a small size on the card (the benchmark's own runs
    never run it)."""
    spec = tiny_spec("ext_hansen_taxi.rollout")
    cell = core.driver("rollout").Cell(spec, SEED, cuda_device)
    core.run_window(cell.enqueue, 0.2, torch, True)
    cell.close_window()
    cell.release()
    assert all(core.check_ok(c) for c in cell.check())
    assert not all(core.check_ok(c) for c in cell.check(control=True))
