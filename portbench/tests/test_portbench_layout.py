"""The benchmark's files: names and units, every cell's files found by
name, floors as functions of shapes alone, a cell added as files alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    spec = core.cell_spec(BENCH, cell)
    kind = spec["traffic"]["kind"]
    assert (ROOT / "portbench" / "drivers" / f"{kind}.py").exists()
    assert hasattr(core.driver(kind), "Cell")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(core.load_module(core.metric_reader(m["name"]), "m"), "read")
    assert any(m["name"] != "setup_s" for m in spec["end_to_end"])
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


@pytest.mark.parametrize("name,reader", [
    ("setup_s", "setup_s"), ("idle_pct.ppo.ant", "idle_pct"),
    ("ppo_steps_per_s.taxi", "steps_per_s"), ("train_steps_per_s", "steps_per_s"),
    ("ppo.mfu_pct.taxi", "ppo.mfu_pct"), ("fused_taxi_roofline", "roofline"),
    ("ant_forward_roofline", "ant_forward_roofline")])
def test_metric_reader_found_by_name(name, reader):
    """A metric's own reader, else the reader of its family of names."""
    assert core.metric_reader(name).stem == reader


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_floor_is_a_function_of_shapes(cell):
    spec = core.cell_spec(BENCH, cell)
    conf, kind = spec["cell"]["config"], spec["traffic"]["kind"]
    a = core.floor_of(conf, kind, spec["config"], spec["traffic"])
    b = core.floor_of(conf, kind, json.loads(json.dumps(spec["config"])),
                      dict(spec["traffic"]))
    assert a == b and a is not None
    bigger = dict(spec["traffic"], num_envs=2 * spec["traffic"]["num_envs"])
    c = core.floor_of(conf, kind, spec["config"], bigger)
    assert c != a
    src = (ROOT / "portbench" / "floors" / f"{conf}.{kind}.py").read_text()
    assert "gym_po_tpu" not in src


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new cell (a traffic file, its own file, a BENCHMARK.json entry)
    runs in a copy of the checkout with no other edit."""
    for item in ("portbench", "gym_po_tpu_torch"):
        shutil.copytree(ROOT / item, tmp_path / item,
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ext_hansen_taxi.rollout_small",
                               "config": "ext_hansen_taxi", "traffic": "rollout_small",
                               "chips": 1, "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ext_hansen_taxi.rollout" in m.get("workloads", []):
            m["workloads"].append("ext_hansen_taxi.rollout_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "traffic" / "rollout_small.json").write_text(json.dumps(
        {"kind": "rollout", "num_envs": 256, "num_steps": 8, "policy": "uniform"}))
    shutil.copy(tmp_path / "portbench" / "workloads" / "ext_hansen_taxi.rollout.json",
                tmp_path / "portbench" / "workloads" / "ext_hansen_taxi.rollout_small.json")
    code = ("import sys; sys.path.insert(0, '.'); from portbench import core, run; "
            "spec = core.cell_spec(core.benchmark(), 'ext_hansen_taxi.rollout_small'); "
            "print(run.run_cell(spec, 5, 0.2, False, 'cpu')[0])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and "rollout_steps_per_s" in line["metrics"]
    assert list(line)[-1] == "checks"


def test_no_result_without_the_program_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the command exits non-zero and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run([*BENCH["command"], "--workload", cell, "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
