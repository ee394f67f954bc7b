"""Shared helpers of the harness's own tests: cells at sizes a CPU test
run can hold, built from the committed files with the traffic's sizes
overridden."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: per cell: traffic and env overrides small enough for the CPU
TINY = {
    "ext_hansen_taxi.rollout": ({"num_envs": 1024, "num_steps": 24}, {}),
    "ext_hansen_taxi.qlearn": ({"num_envs": 1024, "num_steps": 24}, {}),
    "ext_hansen_taxi.ppo": ({"num_envs": 64, "rollout_steps": 32}, {}),
    "ant_tag.ppo": ({"num_envs": 16, "rollout_steps": 3}, {"frame_skip": 1}),
}


def tiny_spec(name: str):
    from portbench import core

    spec = core.cell_spec(core.benchmark(), name)
    traffic, env = TINY[name]
    spec["traffic"].update(traffic)
    spec["config"]["env_kwargs"].update(env)
    return spec


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
