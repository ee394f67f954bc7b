"""The PyTorch port imports with jax, flax, gymnasium, pygame and mujoco
blocked, on CPU-only torch."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "gymnasium", "pygame", "mujoco")
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, BlockJax())

    import gym_po_tpu_torch
    import gym_po_tpu_torch.parallel
    # the gymnasium adapter, the renderers and the host-MuJoCo ant envs are
    # not imported by the package
    assert "gym_po_tpu_torch.compat" not in sys.modules
    assert "gym_po_tpu_torch.render" not in sys.modules
    assert "gym_po_tpu_torch.envs.ant" not in sys.modules
    import gym_po_tpu_torch.agents
    import gym_po_tpu_torch.entry
    import gym_po_tpu_torch.agents.qlearning
    import gym_po_tpu_torch.parallel
    import gym_po_tpu_torch.ops
    import gym_po_tpu_torch.ops._build
    import gym_po_tpu_torch.ops.probe_fused_taxi
    import gym_po_tpu_torch.ops.probe_fused_qlearning
    import gym_po_tpu_torch.ops.fused_ac
    import gym_po_tpu_torch.ops.fused_qlambda
    import gym_po_tpu_torch.ops.fused_rooms
    import gym_po_tpu_torch.ops.fused_msrooms
    import gym_po_tpu_torch.ops.fused_rocksample
    import gym_po_tpu_torch.ops.msrooms_dynamics
    import gym_po_tpu_torch.envs.msrooms
    import gym_po_tpu_torch.envs.rocksample
    import gym_po_tpu_torch.envs.crooms
    import gym_po_tpu_torch.envs.tag
    import gym_po_tpu_torch.envs.car_flag
    import gym_po_tpu_torch.envs.shaping
    import gym_po_tpu_torch.agents.ppo
    import gym_po_tpu_torch.agents.ppo_rnn
    import gym_po_tpu_torch.utils.checkpoint
    import gym_po_tpu_torch.utils.debug
    import gym_po_tpu_torch.utils.grid
    import gym_po_tpu_torch.utils.profiling
    import gym_po_tpu_torch.render
    import gym_po_tpu_torch.ops.crooms_dynamics
    import gym_po_tpu_torch.ops.fused_crooms
    import gym_po_tpu_torch.ops.fused_q_crooms
    import gym_po_tpu_torch.ops.fused_tag
    import gym_po_tpu_torch.ops.state_rollout
    import gym_po_tpu_torch.obs
    import gym_po_tpu_torch.utils
    import gym_po_tpu_torch.vector
    import gym_po_tpu_torch.physics
    import gym_po_tpu_torch.physics.ant_model
    import gym_po_tpu_torch.physics.contact
    import gym_po_tpu_torch.physics.dynamics
    import gym_po_tpu_torch.physics.engine
    import gym_po_tpu_torch.physics.linalg
    import gym_po_tpu_torch.physics.spatial
    import gym_po_tpu_torch.ops.ant_forward
    import gym_po_tpu_torch.envs.ant_physics
    import gym_po_tpu_torch.envs.mjcf
    import chip_smoke

    env = gym_po_tpu_torch.make("ExtendedHansenTaxi-v4", device="cpu")
    env = gym_po_tpu_torch.make("Rooms-v0", device="cpu")
    env = gym_po_tpu_torch.make("MultistoryFourRooms-v0", grid_z=3, device="cpu")
    env = gym_po_tpu_torch.make("RockSample-v0", device="cpu")
    env = gym_po_tpu_torch.make("CRooms-v0", device="cpu")
    env = gym_po_tpu_torch.make("TagContinuous-v0", device="cpu")
    env = gym_po_tpu_torch.make("HeavenHellContinuous-v0", device="cpu")
    env = gym_po_tpu_torch.make("CarFlag-v0", device="cpu")
    env = gym_po_tpu_torch.make("DiscreteCarFlag-v0", device="cpu")
    import torch
    for ant_id in ("AntTagPhysics-v0", "AntHeavenHellPhysics-v0"):
        ant = gym_po_tpu_torch.make(ant_id, frame_skip=1, solver_iters=1,
                                    device="cpu")
        g = torch.Generator().manual_seed(0)
        _, st = ant.reset_vec(g, 2)
        ant.step_vec(g, st, torch.zeros(2, 8))
    assert "mujoco" not in sys.modules
    from gym_po_tpu_torch.agents import PPOConfig, init_rnn_state
    init_rnn_state(env, PPOConfig(num_envs=4, minibatches=2,
                                  compute_dtype=torch.bfloat16),
                   torch.Generator().manual_seed(0), hidden=8)
    assert "gym_po_tpu_torch.compat" not in sys.modules
    try:
        import gym_po_tpu_torch.compat
    except ImportError as e:
        assert "gymnasium" in str(e)
    else:
        raise AssertionError("the adapter imported without gymnasium")
    try:
        import gym_po_tpu_torch.envs.ant
    except ImportError as e:
        assert "gymnasium" in str(e) or "mujoco" in str(e)
    else:
        raise AssertionError("the host ant envs imported without gymnasium")
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("ok", gym_po_tpu_torch.registered_envs())
    """
)


def test_port_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok"), proc.stdout
    for env_id in ("Taxi-v4", "HansenTaxi-v4", "ExtendedTaxi-v4",
                   "ExtendedHansenTaxi-v4", "Rooms-v0", "MultistoryFourRooms-v0",
                   "RockSample-v0", "CRooms-v0", "TagContinuous-v0",
                   "HeavenHellContinuous-v0", "CarFlag-v0", "DiscreteCarFlag-v0",
                   "AntTagPhysics-v0", "AntHeavenHellPhysics-v0"):
        assert env_id in proc.stdout


def test_unported_env_raises_keyerror_listing_available():
    import gym_po_tpu_torch as gpt_torch

    with pytest.raises(KeyError, match="Available"):
        gpt_torch.make("AntTag-v0")  # an id in neither package's registry
    assert gpt_torch.registered_envs() == [
        "AntHeavenHellPhysics-v0", "AntTagPhysics-v0",
        "CRooms-v0", "CarFlag-v0", "DiscreteCarFlag-v0", "ExtendedHansenTaxi-v4",
        "ExtendedTaxi-v4", "HansenTaxi-v4", "HeavenHellContinuous-v0",
        "MultistoryFourRooms-v0", "RockSample-v0", "Rooms-v0", "TagContinuous-v0",
        "Taxi-v4",
    ]


def test_kernel_library_is_named_by_source_hash(tmp_path, monkeypatch):
    import shutil

    from gym_po_tpu_torch.ops import _build

    lib = _build._library_path("fused_taxi")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("fused_taxi-")
    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._library_path("fused_taxi") == lib  # same sources, same name
    header = tmp_path / "kernel_rng.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._library_path("fused_taxi") != lib  # any header edit rebuilds


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from gym_po_tpu_torch.ops import _build

    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("fused_taxi")
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
