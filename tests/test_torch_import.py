"""The PyTorch port imports with jax and flax blocked, on CPU-only torch."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "flax")
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
    import gym_po_tpu_torch.agents
    import gym_po_tpu_torch.entry
    import gym_po_tpu_torch.ops
    import gym_po_tpu_torch.ops._build
    import gym_po_tpu_torch.ops.probe_fused_taxi
    import gym_po_tpu_torch.vector
    import chip_smoke

    env = gym_po_tpu_torch.make("ExtendedHansenTaxi-v4")
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
                   "ExtendedHansenTaxi-v4"):
        assert env_id in proc.stdout


def test_unported_env_raises_keyerror_listing_available():
    import gym_po_tpu_torch as gpt_torch

    with pytest.raises(KeyError, match="Available"):
        gpt_torch.make("Rooms-v0")
    assert gpt_torch.registered_envs() == [
        "ExtendedHansenTaxi-v4", "ExtendedTaxi-v4", "HansenTaxi-v4", "Taxi-v4",
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
