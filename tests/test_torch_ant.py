"""The port's host-MuJoCo ant envs (``gym_po_tpu_torch.envs.ant``) against
the JAX package's (``gym_po_tpu.envs.ant``), on the CPU.

Both run MuJoCo's C pipeline on models compiled from equal XML, so from the
same ``reset(seed=...)`` and the same numpy actions every observation,
reward and flag is equal.  The semantic tests are ``tests/test_ant.py``'s on
the port's classes; the gymnasium registration runs in a fresh process.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from gym_po_tpu.envs import ant as jant  # noqa: E402
from gym_po_tpu_torch.envs.ant import AntHeavenHellEnv, AntTagEnv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tag():
    return AntTagEnv()


@pytest.fixture(scope="module")
def hh():
    return AntHeavenHellEnv()


# ------------------------------------------------ tests/test_ant.py's checks
def test_tag_reset_contract(tag):
    obs, info = tag.reset(seed=0)
    assert obs.shape == (29,) and obs.dtype == np.float32
    # target at least min_distance away => not visible => last 2 dims zero
    assert (obs[-2:] == 0).all()
    ant_xy = tag.data.qpos[:2]
    assert np.linalg.norm(ant_xy - tag.target_pos) > 5.0
    # indicator spheres track the ant
    np.testing.assert_allclose(tag.data.mocap_pos[1, :2], ant_xy)


def test_tag_step_and_visibility(tag):
    tag.reset(seed=1)
    # teleport the target next to the ant: visible and almost tagged
    ant_xy = tag.data.qpos[:2].copy()
    tag.data.mocap_pos[0, :2] = ant_xy + np.array([2.0, 0.0])
    obs, r, d, tr, _ = tag.step(np.zeros(8))
    if not d:  # target may have moved/tagged; visible => obs tail nonzero
        assert np.abs(obs[-2:]).sum() > 0 or np.linalg.norm(
            tag.data.qpos[:2] - tag.target_pos
        ) >= 3.0


def test_tag_reward_on_tag(tag):
    tag.reset(seed=2)
    ant_xy = tag.data.qpos[:2].copy()
    # 0.5 away: even after one sim step + a 0.5 target move, still <= 1.5
    tag.data.mocap_pos[0, :2] = ant_xy + np.array([0.5, 0.0])
    obs, r, d, tr, _ = tag.step(np.zeros(8))
    assert d and r == 1.0


def test_tag_target_stays_in_cage(tag):
    tag.reset(seed=3)
    for t in range(40):
        tag.step(np.random.default_rng(t).uniform(-1, 1, 8))
        assert (np.abs(tag.target_pos) <= 4.5 + 1e-9).all()


def test_hh_reset_contract(hh):
    obs, info = hh.reset(seed=0)
    assert obs.shape == (28,) and obs.dtype == np.float32
    assert obs[-1] == 0.0  # priest not in range at spawn
    assert abs(hh.heaven_direction) == 1.0
    # site colors match the flip
    right = np.asarray(hh.model.site("right_area").rgba)
    left = np.asarray(hh.model.site("left_area").rgba)
    if hh.heaven_direction > 0:
        assert right[1] == 1.0 and left[0] == 1.0  # right green, left red
    else:
        assert right[0] == 1.0 and left[1] == 1.0


def test_hh_heaven_flip_is_random():
    env = AntHeavenHellEnv()
    dirs = set()
    for s in range(12):
        env.reset(seed=s)
        dirs.add(env.heaven_direction)
    assert dirs == {-1.0, 1.0}


def test_hh_priest_reveals_direction(hh):
    hh.reset(seed=1)
    # teleport the ant to the priest
    qpos = hh.data.qpos.copy()
    qpos[:2] = (0.0, 6.0)
    hh.set_state(qpos, hh.data.qvel.copy())
    obs, r, d, tr, _ = hh.step(np.zeros(8))
    assert obs[-1] == hh.heaven_direction
    assert not d and r == 0.0


def test_hh_terminal_rewards(hh):
    hh.reset(seed=2)
    heaven = hh.heaven_pos
    qpos = hh.data.qpos.copy()
    qpos[:2] = heaven
    hh.set_state(qpos, hh.data.qvel.copy())
    obs, r, d, tr, _ = hh.step(np.zeros(8))
    assert d and r == 1.0
    hh.reset(seed=3)
    hell = hh._sites[0] if (hh.heaven_pos == hh._sites[1]).all() else hh._sites[1]
    qpos = hh.data.qpos.copy()
    qpos[:2] = hell
    hh.set_state(qpos, hh.data.qvel.copy())
    obs, r, d, tr, _ = hh.step(np.zeros(8))
    assert d and r == -1.0


# ------------------------------------------------------ against the JAX env
ENVS = {"tag": (AntTagEnv, jant.AntTagEnv),
        "hh": (AntHeavenHellEnv, jant.AntHeavenHellEnv)}


@pytest.fixture(scope="module")
def pairs():
    return {k: (port(), ref()) for k, (port, ref) in ENVS.items()}


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kind", ["tag", "hh"])
def test_trajectory_equals_jax_env(pairs, kind, seed):
    """3 seeds x 50 steps of numpy-seeded actions at the default frame_skip
    15: obs, reward, terminated and truncated equal, reset after an end."""
    port, ref = pairs[kind]
    assert port.frame_skip == ref.frame_skip == 15
    a, _ = port.reset(seed=seed)
    b, _ = ref.reset(seed=seed)
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    for t in range(50):
        act = rng.uniform(-1, 1, 8)
        got, want = port.step(act), ref.step(act)
        assert got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        if got[2] or got[3]:
            a, _ = port.reset(seed=seed + 1000 + t)
            b, _ = ref.reset(seed=seed + 1000 + t)
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.data.qpos, ref.data.qpos)
    np.testing.assert_array_equal(port.data.mocap_pos, ref.data.mocap_pos)


def test_model_equals_jax_envs_and_leaves_no_file():
    """The port compiles the same model as the JAX env, from a file of its
    own that is gone once the env is built."""
    tmp = tempfile.gettempdir()
    before = set(os.listdir(tmp))
    for port_cls, ref_cls in ENVS.values():
        port, ref = port_cls(), ref_cls()
        for name in ("body_pos", "body_mass", "body_inertia", "geom_size",
                     "jnt_range", "actuator_gear", "site_pos", "site_rgba"):
            np.testing.assert_array_equal(getattr(port.model, name),
                                          getattr(ref.model, name))
        assert port.dt == ref.dt and port.action_space == ref.action_space
    new = set(os.listdir(tmp)) - before
    assert not [f for f in new if f.startswith(("ant_tag-", "ant_heaven_hell-"))]


# -------------------------------------------- gymnasium ids, fresh process
_REGISTER = textwrap.dedent(
    """
    import sys

    JAX_FIRST = {jax_first}
    if JAX_FIRST:
        import gym_po_tpu  # registers the ids to the JAX envs
    else:
        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "gym_po_tpu"):
                    raise ImportError(f"{{name}} is blocked in this test")
                return None

        sys.meta_path.insert(0, BlockJax())
    import gymnasium
    from gymnasium.envs.registration import registry

    import gym_po_tpu_torch
    from gym_po_tpu_torch.envs.ant import register_gymnasium_envs

    ids = ("pdomains-ant-tag-v1", "pdomains-ant-heaven-hell-v1", "AntTag-v1",
           "AntHeavenHell-v1")
    assert JAX_FIRST or not [i for i in ids if i in registry]
    register_gymnasium_envs()
    for env_id, dim in zip(ids, (29, 28, 29, 28)):
        spec = registry[env_id]
        kind = "Tag" if dim == 29 else "HeavenHell"
        assert spec.entry_point == f"gym_po_tpu_torch.envs.ant:Ant{{kind}}Env"
        assert spec.max_episode_steps == 500
        env = gymnasium.make(env_id)
        assert type(env.unwrapped).__module__ == "gym_po_tpu_torch.envs.ant"
        obs, _ = env.reset(seed=0)
        assert obs.shape == (dim,) and obs.dtype == "float32"
        env.close()
    assert JAX_FIRST or "jax" not in sys.modules
    print("ok")
    """
)


@pytest.mark.parametrize("jax_first", [False, True])
def test_gymnasium_registration_in_a_fresh_process(jax_first):
    """The four ids resolve to the port's classes with a 500-step limit and
    29/28-dim observations; also in a process whose JAX import registered
    them to the JAX envs first."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REGISTER.format(jax_first=jax_first)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok"), proc.stdout
