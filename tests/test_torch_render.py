"""The port's renderers (``gym_po_tpu_torch.render``) against the JAX
package's, on the CPU: from identical states every frame is the JAX
renderer's, pixel for pixel.

The states are the port's (a reset, then a few random steps, so agents,
passengers and targets sit at varied places); the JAX renderer gets a JAX
state of the same env whose rendered fields hold the same values.  The
glyph tests are ``tests/test_render.py``'s on the port's copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu import render as jrender
from gym_po_tpu_torch import render as trender
from gym_po_tpu_torch.render.glyphs import (
    GLYPH_H,
    GLYPH_W,
    draw_text_at,
    text_size,
)

# env id, kwargs, the state fields a renderer reads
CASES = [
    ("Taxi-v4", {}, ("s",)),
    ("ExtendedHansenTaxi-v4", dict(num_passengers=2), ("s",)),
    ("Rooms-v0", dict(layout="16"), ("agent_yx", "goal_yx")),
    ("CRooms-v0", dict(cell_size=0.75, goal_xy=None), ("agent_yx", "goal_yx")),
    ("MultistoryFourRooms-v0", dict(grid_z=3), ("agent_zyx", "goal_zyx")),
    ("CarFlag-v0", {}, ("pos", "heaven", "priest")),
    ("TagContinuous-v0", {}, ("agent_xy", "target_xy")),
    ("HeavenHellContinuous-v0", {}, ("agent_xy", "heaven_right")),
    ("RockSample-v0", dict(map_size=(5, 5), num_rocks=4), ("pos_yx", "rock_good")),
]


def _states(env_id, kw, fields, n=5):
    te = gpt_torch.make(env_id, device="cpu", **kw)
    gen = torch.Generator().manual_seed(2)
    _, st = te.reset_vec(gen, n)
    for _ in range(7):
        _, st, *_ = te.step_vec(gen, st, te.action_space.sample_vec(gen, n))
    je = gpt.make(env_id, **kw)
    _, jst = je.reset_vec(jax.random.PRNGKey(0), n)
    jst = jst.replace(**{f: jnp.asarray(getattr(st, f).numpy(),
                                        dtype=getattr(jst, f).dtype)
                         for f in fields})
    return te, st, je, jst


@pytest.mark.parametrize("env_id,kw,fields", CASES, ids=[c[0] for c in CASES])
def test_frames_equal_jax_pixel_for_pixel(env_id, kw, fields):
    te, st, je, jst = _states(env_id, kw, fields)
    for idx in (None, [3], range(5)):
        got = trender.render(te, st, idx)
        want = jrender.render(je, jst, idx)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert got.max() > 0 and len(np.unique(got.reshape(-1, 3), axis=0)) > 2


def test_render_refuses_an_env_it_has_no_renderer_for():
    with pytest.raises(TypeError, match="No renderer"):
        trender.render(object(), None)


def test_tile_images_montage():
    frames = [np.full((4, 6, 3), i, np.uint8) for i in range(5)]
    out = trender.tile_images(frames)
    np.testing.assert_array_equal(out, jrender.tile_images(frames))
    assert out.shape == (8, 18, 3)


def test_human_view_imports_pygame_only_when_called():
    import inspect

    src = inspect.getsource(trender.renderers)
    assert src.count("import pygame") == 1
    assert "    import pygame" in inspect.getsource(trender.human_view)


# ------------------------------------------- tests/test_render.py's glyphs
def test_draw_text_writes_glyph_pixels():
    img = np.zeros((20, 40, 3), np.uint8)
    draw_text_at(img, "T", (2, 3), (255, 0, 0))
    assert (img[3, 2:7] == (255, 0, 0)).all()
    assert (img[6, 4] == (255, 0, 0)).all()
    assert (img[6, 2] == 0).all() and (img[6, 6] == 0).all()


def test_draw_text_scale_and_size():
    h, w = text_size("AB", scale=2)
    assert h == GLYPH_H * 2
    assert w == (2 * (GLYPH_W + 1) - 1) * 2
    img = np.zeros((30, 40, 3), np.uint8)
    draw_text_at(img, "A", (0, 0), (9, 9, 9), scale=2)
    assert (img == 9).any()


def test_draw_text_clips_at_frame_edges():
    img = np.zeros((8, 8, 3), np.uint8)
    draw_text_at(img, "W", (-3, -4), (255, 255, 255))
    draw_text_at(img, "W", (6, 6), (255, 255, 255))
    draw_text_at(img, "W", (100, 100), (255, 255, 255))
    assert img.shape == (8, 8, 3)


def test_draw_text_unknown_char_falls_back():
    img = np.zeros((10, 10, 3), np.uint8)
    draw_text_at(img, "~", (1, 1), (7, 7, 7))
    assert (img == 7).any()


def test_glyphs_equal_jax():
    from gym_po_tpu.render import glyphs as jglyphs

    for text, scale in (("RGBY 0123456789", 1), ("T:F-P+D.?", 2), ("~", 3)):
        a = np.zeros((24, 200, 3), np.uint8)
        b = a.copy()
        draw_text_at(a, text, (1, 2), (10, 20, 30), scale)
        jglyphs.draw_text_at(b, text, (1, 2), (10, 20, 30), scale)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the articulated ant
ANT_CASES = [("AntTagPhysics-v0", ("qpos", "target_xy")),
             ("AntHeavenHellPhysics-v0", ("qpos", "heaven_right"))]
ANT_KW = dict(frame_skip=1, solver_iters=2)


def _ant_states(env_id, fields, n=4, seed=5):
    """The port's ant state after a reset and one step of random actions,
    its leg joints perturbed by numpy-seeded noise, and a JAX state of the
    same env holding the same rendered fields."""
    te = gpt_torch.make(env_id, device="cpu", **ANT_KW)
    gen = torch.Generator().manual_seed(seed)
    _, st = te.reset_vec(gen, n)
    _, st, *_ = te.step_vec(gen, st, te.action_space.sample_vec(gen, n))
    rng = np.random.default_rng(seed)
    noise = rng.uniform(-0.5, 0.5, (n, 8)).astype(np.float32)
    st = st.replace(qpos=torch.cat([st.qpos[:, :7],
                                    st.qpos[:, 7:] + torch.as_tensor(noise)], 1))
    je = gpt.make(env_id, **ANT_KW)
    _, jst = je.reset_vec(jax.random.PRNGKey(0), n)
    jst = jst.replace(**{f: jnp.asarray(getattr(st, f).numpy(),
                                        dtype=getattr(jst, f).dtype)
                         for f in fields})
    return te, st, je, jst


@pytest.mark.parametrize("env_id,fields", ANT_CASES, ids=[c[0] for c in ANT_CASES])
def test_ant_frames_equal_jax_pixel_for_pixel(env_id, fields):
    te, st, je, jst = _ant_states(env_id, fields)
    for idx in (None, [2], range(4)):
        got = trender.render_ant(te, st, idx)
        want = jrender.render_ant(je, jst, idx)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(trender.render(te, st, idx), got)
    colors = {tuple(c) for c in np.unique(got.reshape(-1, 3), axis=0)}
    assert {trender.COLORS["agent"], trender.COLORS["wall"],
            (150, 110, 60)} <= colors  # torso, walls, legs


def test_ant_np_fk_equals_jax_and_the_engine():
    """The renderer's f64 NumPy FK is the JAX copy's bit for bit, and the
    engine's ``physics.dynamics.fk`` at f64 to 1e-12."""
    from gym_po_tpu.render.renderers import _np_fk as jax_np_fk
    from gym_po_tpu_torch.envs.ant_physics import STAND_POSE
    from gym_po_tpu_torch.physics import TAG_WALLS, make_ant_model
    from gym_po_tpu_torch.physics.dynamics import fk
    from gym_po_tpu_torch.render.renderers import _np_fk

    model = make_ant_model(TAG_WALLS)
    rng = np.random.default_rng(0)
    n = 16
    qpos = np.tile(STAND_POSE.astype(np.float64), (n, 1))
    qpos[:, :3] += rng.uniform(-3.0, 3.0, (n, 3))
    qpos[:, 3:7] += rng.normal(scale=0.5, size=(n, 4))  # unnormalised: fk normalises
    qpos[:, 7:] += rng.uniform(-1.0, 1.0, (n, 8))
    xpos, _, xmat = fk(model, torch.as_tensor(qpos))
    for k in range(n):
        got = _np_fk(model, qpos[k])
        for g, w in zip(got, jax_np_fk(model, qpos[k])):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(got[0], xpos[k].numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[1], xmat[k].numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("env_id,fields", ANT_CASES, ids=[c[0] for c in ANT_CASES])
def test_ant_scene_frames_equal_jax(env_id, fields):
    """render_ant_scene draws the MuJoCo scene; skips only where mujoco or
    a GL backend (EGL) is missing, as tests/test_render.py's does."""
    pytest.importorskip("mujoco")
    te, st, je, jst = _ant_states(env_id, fields)
    try:
        want = jrender.render_ant_scene(je, jst, idx=[0, 3], width=160, height=120)
    except Exception as e:  # no EGL on this machine
        pytest.skip(f"GL unavailable: {e}")
    got = trender.render_ant_scene(te, st, idx=[0, 3], width=160, height=120)
    assert got.dtype == np.uint8 and got.shape == (120, 320, 3)
    assert got.std() > 1.0  # a real scene, not a blank buffer
    np.testing.assert_array_equal(got, want)
