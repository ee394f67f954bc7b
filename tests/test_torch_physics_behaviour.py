"""The port's ant engine in the JAX package's behavioural tests of its
integrator (``tests/test_physics_contact.py``, which it marks slow for
their XLA compiles; the port needs none): the envs' f32, 8-iteration
default against the f64, 15-iteration parity configuration over 120
contact-rich RK4 steps, wall containment, Euler against RK4.
"""

import numpy as np
import torch

from gym_po_tpu_torch.physics import contact as tcon
from gym_po_tpu_torch.physics import dynamics as tdyn
from gym_po_tpu_torch.physics import engine as teng

from test_torch_physics import STAND, _models, _t, one_thread  # noqa: F401


def test_f32_default_config_tracks_f64_parity_config():
    """The envs' f32, 8-iteration default against the f64, 15-iteration
    configuration over 120 contact-rich RK4 steps, at the JAX package's
    bounds (``tests/test_physics_contact.py``): positions within 5e-3,
    velocities 5e-2, no penetration past 2 cm, the ant on its feet."""
    _, tm = _models("tag")
    ctrls = np.random.default_rng(0).uniform(-1, 1, (120, 8))

    def traj(dtype, iters):
        st = teng.init_state(tm, torch.as_tensor(STAND, dtype=dtype)[None],
                             torch.zeros(1, 14, dtype=dtype))
        qp, qv = [], []
        for c in ctrls:
            st = teng.rk4_step(tm, st, torch.as_tensor(c, dtype=dtype)[None],
                               iters=iters)
            qp.append(st.qpos[0].double())
            qv.append(st.qvel[0].double())
        return torch.stack(qp), torch.stack(qv)

    qp64, qv64 = traj(torch.float64, 15)
    qp32, qv32 = traj(torch.float32, 8)
    assert torch.isfinite(qp32).all() and torch.isfinite(qv32).all()
    assert (qp32[:, :3] - qp64[:, :3]).abs().max() < 5e-3
    np.testing.assert_allclose(qv32.numpy(), qv64.numpy(), atol=5e-2)
    dist, _, _ = tcon.candidates(tm, tdyn.kinematics(tm, qp32))
    assert dist[:, :25].min() > -0.02                # the floor spheres
    assert qv32.abs().max() < 10.0
    assert 0.2 < qp32[:, 2].min() and qp32[:, 2].max() < 1.0


def test_wall_containment_and_euler():
    """Shoved into the east wall the ant stays inside the cage; the Euler
    knob stays on its feet and near the RK4 trajectory over 10 steps (the
    JAX package's behavioural tests)."""
    _, tm = _models("tag")
    qpos = STAND.copy()
    qpos[0] = 4.4
    state = teng.init_state(tm, _t(qpos)[None], torch.zeros(1, 14, dtype=torch.float64))
    state = state._replace(qvel=torch.zeros(1, 14, dtype=torch.float64).index_fill_(
        1, torch.tensor([0]), 3.0))
    for _ in range(6):
        state = teng.step(tm, state, torch.zeros(1, 8), frame_skip=5, iters=8)
    assert float(state.qpos[0, 0]) < 5.0 + 0.25
    assert torch.isfinite(state.qpos).all()
    ctrls = np.random.default_rng(7).uniform(-1, 1, (10, 8)).astype(np.float32)
    s_rk = s_eu = teng.init_state(tm, torch.as_tensor(STAND, dtype=torch.float32)[None],
                                  torch.zeros(1, 14))
    for c in ctrls:
        s_rk = teng.step(tm, s_rk, torch.as_tensor(c)[None], frame_skip=1, iters=8)
        s_eu = teng.step(tm, s_eu, torch.as_tensor(c)[None], frame_skip=1, iters=8,
                         integrator="euler")
    q_eu = s_eu.qpos[0].numpy()
    assert np.isfinite(q_eu).all() and 0.1 < q_eu[2] < 1.5
    np.testing.assert_allclose(q_eu, s_rk.qpos[0].numpy(), atol=0.05)
