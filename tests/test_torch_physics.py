"""The port's articulated-ant engine (``gym_po_tpu_torch.physics``) against
the JAX package's array pipeline, at float64 on the CPU.

Both packages build the model from one NumPy spec: the arrays must be equal
bit for bit.  On batched states from a numpy seed (standing poses on the
floor and pressed against the walls, and the JAX tests' random poses), the
port's smooth dynamics, constraint rows, Newton solve and APGD must match
``smooth_forward_array``, ``constraint_rows_array``,
``solve_constraints_newton`` and ``solve_constraints`` (each JAX function
compiled once per module, ``jax.vmap``-ed over the batch).  The MuJoCo
oracle tests hold the port to the compiled MJCF as the JAX package's
``tests/test_physics*.py`` hold it.  ``engine.step`` is in
``test_torch_physics_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_po_tpu.physics import ant_model as jam
from gym_po_tpu.physics import contact as jcon
from gym_po_tpu.physics import dynamics as jdyn
from gym_po_tpu.physics import engine as jeng
from gym_po_tpu.physics import linalg as jlin
from gym_po_tpu.physics import spatial as jsp
from gym_po_tpu_torch.physics import ant_model as tam
from gym_po_tpu_torch.physics import contact as tcon
from gym_po_tpu_torch.physics import dynamics as tdyn
from gym_po_tpu_torch.physics import engine as teng
from gym_po_tpu_torch.physics import linalg as tlin
from gym_po_tpu_torch.physics import spatial as tsp

WALLS = {"tag": "TAG_WALLS", "hh": "HEAVEN_HELL_WALLS"}
STAND = np.zeros(15)
STAND[2] = 0.55
STAND[3] = 1.0
STAND[7:] = [0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0]


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for the port: its steps are thousands of small ops,
    which intra-op threads only slow down when the cores are shared (the
    JAX side compiles and runs on its own threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def contact_states(n, seed, walls):
    """Standing poses perturbed (height, tilt, hinges, velocities,
    controls, warm starts); a quarter pressed against each arena's walls,
    and a quarter as the JAX tests' random poses (any orientation, low)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(STAND, (n, 1))
    qpos[:, :2] = rng.uniform(-3.5, 3.5, (n, 2))
    qpos[:, 2] += rng.uniform(-0.1, 0.05, n)
    qpos[:, 3:7] += rng.normal(scale=0.05, size=(n, 4))
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, 8))
    q = n // 4
    if walls == "tag":
        ax = rng.integers(0, 2, q)
        qpos[np.arange(q, 2 * q), ax] = rng.choice([-4.4, 4.4], q)
    else:  # the T-maze's bar top, side walls and stem walls
        pts = np.array([[0.0, 7.6], [7.6, 6.0], [-7.6, 5.0], [1.6, 1.5],
                        [-1.6, 0.0], [0.5, -1.1], [4.0, 3.8], [-5.0, 4.7]])
        qpos[q:2 * q, :2] = pts[rng.integers(0, len(pts), q)]
    qpos[2 * q:3 * q, 2] = rng.uniform(0.1, 0.6, q)
    qpos[2 * q:3 * q, 3:7] = rng.normal(size=(q, 4))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    return (qpos, 0.5 * rng.normal(size=(n, 14)), rng.uniform(-1, 1, (n, 8)),
            0.1 * rng.normal(size=(n, 14)))


def _models(walls):
    w = getattr(jam, WALLS[walls])
    return jam.make_ant_model(w), tam.make_ant_model(getattr(tam, WALLS[walls]))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX array pipeline on 16 states per arena: smooth dynamics, rows,
    the Newton forward (8 iterations, from a warm start) and 60 APGD
    iterations, one compile per arena."""
    out = {}
    with jax.enable_x64(True):
        for walls in WALLS:
            jm, _ = _models(walls)
            states = contact_states(16, 7, walls)

            def one(q, v, c, w, jm=jm):
                kin, M, qa, qf = jdyn.smooth_forward_array(jm, q, v, c)
                rows = jcon.constraint_rows_array(jm, kin, q, v)
                qn, fn = jcon.solve_constraints_newton(
                    jm, M, qa, rows, iters=8, ls_iters=10, qacc0=qa + w)
                qap, fap = jcon.solve_constraints(jm, M, qa, rows, iters=60)
                pj = jdyn.point_jacobian(jm, kin, jnp.asarray([0, 3, 7]),
                                         kin.com[jnp.asarray([0, 3, 7])])
                return (kin, M, qa, qf, rows, qn, fn, qap, fap, pj)

            res = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in states))
            out[walls] = (states, jax.tree_util.tree_map(np.asarray, res))
    return out


@pytest.mark.parametrize("walls", list(WALLS))
def test_model_equals_jax_bit_for_bit(walls):
    jm, tm = _models(walls)
    for f in dataclasses.fields(jam.AntModel):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b and type(a) is type(b), f.name
    for name in ("_body_invweight", "_dof_invweight"):
        assert np.array_equal(getattr(jcon, name)(jm), getattr(tcon, name)(tm))
    assert jcon._wall_slots(jm.walls) == tcon._wall_slots(tm.walls)
    np.testing.assert_array_equal(tam.TAG_WALLS, jam.TAG_WALLS)
    np.testing.assert_array_equal(tam.HEAVEN_HELL_WALLS, jam.HEAVEN_HELL_WALLS)


def test_spatial_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(32, 4))
    v = rng.normal(size=(32, 3))
    w = rng.normal(size=(32, 3)) * np.logspace(-12, 0, 32)[:, None]
    w[0] = 0.0
    with jax.enable_x64(True):
        J = [jnp.asarray(x) for x in (q, p, v, w)]
        pairs = [
            (jsp.quat_mul(J[0], J[1]), tsp.quat_mul(_t(q), _t(p))),
            (jsp.quat_conj(J[0]), tsp.quat_conj(_t(q))),
            (jsp.quat_rotate(J[0], J[2]), tsp.quat_rotate(_t(q), _t(v))),
            (jsp.quat_rotate_inv(J[0], J[2]), tsp.quat_rotate_inv(_t(q), _t(v))),
            (jsp.quat_to_mat(J[0]), tsp.quat_to_mat(_t(q))),
            (jsp.axis_angle_quat(J[3]), tsp.axis_angle_quat(_t(w))),
            (jsp.quat_integrate(J[0], J[3], 0.02),
             tsp.quat_integrate(_t(q), _t(w), 0.02)),
            (jsp.quat_normalize(J[1]), tsp.quat_normalize(_t(p))),
        ]
        for i, (a, b) in enumerate(pairs):
            assert b.dtype == torch.float64
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14,
                                       atol=1e-15, err_msg=str(i))


@pytest.mark.parametrize("batch", [(8,), (2, 4)])
def test_chol_solve(batch):
    rng = np.random.default_rng(1)
    a = rng.normal(size=batch + (14, 14))
    h = a @ np.swapaxes(a, -1, -2) + 14 * np.eye(14)
    g = rng.normal(size=batch + (14,))
    flat_h, flat_g = h.reshape(-1, 14, 14), g.reshape(-1, 14)
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(jlin.chol_solve)(jnp.asarray(flat_h),
                                                    jnp.asarray(flat_g)))
    got = tlin.chol_solve(_t(h), _t(g))
    assert got.shape == batch + (14,)
    np.testing.assert_allclose(got.numpy().reshape(-1, 14), want, rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(h, g[..., None])[..., 0],
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("walls", list(WALLS))
def test_smooth_dynamics_match_jax(jax_ref, walls):
    (qpos, qvel, ctrl, _), ref = jax_ref[walls]
    kin_j, M_j, qa_j, qf_j = ref[:4]
    _, tm = _models(walls)
    kin, M, qa, qf = tdyn.smooth_forward(tm, _t(qpos), _t(qvel), _t(ctrl))
    for name in ("xpos", "xquat", "xmat", "com", "inertia_w", "dof_u", "dof_p",
                 "jp", "jr"):
        np.testing.assert_allclose(getattr(kin, name).numpy(),
                                   getattr(kin_j, name), rtol=1e-12, atol=1e-14,
                                   err_msg=name)
    np.testing.assert_allclose(M.numpy(), M_j, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(qa.numpy(), qa_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(qf.numpy(), qf_j, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tdyn.mass_matrix(tm, kin).numpy(), M_j,
                               rtol=1e-10, atol=1e-12)
    xpos, xquat, _ = tdyn.fk(tm, _t(qpos))
    np.testing.assert_array_equal(xpos.numpy(), kin.xpos.numpy())
    np.testing.assert_array_equal(xquat.numpy(), kin.xquat.numpy())
    idx = torch.tensor([0, 3, 7])
    pj = tdyn.point_jacobian(tm, kin, idx, kin.com[:, idx])
    np.testing.assert_allclose(pj.numpy(), ref[9], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("walls", list(WALLS))
def test_constraint_rows_match_jax(jax_ref, walls):
    (qpos, qvel, ctrl, _), ref = jax_ref[walls]
    rows_j = ref[4]
    _, tm = _models(walls)
    kin, *_ = tdyn.smooth_forward(tm, _t(qpos), _t(qvel), _t(ctrl))
    rows = tcon.constraint_rows(tm, kin, _t(qpos), _t(qvel))
    assert rows.jac_t.shape == rows_j.jac_t.shape
    assert rows.jac.shape == rows_j.jac_t.swapaxes(-1, -2).shape
    np.testing.assert_allclose(rows.jac_t.numpy(), rows_j.jac_t, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(rows.aref.numpy(), rows_j.aref, rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(rows.r.numpy(), rows_j.r, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(rows.active.numpy(), rows_j.active)
    # the states engage the floor, the walls and the joint limits
    act = rows.active.numpy().astype(bool)
    assert act[:, :8].any() and act[:, 8:8 + 100].any() and act[:, 108:].any()


@pytest.mark.parametrize("walls", list(WALLS))
def test_newton_and_apgd_match_jax(jax_ref, walls):
    (qpos, qvel, ctrl, warm), ref = jax_ref[walls]
    _, tm = _models(walls)
    kin, M, qa, _ = tdyn.smooth_forward(tm, _t(qpos), _t(qvel), _t(ctrl))
    rows = tcon.constraint_rows(tm, kin, _t(qpos), _t(qvel))
    q, f = tcon.solve_constraints_newton(tm, M, qa, rows, iters=8, ls_iters=10,
                                         qacc0=qa + _t(warm))
    np.testing.assert_allclose(q.numpy(), ref[5], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(f.numpy(), ref[6], rtol=1e-9, atol=1e-9)
    # engine.forward: the same solve, and its warm start out
    qacc, w_out = teng.forward(tm, _t(qpos), _t(qvel), _t(ctrl), _t(warm),
                               iters=8, ls_iters=10)
    np.testing.assert_allclose(qacc.numpy(), ref[5], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(w_out.numpy(), ref[5] - ref[2], rtol=1e-9, atol=1e-9)
    qap, fap = tcon.solve_constraints(tm, M, qa, rows, iters=60)
    np.testing.assert_allclose(qap.numpy(), ref[7], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(fap.numpy(), ref[8], rtol=1e-8, atol=1e-8)


def test_forward_batch_shapes_and_knobs():
    _, tm = _models("tag")
    qpos, qvel, ctrl, warm = (_t(x) for x in contact_states(4, 3, "tag"))
    a, w = teng.forward(tm, qpos, qvel, ctrl, warm, iters=4)
    # any leading axes, one control for the batch, both pipeline names
    a2, w2 = teng.forward(tm, qpos.reshape(2, 2, 15), qvel.reshape(2, 2, 14),
                          ctrl.reshape(2, 2, 8), warm.reshape(2, 2, 14),
                          iters=4, pipeline="array")
    assert torch.equal(a2.reshape(4, 14), a) and torch.equal(w2.reshape(4, 14), w)
    a3, _ = teng.forward(tm, qpos[:1], qvel[:1], ctrl[0], None, iters=4)
    assert a3.shape == (1, 14)
    s = teng.step(tm, teng.init_state(tm, qpos, qvel), ctrl, frame_skip=1,
                  iters=2, unroll=4)
    assert s.warm.shape == (4, 14) and torch.isfinite(s.qpos).all()
    with pytest.raises(ValueError):
        teng.forward(tm, qpos, qvel, ctrl, pipeline="pallas")
    with pytest.raises(ValueError):
        teng.step(tm, teng.init_state(tm, qpos, qvel), ctrl, integrator="verlet")
    # the state converts from the JAX package's numpy arrays
    js = jeng.init_state(_models("tag")[0], jnp.asarray(STAND, jnp.float32),
                         jnp.zeros(14, jnp.float32))
    ts = teng.PhysicsState.from_numpy(*(np.asarray(x) for x in js), device="cpu")
    assert ts.qpos.dtype == torch.float32 and torch.equal(
        ts.qpos, torch.as_tensor(STAND, dtype=torch.float32))


# ------------------------------------------------------------ MuJoCo oracle
@pytest.fixture(scope="module")
def oracle():
    mujoco = pytest.importorskip("mujoco")
    from gym_po_tpu_torch.envs.mjcf import ant_tag_xml

    m = mujoco.MjModel.from_xml_string(ant_tag_xml())
    return mujoco, m, tam.make_ant_model(tam.TAG_WALLS)


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def test_model_matches_mujoco_compilation(oracle):
    mujoco, m, mdl = oracle
    for b in range(13):
        assert abs(m.body_mass[b + 1] - mdl.body_mass[b]) < 1e-12
        np.testing.assert_allclose(m.body_ipos[b + 1], mdl.body_ipos[b], atol=1e-12)
        ri = _quat_to_mat_np(m.body_iquat[b + 1])
        np.testing.assert_allclose(ri @ np.diag(m.body_inertia[b + 1]) @ ri.T,
                                   mdl.body_inertia[b], atol=1e-12)
        assert m.body_parentid[b + 1] - 1 == mdl.parent[b]
    for j in range(8):
        assert m.jnt_bodyid[j + 1] - 1 == mdl.jnt_body[j]
        np.testing.assert_allclose(m.jnt_axis[j + 1], mdl.jnt_axis[j], atol=1e-12)
        np.testing.assert_allclose(m.jnt_range[j + 1], mdl.jnt_range[j], atol=1e-12)
        assert m.jnt_dofadr[j + 1] == mdl.jnt_dof[j]
    for a in range(8):
        assert m.jnt_dofadr[m.actuator_trnid[a][0]] == mdl.act_dof[a]
    np.testing.assert_array_equal(m.dof_armature, mdl.armature)
    np.testing.assert_array_equal(m.dof_damping, mdl.damping)
    np.testing.assert_allclose(tcon._body_invweight(mdl), m.body_invweight0[1:14, 0],
                               atol=1e-12)
    np.testing.assert_allclose(tcon._dof_invweight(mdl), m.dof_invweight0, atol=1e-12)


def test_smooth_dynamics_match_mujoco(oracle):
    """FK, CoM Jacobians, mass matrix, bias and qacc_smooth at f64 on
    contact-free poses, to machine precision."""
    mujoco, m, mdl = oracle
    d = mujoco.MjData(m)
    rng = np.random.default_rng(7)
    n = 3
    qpos = np.tile(m.qpos0, (n, 1))
    qpos[:, :3] = rng.uniform(-1, 1, (n, 3)) + [0, 0, 3.0]
    quat = rng.normal(size=(n, 4))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] = rng.uniform(-0.5, 0.5, (n, 8))
    qvel, ctrl = rng.normal(size=(n, 14)), rng.uniform(-1, 1, (n, 8))
    kin, M, qacc, _ = tdyn.smooth_forward(mdl, _t(qpos), _t(qvel), _t(ctrl))
    bias = tdyn.bias_force(mdl, kin, _t(qvel))
    for i in range(n):
        d.qpos[:], d.qvel[:], d.ctrl[:] = qpos[i], qvel[i], ctrl[i]
        mujoco.mj_forward(m, d)
        assert d.ncon == 0
        np.testing.assert_allclose(kin.xpos[i].numpy(), d.xpos[1:14], atol=1e-12)
        for b in range(13):
            jacp, jacr = np.zeros((3, 14)), np.zeros((3, 14))
            mujoco.mj_jacBodyCom(m, d, jacp, jacr, b + 1)
            np.testing.assert_allclose(kin.jp[i, b].numpy().T, jacp, atol=1e-12)
            np.testing.assert_allclose(kin.jr[i, b].numpy().T, jacr, atol=1e-12)
        mfull = np.zeros((14, 14))
        mujoco.mj_fullM(m, d, mfull)
        np.testing.assert_allclose(M[i].numpy(), mfull, atol=1e-12)
        np.testing.assert_allclose(bias[i].numpy(), d.qfrc_bias, atol=1e-11)
        np.testing.assert_allclose(qacc[i].numpy(), d.qacc_smooth, atol=1e-10)


@pytest.mark.parametrize("xy", [(0.0, 0.0), (4.4, 0.0), (4.4, 4.4)],
                         ids=["floor", "wall", "corner"])
def test_qacc_matches_mujoco(oracle, xy):
    """The constrained forward (15 Newton iterations) reproduces MuJoCo's
    qacc at a floor and at wall contact states, and the active rows match
    efc_J / efc_aref / efc_R."""
    from scipy.optimize import linear_sum_assignment

    mujoco, m, mdl = oracle
    d = mujoco.MjData(m)
    qpos = STAND.copy()
    qpos[:2] = xy
    d.qpos[:] = qpos
    d.qvel[:] = 0.1 * np.arange(14)
    d.ctrl[:] = 0.3
    mujoco.mj_forward(m, d)
    args = [_t(x)[None] for x in (d.qpos, d.qvel, d.ctrl)]
    qacc, _ = teng.forward(mdl, *args, iters=15)
    np.testing.assert_allclose(qacc[0].numpy(), d.qacc, atol=1e-8)
    kin, *_ = tdyn.smooth_forward(mdl, *args)
    rows = tcon.constraint_rows(mdl, kin, args[0], args[1])
    act = rows.active[0].numpy().astype(bool)
    assert act.sum() == d.nefc
    my_j = rows.jac[0].numpy()[act]
    mj_j = d.efc_J.reshape(d.nefc, 14)
    ri, ci = linear_sum_assignment(np.abs(my_j[None] - mj_j[:, None]).max(-1))
    np.testing.assert_allclose(my_j[ci], mj_j[ri], atol=1e-10)
    np.testing.assert_allclose(rows.aref[0].numpy()[act][ci], d.efc_aref[:d.nefc][ri],
                               atol=1e-9)
    np.testing.assert_allclose(rows.r[0].numpy()[act][ci], d.efc_R[:d.nefc][ri],
                               atol=1e-12)


def test_rk4_trajectory_matches_mujoco(oracle):
    """20 RK4 steps of contact-rich random flailing track mj_step to 1e-6
    (the JAX package's test, which it marks slow for its compile)."""
    mujoco, m, mdl = oracle
    d = mujoco.MjData(m)
    d.qpos[:] = STAND
    ctrls = np.random.default_rng(5).uniform(-1, 1, (20, 8))
    state = teng.init_state(mdl, _t(STAND)[None], torch.zeros(1, 14,
                                                             dtype=torch.float64))
    for t in range(20):
        d.ctrl[:] = ctrls[t]
        mujoco.mj_step(m, d)
        state = teng.rk4_step(mdl, state, _t(ctrls[t])[None], iters=15)
    np.testing.assert_allclose(state.qpos[0].numpy(), d.qpos, atol=1e-6)
    np.testing.assert_allclose(state.qvel[0].numpy(), d.qvel, atol=1e-5)
