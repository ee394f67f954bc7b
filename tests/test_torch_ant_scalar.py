"""The port's ``pipeline="scalar"`` ant forward on the CPU against the JAX
package's scalar pipeline, at float64.

On the card ``pipeline="scalar"`` runs the per-env kernels of
``gym_po_tpu_torch.ops.ant_forward`` (held to their plain twins by
``test_torch_cuda.py``); on the CPU it runs those twins, the port's batched
engine.  Here that plain path is held against the JAX package's scalar
functions (``smooth_forward``, ``constraint_rows``, ``engine.forward`` and
``engine.step`` with ``pipeline="scalar"``) on the tag and heaven-hell
arenas, with the ant on the floor, against a wall, in a corner and in a
random low pose.

The JAX scalar code is per-env Python over shape-() values.  Eager JAX
runs ``smooth_forward`` and ``constraint_rows`` in seconds a state, and
those run eagerly here; ``engine.forward`` compiles its Newton loop (150 s
a tag state) or, with jit disabled, dispatches some 600k ops (50 s).  So
the 8-iteration forward and the Euler step run that same JAX source with
NumPy as its array module (:func:`numpy_jax`: ``jnp`` → ``numpy``, the
``lax`` loops → Python loops), and one test holds that NumPy run to eager
JAX on a forward of 2 iterations, which runs every line of the scalar
Newton solve.

Also: the kernels' packed model read back by ``unpack_model``, and their
static support tables equal to the entries the JAX scalar pipeline does not
drop as Python zeros.
"""

import contextlib
import dataclasses
import types

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
from gym_po_tpu_torch.ops import ant_forward as taf
from gym_po_tpu_torch.physics import ant_model as tam
from gym_po_tpu_torch.physics import contact as tcon
from gym_po_tpu_torch.physics import dynamics as tdyn
from gym_po_tpu_torch.physics import engine as teng

from test_torch_physics import STAND, WALLS, one_thread  # noqa: F401

N_STATES = 4
ITERS = 8
# (torso x, y) per arena: floor, against a wall, in a corner, random low pose
PLACES = {"tag": [(0.3, -1.2), (4.4, 0.5), (4.4, -4.4), (-2.0, 1.0)],
          "hh": [(0.0, 5.5), (-7.6, 6.0), (7.6, 7.6), (0.5, 0.2)]}


def states(walls: str):
    """numpy f64 (qpos, qvel, ctrl, warm) of the ``PLACES`` poses: standing
    poses perturbed (height, tilt, hinges), the last any orientation low
    over the floor; random velocities, controls and warm starts."""
    rng = np.random.default_rng(17 if walls == "tag" else 23)
    n = N_STATES
    qpos = np.tile(STAND, (n, 1))
    qpos[:, :2] = PLACES[walls]
    qpos[:, 2] += rng.uniform(-0.1, 0.05, n)
    qpos[:, 3:7] += rng.normal(scale=0.05, size=(n, 4))
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, 8))
    qpos[-1, 2] = rng.uniform(0.15, 0.4)
    qpos[-1, 3:7] = rng.normal(size=4)
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    return (qpos, 0.5 * rng.normal(size=(n, 14)), rng.uniform(-1, 1, (n, 8)),
            0.1 * rng.normal(size=(n, 14)))


def _models(walls):
    name = WALLS[walls]
    return (jam.make_ant_model(getattr(jam, name)),
            tam.make_ant_model(getattr(tam, name)))


def _fori_loop(lo, hi, body, init):
    x = init
    for i in range(lo, hi):
        x = body(i, x)
    return x


def _scan(f, init, xs, length=None, unroll=1):
    carry = init
    n = length if xs is None else len(jax.tree_util.tree_leaves(xs)[0])
    for i in range(n):
        x = None if xs is None else jax.tree_util.tree_map(lambda a: a[i], xs)
        carry, _ = f(carry, x)
    return carry, ()


@contextlib.contextmanager
def numpy_jax():
    """Run the JAX package's physics source with NumPy as its array module:
    its modules' ``jnp`` bound to ``numpy`` and ``jax.lax``'s loops to
    Python loops, restored on exit.  (NumPy's float64 scalars subclass
    ``float``, so ``_is0`` also drops an exact traced zero there: a zero
    term, the same sum.)"""
    fake_jax = types.SimpleNamespace(
        lax=types.SimpleNamespace(fori_loop=_fori_loop, scan=_scan))
    mods = (jcon, jdyn, jeng, jlin, jsp)
    saved = [(m, m.jnp, getattr(m, "jax", None)) for m in mods]
    try:
        for m in mods:
            m.jnp = np
            if hasattr(m, "jax"):
                m.jax = fake_jax
        yield
    finally:
        for m, j, x in saved:
            m.jnp = j
            if x is not None:
                m.jax = x


def _scalar_rows(jm, qpos, qvel):
    s = jdyn.kinematics_s(jm, qpos)
    return jcon.constraint_rows_scalar(jm, s, qpos, qvel)


def _stack_rows(rows):
    nv = len(rows[0]["j"])
    return (np.array([[float(r["j"][d]) for d in range(nv)] for r in rows]),
            np.array([float(r["aref"]) for r in rows]),
            np.array([float(r["r"]) for r in rows]),
            np.array([float(r["active"]) for r in rows]))


@pytest.fixture(scope="module")
def jax_ref():
    """Per arena: eager JAX's scalar smooth dynamics and rows of two
    states (and the rows' and the mass matrix's Python-zero structure of
    the first); the NumPy run of the forward (8 iterations, from the warm
    start) and of one Euler step (frame_skip 2, 8 iterations) of all four;
    eager JAX's and the NumPy run's forward at 2 iterations of the first."""
    out = {}
    for walls in WALLS:
        jm, _ = _models(walls)
        qpos, qvel, ctrl, warm = states(walls)
        ref = {"states": (qpos, qvel, ctrl, warm)}
        with jax.enable_x64(True):
            smooth, rows = [], []
            for i in range(2):
                q, v, c = (jnp.asarray(x[i]) for x in (qpos, qvel, ctrl))
                _, M, qa, _ = jdyn.smooth_forward(jm, q, v, c)
                smooth.append((np.asarray(M), np.asarray(qa)))
                r = jcon.constraint_rows(jm, jdyn.kinematics(jm, q), q, v)
                rows.append(tuple(np.asarray(x) for x in (r.jac, r.aref, r.r,
                                                          r.active)))
                if i == 0:
                    s = jdyn.kinematics_s(jm, q)
                    ref["row_support"] = [
                        [d for d in range(jm.nv) if not jdyn._is0(row["j"][d])]
                        for row in jcon.constraint_rows_scalar(jm, s, q, v)]
                    M_s = jdyn.mass_matrix_s(jm, s)
                    ref["mass_support"] = np.array(
                        [[not jdyn._is0(x) for x in row] for row in M_s])
                    # each body's own terms: mass_matrix_s of the model with
                    # that body's dofs alone and no armature
                    ref["mass_bodies"] = []
                    for b in range(jm.nb):
                        mask = np.zeros_like(np.asarray(jm.dof_mask))
                        mask[b] = np.asarray(jm.dof_mask)[b]
                        jm_b = dataclasses.replace(
                            jm, dof_mask=mask,
                            armature=np.zeros_like(np.asarray(jm.armature)))
                        ref["mass_bodies"].append(np.array(
                            [[not jdyn._is0(x) for x in row]
                             for row in jdyn.mass_matrix_s(jm_b, s)]))
            ref["smooth"], ref["rows"] = smooth, rows
            with jax.disable_jit():
                ref["forward2"] = tuple(np.asarray(x) for x in jeng.forward(
                    jm, *(jnp.asarray(x[0]) for x in (qpos, qvel, ctrl, warm)),
                    iters=2, pipeline="scalar"))
        with numpy_jax():
            ref["numpy_forward2"] = jeng.forward(
                jm, qpos[0], qvel[0], ctrl[0], warm[0], iters=2,
                pipeline="scalar")
            ref["numpy_rows"] = _stack_rows(_scalar_rows(jm, qpos[0], qvel[0]))
            ref["forward"] = [jeng.forward(jm, qpos[i], qvel[i], ctrl[i],
                                           warm[i], iters=ITERS,
                                           pipeline="scalar")
                              for i in range(N_STATES)]
            ref["euler"] = [tuple(jeng.step(
                jm, jeng.PhysicsState(qpos[i], qvel[i], warm[i]), ctrl[i],
                frame_skip=2, iters=ITERS, integrator="euler",
                pipeline="scalar")) for i in range(N_STATES)]
        out[walls] = ref
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("walls", list(WALLS))
def test_numpy_run_equals_eager_jax(jax_ref, walls):
    """The NumPy run of the JAX scalar source equals eager JAX: a forward of
    2 Newton iterations (smooth dynamics, rows, the solve) and the rows."""
    ref = jax_ref[walls]
    for g, w in zip(ref["numpy_forward2"], ref["forward2"]):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    jac, aref, r, active = ref["rows"][0]
    got = ref["numpy_rows"]
    np.testing.assert_allclose(got[0], jac, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got[1], aref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[2], r, rtol=1e-13, atol=0)
    np.testing.assert_array_equal(got[3], active)


@pytest.mark.parametrize("walls", list(WALLS))
def test_smooth_matches_jax_scalar(jax_ref, walls):
    ref = jax_ref[walls]
    qpos, qvel, ctrl, _ = ref["states"]
    _, tm = _models(walls)
    _, M, qa, _ = tdyn.smooth_forward(tm, _t(qpos), _t(qvel), _t(ctrl))
    for i, (M_j, qa_j) in enumerate(ref["smooth"]):
        np.testing.assert_allclose(M[i].numpy(), M_j, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(qa[i].numpy(), qa_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("walls", list(WALLS))
def test_rows_match_jax_scalar(jax_ref, walls):
    ref = jax_ref[walls]
    qpos, qvel, ctrl, _ = ref["states"]
    _, tm = _models(walls)
    kin, *_ = tdyn.smooth_forward(tm, _t(qpos), _t(qvel), _t(ctrl))
    rows = tcon.constraint_rows(tm, kin, _t(qpos), _t(qvel))
    for i, (jac, aref, r, active) in enumerate(ref["rows"]):
        np.testing.assert_allclose(rows.jac[i].numpy(), jac, rtol=0, atol=1e-10)
        np.testing.assert_allclose(rows.aref[i].numpy(), aref, rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(rows.r[i].numpy(), r, rtol=1e-10, atol=0)
        np.testing.assert_array_equal(rows.active[i].numpy(), active)
    # the walls and the floor engage rows in these states
    assert ref["rows"][0][3][8:].sum() > 0 and ref["rows"][1][3][8:].sum() > 0


@pytest.mark.parametrize("walls", list(WALLS))
def test_forward_matches_jax_scalar(jax_ref, walls):
    """``engine.forward(pipeline="scalar")``, 8 iterations from the warm
    start: qacc and the warm start out to 1e-8 relative."""
    ref = jax_ref[walls]
    qpos, qvel, ctrl, warm = ref["states"]
    _, tm = _models(walls)
    qacc, w = teng.forward(tm, *map(_t, (qpos, qvel, ctrl, warm)),
                           iters=ITERS, pipeline="scalar")
    want = np.stack([np.asarray(f[0]) for f in ref["forward"]])
    want_w = np.stack([np.asarray(f[1]) for f in ref["forward"]])
    np.testing.assert_allclose(qacc.numpy(), want, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(w.numpy(), want_w, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("walls", list(WALLS))
def test_euler_step_matches_jax_scalar(jax_ref, walls):
    """One Euler ``step`` at frame_skip 2, 8 iterations: qpos, qvel and the
    warm start to 1e-8."""
    ref = jax_ref[walls]
    qpos, qvel, ctrl, warm = ref["states"]
    _, tm = _models(walls)
    got = teng.step(tm, teng.PhysicsState.from_numpy(qpos, qvel, warm, "cpu"),
                    _t(ctrl), frame_skip=2, iters=ITERS, integrator="euler",
                    pipeline="scalar")
    for k, name in enumerate(("qpos", "qvel", "warm")):
        want = np.stack([np.asarray(s[k]) for s in ref["euler"]])
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-8, atol=1e-8,
                                   err_msg=name)


@pytest.mark.parametrize("walls", list(WALLS))
def test_packed_model_reads_back(walls):
    _, tm = _models(walls)
    buf = taf.pack_model(tm)
    slots = tcon._wall_slots(tm.walls)
    got = taf.unpack_model(buf, len(slots))
    for name, _ in taf.MODEL_FIELDS:
        want = {"body_invweight": tcon._body_invweight(tm),
                "dof_invweight": tcon._dof_invweight(tm)}.get(name)
        want = getattr(tm, name) if want is None else want
        np.testing.assert_array_equal(got[name], np.asarray(want), err_msg=name)
        assert got[name].dtype.kind == np.asarray(want).dtype.kind, name
    d0, dmax, width, mid, power = tm.solimp
    k, b = tcon._kb(tm)
    sc = got["scalars"]
    assert (sc["gear"], sc["gravity"], sc["margin2"], sc["mu"]) == (
        tm.gear, tm.gravity, 2 * tm.margin, tm.friction)
    assert (sc["k_stiff"], sc["b_damp"], sc["d0"], sc["width"], sc["mid"],
            sc["power"]) == (k, b, d0, width, mid, power)
    assert sc["dspan"] == dmax - d0
    for (bpos, bneg, ax), (lo_p, hi_p, lo_n, hi_n, axis) in zip(slots,
                                                                got["slots"]):
        assert (lo_p, hi_p) == bpos
        assert (lo_n, hi_n) == (bpos if bneg is None else bneg)
        assert axis == (0 if ax is None else ax)
    with pytest.raises(ValueError):
        taf.unpack_model(buf[:-1], len(slots))


@pytest.mark.parametrize("walls", list(WALLS))
def test_support_tables_match_jax_structure(jax_ref, walls):
    """The kernels' static supports are the JAX scalar pipeline's
    non-Python-zero entries: each row's (found eagerly from
    ``constraint_rows_scalar``) and the mass matrix's (``mass_matrix_s``);
    the table lays them out as CSR, each row ascending."""
    ref = jax_ref[walls]
    _, tm = _models(walls)
    assert taf.row_supports(tm) == ref["row_support"]
    np.testing.assert_array_equal(taf.mass_support(tm), ref["mass_support"])
    tab = taf.tables(tm)
    rows = taf.row_supports(tm)
    ne, nnz = len(rows), sum(map(len, rows))
    assert ne == 8 + 4 * (25 + 37 * len(tcon._wall_slots(tm.walls)))
    assert tab[0] == 0 and tab[ne] == nnz and len(tab) == ne + 1 + nnz + 14
    for i, r in enumerate(rows):
        assert list(tab[ne + 1 + tab[i]:ne + 1 + tab[i + 1]]) == r
        assert r == sorted(r) and len(r) <= 9
    S = taf.mass_support(tm)
    for d in range(14):
        assert tab[ne + 1 + nnz + d] == sum(1 << e for e in range(14) if S[d, e])


def _smooth_fields(tm) -> dict:
    tab, out, at = taf.smooth_table(tm), {}, 0
    for name, n in taf.SMOOTH_FIELDS:
        out[name] = [int(x) for x in tab[at:at + n]]
        at += n
    assert at == len(tab) and tab.dtype == np.int32
    return out


def _bits(x) -> set:
    return {b for b in range(32) if (x >> b) & 1}


@pytest.mark.parametrize("walls", list(WALLS))
def test_smooth_table_matches_jax_model(jax_ref, walls):
    """``ant_smooth``'s tree table against the JAX model and
    ``mass_matrix_s``: every body's parent in the level before (the root
    alone at level 0), each body's hinge and its qpos index, each dof's
    anchor body (``bias_force_s``), hinge, bodies (``_active_dofs``) and
    actuator (``actuation_s``), the (body, rotation dof) pairs body after
    body; and each packed entry's bodies exactly those that add a term to
    it in ``mass_matrix_s`` (found eagerly, a body at a time), the entries
    with none exactly ``mass_support``'s zeros."""
    jm, tm = _models(walls)
    f = _smooth_fields(tm)
    nb, nv = jm.nb, jm.nv
    parent = [int(x) for x in np.asarray(jm.parent)]
    level = f["level"]
    assert parent[0] == -1 and level[0] == 0 and f["n_levels"] == [4]
    assert f["parent"] == parent
    for b in range(1, nb):
        assert level[b] == level[parent[b]] + 1 and level[b] < f["n_levels"][0]
    assert sorted(level) == [0] + [1] * 4 + [2] * 4 + [3] * 4
    assert f["body_jnt"] == [int(x) for x in np.asarray(jm.body_jnt)]
    assert f["body_qpos"] == [int(jm.jnt_qpos[j]) if j >= 0 else -1
                              for j in np.asarray(jm.body_jnt)]
    active = [jdyn._active_dofs(jm, b) for b in range(nb)]
    assert [_bits(x) for x in f["body_dofs"]] == [set(a) for a in active]
    pairs = [(b, d) for b in range(nb) for d in active[b] if d >= 3]
    assert [(x >> 8, x & 255) for x in f["pairs"] if x >= 0] == pairs
    assert f["pairs"][len(pairs):] == [-1] * (taf.NPAIR - len(pairs))
    assert f["pair_base"] == [pairs.index((b, active[b][3]))
                              if len(active[b]) > 3 else None for b in range(nb)]
    anchor = [0] * nv
    for j in range(len(jm.jnt_dof)):
        anchor[int(jm.jnt_dof[j])] = int(jm.jnt_body[j])
        assert f["dof_jnt"][int(jm.jnt_dof[j])] == j
    assert f["dof_anchor"] == anchor and f["dof_jnt"][:6] == [-1] * 6
    assert [_bits(x) for x in f["dof_bodies"]] == [
        {b for b in range(nb) if d in active[b]} for d in range(nv)]
    ctrl = (np.arange(len(jm.act_dof)) + 1) / 10
    tau = jdyn.actuation_s(jm, ctrl)
    assert f["dof_act"] == [-1 if jdyn._is0(t) else
                            int(round(float(t) / jm.gear * 10)) - 1 for t in tau]
    ref = jax_ref[walls]
    packed = [(i, k) for k in range(nv) for i in range(k, nv)]
    entries = [(x & 255, (x >> 8) & 255, x >> 16) for x in f["m_entry"]]
    assert sorted(t for t, _, _ in entries) == list(range(taf.NL))
    counts = [len(_bits(x)) for x in f["m_bodies"]]
    assert counts == sorted(counts, reverse=True)
    for (t, i, k), bodies in zip(entries, f["m_bodies"]):
        assert packed[t] == (i, k)
        want = {b for b in range(nb) if ref["mass_bodies"][b][i, k]}
        assert _bits(bodies) == want, (i, k)
        assert i == k or bool(want) == bool(ref["mass_support"][i, k])


@pytest.mark.parametrize("walls", list(WALLS))
def test_kernel_layouts_on_the_cpu(walls):
    """The wrappers on CPU tensors (the kernels' twins in the kernels'
    layouts): the chain equals ``engine.forward``; the rows densified
    through the support table equal the engine's rows, every entry off
    the support zero; each wrapper checks its shapes."""
    qpos, qvel, ctrl, warm = map(_t, states(walls))
    _, tm = _models(walls)
    sm = taf.ant_smooth(tm, qpos, qvel, ctrl)
    kin, M, qa, _ = tdyn.smooth_forward(tm, qpos, qvel, ctrl)
    assert torch.equal(taf._batch_mass(sm.M), M)
    assert torch.equal(sm.qacc_smooth.T, qa)
    rows = taf.ant_rows(tm, sm.skin, qpos, qvel)
    want = tcon.constraint_rows(tm, kin, qpos, qvel)
    dense = taf.dense_rows(tm, rows)
    for name in ("jac_t", "aref", "r", "active"):
        assert torch.equal(getattr(dense, name), getattr(want, name)), name
    got = taf.ant_newton(tm, sm, rows, warm, iters=ITERS)
    eng = teng.forward(tm, qpos, qvel, ctrl, warm, iters=ITERS, pipeline="array")
    for g, w in zip(got, eng):
        assert torch.equal(g, w)
    for g, w in zip(taf.forward(tm, qpos, qvel, ctrl, warm, iters=ITERS), eng):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        taf.ant_rows(tm, sm.skin[:-1], qpos, qvel)
    with pytest.raises(ValueError):
        taf.ant_smooth(tm, qpos.float(), qvel, ctrl)


_UNIT_CANDIDATES = {taf.U_FLOOR_TORSO: 1, taf.U_FLOOR_END: 1,
                    taf.U_WALL_TORSO: 1, taf.U_WALL_CAPSULE: 3}


@pytest.mark.parametrize("walls", list(WALLS))
def test_rows_units_cover_the_jax_candidates(walls):
    """``ant_rows``' unit table: the 8 limit rows, then units that cover
    every candidate of the row table exactly once, in the JAX candidate
    order, each with the body, geom and wall slot that
    ``contact_candidates_s`` builds it from: a unit's geom (and capsule
    end) placed by the JAX kinematics lands on the JAX candidate's sphere
    centre or capsule segment, its body is the JAX one (whose invweight
    the candidate carries), its hinges the body's."""
    jm, tm = _models(walls)
    u = taf.units(tm)
    F = {f: i for i, f in enumerate(taf.UNIT_FIELDS)}
    nc = (len(taf.row_supports(tm)) - taf.NJ) // 4
    assert (u[:taf.NJ, F["kind"]] == taf.U_LIMIT).all()
    assert list(u[:taf.NJ, F["index"]]) == list(range(taf.NJ))
    covered = [c for x in u[taf.NJ:] for c in range(
        x[F["index"]], x[F["index"]] + _UNIT_CANDIDATES[x[F["kind"]]])]
    assert covered == list(range(nc))
    qpos = states(walls)[0][0]
    with numpy_jax():
        s = jdyn.kinematics_s(jm, qpos)
        spheres = jcon._sphere_centers_s(jm, s)
        capsules = jcon._capsules_s(jm, s)
        slots = jcon._wall_slots(jm.walls)
        cands = jcon.contact_candidates_s(jm, s)
    assert len(cands) == nc
    # each JAX candidate: (body, wall slot, the sphere centre or segment)
    want = [(b, -1, np.array(c)) for c, b, _, _, _ in spheres]
    for k in range(len(slots)):
        want.append((spheres[0][1], k, np.array(spheres[0][0])))
        for p0, p1, _, b in capsules:
            want += [(b, k, np.array([p0, p1]))] * 3
    inv0 = jcon._body_invweight(jm)
    for x in u[taf.NJ:]:
        kind, g, b = x[F["kind"]], x[F["geom"]], x[F["body"]]
        R = np.array(s.xmat[b], np.float64).reshape(3, 3)
        center = np.array(s.xpos[b]) + R @ np.asarray(jm.geom_pos[g])
        half = jm.geom_h[g] * (R @ np.asarray(jm.geom_axis[g]))
        if kind == taf.U_FLOOR_END:
            point = center + (half if x[F["end"]] else -half)
        elif kind == taf.U_WALL_CAPSULE:
            point = np.array([center - half, center + half])
        else:
            point = center
        assert b == int(jm.geom_body[g])
        assert [h for h in x[[F["hinge0"], F["hinge1"]]] if h >= 0] == [
            d for d, _ in jcon._hinges_of_body(jm, b)]
        for c in range(x[F["index"]], x[F["index"]] + _UNIT_CANDIDATES[kind]):
            wb, wk, wp = want[c]
            assert (b, x[F["slot"]]) == (wb, wk), c
            np.testing.assert_allclose(point, wp, rtol=0, atol=1e-12)
            assert cands[c]["invweight"] == float(inv0[b])


@pytest.mark.parametrize("walls", list(WALLS))
def test_newton_twin_every_row_active_matches_jax(walls):
    """``newton_twin`` on rows whose active flags are all 1 (every env
    solves over all ne rows, what the card test hands ``ant_newton``)
    against the JAX package's ``solve_constraints_newton`` at f64 on the
    same M, qacc_smooth, rows and warm start: 8 iterations, 10 bisections,
    qacc to 1e-9."""
    jm, tm = _models(walls)
    qpos, qvel, ctrl, warm = map(_t, states(walls))
    sm = taf.ant_smooth(tm, qpos, qvel, ctrl)
    rows = taf.ant_rows(tm, sm.skin, qpos, qvel)
    rows = rows._replace(active=torch.ones_like(rows.active))
    got, _ = taf.newton_twin(tm, sm, rows, warm, iters=ITERS)
    dense = taf.dense_rows(tm, rows)
    M = taf._batch_mass(sm.M)
    qs = sm.qacc_smooth.T
    with jax.enable_x64(True):
        solve = jax.jit(jax.vmap(lambda m, a, jt, ar, r, act, q0: jcon.solve_constraints_newton(
            jm, m, a, jcon.ConstraintRows(jt, ar, r, act), iters=ITERS,
            ls_iters=10, qacc0=q0)[0]))
        want = np.asarray(solve(*(jnp.asarray(x.numpy()) for x in (
            M, qs, dense.jac_t, dense.aref, dense.r, dense.active, qs + warm))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


def test_launches_under_capture_count_at_replay(monkeypatch):
    """A launch under CUDA-graph capture is set aside, not counted, and
    each replay of the graph counts what it recorded."""
    from gym_po_tpu_torch.ops import _build

    def run():
        pass

    run.launches = 0
    _build.take_captured()
    n0 = _build.LAUNCHES["probe"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    _build.count_launch(run, "probe")
    _build.count_launch(run, "probe")
    assert run.launches == 0 and _build.LAUNCHES["probe"] == n0
    captured = _build.take_captured()
    assert captured == {(run, "probe"): 2} and not _build.take_captured()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    _build.count_launch(run, "probe")
    for _ in range(3):
        _build.count_replay(captured)
    assert run.launches == 7 and _build.LAUNCHES["probe"] == n0 + 7
    _build.LAUNCHES.pop("probe", None)
