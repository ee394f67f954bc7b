"""Collision detection + soft-constraint solvers (MuJoCo's model), PyTorch
port of :mod:`gym_po_tpu.physics.contact`, its array pipeline
(``constraint_rows_array``, ``solve_constraints_newton``).

* **Candidates** (static shapes, no dynamic contact lists), every one a
  row set whether engaged or not:
  - floor: the torso sphere + both end spheres of each leg capsule vs the
    z = 0 plane, 25 candidates;
  - walls: per wall slot (mirror wall pairs fold into one slot,
    :func:`_wall_slots`) the torso sphere vs the box and MuJoCo's
    capsule-box collider, 3 slots per capsule (:func:`_capsule_box_slots`:
    the start and the end of the segment↔box distance's minimizing set, by
    a 10-step bisection each and a closed-form refinement, and when they
    coincide the deepest other end sphere).  All slots and capsules are
    computed at once over ``[B, slots, capsules]`` tensors.
* **Rows**: a candidate with ``dist ≥ margin`` is masked (force pinned to
  0), MuJoCo's inclusion rule; invalid capsule slots carry the ``1e9``
  sentinel distance.  Per row the solimp impedance d(pos), ``aref = -B·vel
  - K·d·(pos - margin)`` and ``R = (1-d)/d · diagApprox``; 8 joint-limit
  rows, then 4 pyramid rows per candidate (+t1, −t1, +t2, −t2).
* **Solvers**: the primal Newton :func:`solve_constraints_newton` (the
  engine's), fixed iterations and a fixed-step bisection line search, no
  data-dependent exit; the APGD dual :func:`solve_constraints` (tests).

The ``where``-selected branches compute both sides, as the JAX code does: a
discarded side may hold inf or NaN (a zero denominator), and the selected
values are the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ant_model import AntModel
from .dynamics import Kinematics, model_tensors, point_jacobian
from .linalg import chol_solve
from .spatial import cross

__all__ = ["constraint_rows", "solve_constraints", "solve_constraints_newton",
           "ConstraintRows"]

_MINIMP, _MAXIMP = 1e-4, 0.9999
BIG = 1e9  # the distance of a candidate slot that holds no contact


class ConstraintRows(NamedTuple):
    jac_t: torch.Tensor   # [B, nv, ne] (transposed: dof-major, row-minor)
    aref: torch.Tensor    # [B, ne]
    r: torch.Tensor       # [B, ne] regularizer
    active: torch.Tensor  # [B, ne] {0,1}

    @property
    def jac(self) -> torch.Tensor:
        """[B, ne, nv] row-major view."""
        return self.jac_t.mT


def _impedance(model: AntModel, violation: torch.Tensor) -> torch.Tensor:
    """MuJoCo solimp sigmoid d(x); ``violation`` = pos - margin (≤ 0 when
    the constraint is engaged deeper)."""
    d0, dmax, width, mid, power = model.solimp
    x = torch.clamp(torch.abs(violation) / width, 0.0, 1.0)
    a = 1.0 / mid ** (power - 1.0)
    b = 1.0 / (1.0 - mid) ** (power - 1.0)
    y = torch.where(x <= mid, a * x**power, 1.0 - b * (1.0 - x) ** power)
    return torch.clamp(d0 + y * (dmax - d0), _MINIMP, _MAXIMP)


def _kb(model: AntModel):
    dmax = model.solimp[1]
    tc = max(model.solref[0], 2.0 * model.dt)
    dr = model.solref[1]
    k = 1.0 / (dmax * dmax * tc * tc * dr * dr)
    b = 2.0 / (dmax * tc)
    return k, b


# ---------------------------------------------------------------------------
# candidate geometry, over [..., 3] tensors
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _make_frame(n: torch.Tensor):
    """MuJoCo ``mju_makeFrame``: t = ŷ if |n_y| < 0.5 else ẑ,
    orthogonalised against the unit normal ``n [..., 3]``."""
    ny_small = torch.abs(n[..., 1]) < 0.5
    t = torch.stack([torch.zeros_like(n[..., 0]),
                     torch.where(ny_small, 1.0, 0.0).to(n.dtype),
                     torch.where(ny_small, 0.0, 1.0).to(n.dtype)], -1)
    t1 = t - _dot(n, t)[..., None] * n
    t1 = t1 * (1.0 / torch.sqrt(_dot(t1, t1)))[..., None]
    return t1, cross(n, t1)


def _capsule_floor_frame(axis_w: torch.Tensor):
    """MuJoCo plane-capsule tangents for the z = 0 floor: t1 =
    -normalize(axis projected onto the plane), (0, 1, 0) when the axis is
    ⟂ to the plane; t2 = ẑ × t1."""
    px, py = axis_w[..., 0], axis_w[..., 1]
    nrm = torch.sqrt(px * px + py * py)
    ok = nrm > 1e-8
    inv = -1.0 / torch.where(ok, nrm, 1.0)
    t1x = torch.where(ok, px * inv, 0.0)
    t1y = torch.where(ok, py * inv, 1.0)
    z = torch.zeros_like(t1x)
    return torch.stack([t1x, t1y, z], -1), torch.stack([-t1y, t1x, z], -1)


def _sphere_box(c: torch.Tensor, r, lo: torch.Tensor, hi: torch.Tensor,
                face_n: torch.Tensor):
    """Spheres (centres ``c [..., 3]``, radii ``r``) vs AABBs [lo, hi]
    (``face_n`` [6, 3]: the faces' outward normals in that order),
    MuJoCo's ``mjc_SphereBox``: outside the box the closest-point formula;
    with the centre inside, the nearest face (normal = that face's outward
    axis, depth = face depth + r, the first of equal depths in the order
    +x, -x, +y, -y, +z, -z).  Returns (dist, n, pos, outside); ``n``
    points from the box toward the sphere."""
    cp = torch.minimum(torch.maximum(c, lo), hi)
    delta = c - cp
    dn = torch.sqrt(_dot(delta, delta))
    outside = dn > 1e-12
    inv = 1.0 / torch.where(outside, dn, 1.0)
    depth = torch.stack([hi[..., 0] - c[..., 0], c[..., 0] - lo[..., 0],
                         hi[..., 1] - c[..., 1], c[..., 1] - lo[..., 1],
                         hi[..., 2] - c[..., 2], c[..., 2] - lo[..., 2]], -1)
    best_d = depth[..., 0]
    best_k = torch.zeros_like(best_d, dtype=torch.long)
    for k in range(1, 6):
        better = depth[..., k] < best_d
        best_k = torch.where(better, k, best_k)
        best_d = torch.where(better, depth[..., k], best_d)
    best_n = face_n[best_k]
    dist = torch.where(outside, dn - r, -(best_d + r))
    n = torch.where(outside[..., None], delta * inv[..., None], best_n)
    pos = c - (r + 0.5 * dist)[..., None] * n
    return dist, n, pos, outside


def _capsule_box_slots(p0: torch.Tensor, p1: torch.Tensor, r, lo: torch.Tensor,
                       hi: torch.Tensor, face_n: torch.Tensor,
                       bisect_iters: int = 10):
    """Capsule segments (p0→p1 [..., 3], radius r) vs AABBs — MuJoCo's
    ``mjc_CapsuleBox`` behavior as the JAX package reverse-engineered it
    (``gym_po_tpu.physics.contact._capsule_box_slots_s``).

    The squared point-box distance f(t) along the segment is convex; its
    minimizing set is a point or a flat interval:

    * slot 1, the *start* of the set (bisection on f′ with the predicate
      ``f′ ≥ 0``, snapped to 0 when ``f′(0) ≥ 0`` and to 1 when
      ``f′(1) < 0``), overridden by an end whose centre lies inside the
      box;
    * slot 2, the *end* of the set (predicate ``f′ > 0``), masked when it
      coincides with slot 1 or lies inside the box;
    * slot 3, only when slots 1 and 2 coincide: the deepest end sphere not
      at slot 1's point, outside the box.

    Both bisections run together (a trailing axis of 2) and are refined to
    the exact minimizer by the closed-form solve over the active residual
    pattern.  Returns three (dist, n, pos, valid) tuples."""
    u = p1 - p0

    def at(t):  # t [..., k] → points [..., k, 3]
        return p0[..., None, :] + t[..., None] * u[..., None, :]

    lo_k, hi_k, p0_k, u_k = (x[..., None, :] for x in (lo, hi, p0, u))

    def resid(pt):
        return torch.clamp_min(pt - hi_k, 0.0) + torch.clamp_max(pt - lo_k, 0.0)

    def fprime(t):
        return _dot(u_k, resid(at(t)))

    zero = torch.zeros_like(p0[..., :1])
    fp01 = fprime(torch.cat([zero, zero + 1.0], -1))
    fp0, fp1 = fp01[..., 0], fp01[..., 1]

    # both line searches at once: [..., 0] non-strict (f' >= 0), [..., 1]
    # strict (f' > 0)
    lo_t = torch.cat([zero, zero], -1)
    hi_t = lo_t + 1.0
    for _ in range(bisect_iters):
        mid = 0.5 * (lo_t + hi_t)
        fm = fprime(mid)
        up = torch.stack([fm[..., 0] >= 0.0, fm[..., 1] > 0.0], -1)
        lo_t = torch.where(up, lo_t, mid)
        hi_t = torch.where(up, mid, hi_t)

    # closed form at the upper bracket, falling back to the lower
    refs = torch.cat([hi_t, lo_t], -1)                  # [..., 4]
    rb = resid(at(refs))                                 # [..., 4, 3]
    act = (rb > 0.0) | (rb < 0.0)
    target = torch.where(rb > 0.0, hi_k, lo_k)
    num = torch.where(act, u_k * (target - p0_k), 0.0).sum(-1)
    den = torch.where(act, u_k * u_k, 0.0).sum(-1)
    use_hi = den[..., :2] > 1e-12
    num = torch.where(use_hi, num[..., :2], num[..., 2:])
    den = torch.where(use_hi, den[..., :2], den[..., 2:])
    t = num / torch.clamp_min(den, 1e-12)
    t = torch.where(den > 1e-12, torch.clamp(t, 0.0, 1.0), 0.5 * (lo_t + hi_t))
    t1 = torch.where(fp0 >= 0.0, 0.0, torch.where(fp1 < 0.0, 1.0, t[..., 0]))
    t2 = torch.where(fp1 <= 0.0, 1.0, torch.where(fp0 > 0.0, 0.0, t[..., 1]))

    r2 = r[..., None] if isinstance(r, torch.Tensor) else r
    d_e, n_e, p_e, out_e = _sphere_box(torch.stack([p0, p1], -2), r2, lo_k, hi_k,
                                     face_n)
    d_e0, d_e1 = d_e[..., 0], d_e[..., 1]
    out0, out1 = out_e[..., 0], out_e[..., 1]

    # an end whose centre lies inside the box is the single contact
    inside = ~out0 | ~out1
    pick_in1 = torch.where(~out0 & ~out1, d_e1 <= d_e0, ~out1)
    t1 = torch.where(inside, torch.where(pick_in1, 1.0, 0.0), t1)

    d12, n12, p12, out12 = _sphere_box(at(torch.stack([t1, t2], -1)), r2,
                                       lo_k, hi_k, face_n)
    unique = torch.abs(t2 - t1) <= 1e-6
    valid2 = out12[..., 1] & ~unique & ~inside

    e0 = torch.where(out0 & (t1 > 1e-6), d_e0, BIG)
    e1 = torch.where(out1 & (t1 < 1.0 - 1e-6), d_e1, BIG)
    pick1 = e1 < e0
    dist3 = torch.where(pick1, e1, e0)
    n3 = torch.where(pick1[..., None], n_e[..., 1, :], n_e[..., 0, :])
    pos3 = torch.where(pick1[..., None], p_e[..., 1, :], p_e[..., 0, :])
    valid3 = unique & ~inside & (dist3 < BIG * 0.5)
    return ((d12[..., 0], n12[..., 0, :], p12[..., 0, :], torch.ones_like(unique)),
            (d12[..., 1], n12[..., 1, :], p12[..., 1, :], valid2),
            (dist3, n3, pos3, valid3))


def _wall_slots(walls):
    """Group static wall boxes into mirror-pair slots.

    Arena walls come in x- or y-mirror pairs separated by far more than the
    ant's reach (TAG: 10 m, HH: ≥ 4 m vs ≤ 0.8 m capsule reach), so any
    query point can touch at most the nearer wall of a pair: a pair folds
    into ONE candidate slot whose box is selected by the sign of the query
    point's coordinate on ``axis``.  Returns a list of (bounds_pos,
    bounds_neg|None, axis): ``bounds = (lo 3-tuple, hi 3-tuple)`` floats;
    for paired slots ``bounds_pos`` is the wall on the positive side."""
    walls = np.asarray(walls, dtype=np.float64)

    def bounds(w):
        return (tuple(float(x) for x in w[:3] - w[3:]),
                tuple(float(x) for x in w[:3] + w[3:]))

    used = set()
    slots = []
    for i in range(len(walls)):
        if i in used:
            continue
        paired = None
        for j in range(i + 1, len(walls)):
            if j in used:
                continue
            for ax in (0, 1):
                mirror = walls[i].copy()
                mirror[ax] = -mirror[ax]
                # pair only when the gap dwarfs the ant's ~0.8 m reach
                gap = 2.0 * (abs(walls[i][ax]) - walls[i][3 + ax])
                if np.allclose(mirror, walls[j]) and gap > 2.0:
                    paired = (j, ax)
                    break
            if paired:
                break
        if paired:
            j, ax = paired
            used.add(j)
            pos, neg = (i, j) if walls[i][ax] > 0 else (j, i)
            slots.append((bounds(walls[pos]), bounds(walls[neg]), ax))
        else:
            slots.append((bounds(walls[i]), None, None))
    return slots


def _select_bounds(t, point: torch.Tensor):
    """Each slot's box for query points ``point [B, S, ..., 3]`` (slot axis
    S second): the positive or negative wall of a pair by the sign of the
    point's coordinate on the slot's axis (an unpaired slot holds its one
    box on both sides)."""
    extra = point.dim() - 3
    shape = (1, t.n_slots) + (1,) * extra
    ax = t.slot_ax.view(shape + (1,)).expand(point.shape[:-1] + (1,))
    sel = torch.gather(point, -1, ax) > 0.0
    lo = torch.where(sel, t.bpos_lo.view(shape + (3,)), t.bneg_lo.view(shape + (3,)))
    hi = torch.where(sel, t.bpos_hi.view(shape + (3,)), t.bneg_hi.view(shape + (3,)))
    return lo, hi


# ---------------------------------------------------------------------------
# invweight precomputation (MuJoCo *_invweight0, f64 NumPy; the engine reads
# them once per model, dtype and device through dynamics.model_tensors)
# ---------------------------------------------------------------------------


def _qpos0_jacobians(model: AntModel):
    """NumPy CoM Jacobians + mass matrix at qpos0 (identity rotations), f64,
    for the one-time invweight precomputation (MuJoCo precomputes
    ``*_invweight0`` at f64)."""
    nb, nv = model.nb, model.nv
    xpos = np.zeros((nb, 3))
    for b in range(1, nb):
        xpos[b] = xpos[model.parent[b]] + model.body_pos[b]
    com = xpos + model.body_ipos
    u = np.zeros((nv, 3))
    p = np.zeros((nv, 3))
    u[3:6] = np.eye(3)
    u[model.jnt_dof] = model.jnt_axis
    p[model.jnt_dof] = xpos[model.jnt_body]
    jp = np.zeros((nb, nv, 3))
    jr = np.zeros((nb, nv, 3))
    for b in range(nb):
        for d in range(nv):
            if not model.dof_mask[b, d]:
                continue
            if d < 3:
                jp[b, d, d] = 1.0
            else:
                jp[b, d] = np.cross(u[d], com[b] - p[d])
                jr[b, d] = u[d]
    M = (
        np.einsum("b,bdi,bei->de", model.body_mass, jp, jp)
        + np.einsum("bdi,bij,bej->de", jr, model.body_inertia, jr)
        + np.diag(model.armature)
    )
    return jp, M


def _body_invweight(model: AntModel) -> np.ndarray:
    """MuJoCo ``body_invweight0``: mean translational inverse inertia of each
    body at qpos0, diag(J M⁻¹ Jᵀ)/3 at the body CoM."""
    jp, M = _qpos0_jacobians(model)
    return np.einsum("bdi,de,bei->b", jp, np.linalg.inv(M), jp) / 3.0


def _dof_invweight(model: AntModel) -> np.ndarray:
    """MuJoCo ``dof_invweight0``: diag(M⁻¹) at qpos0, with the free joint's
    translation and rotation triplets each averaged."""
    _, M = _qpos0_jacobians(model)
    w = np.diag(np.linalg.inv(M)).copy()
    w[0:3] = w[0:3].mean()
    w[3:6] = w[3:6].mean()
    return w


# ---------------------------------------------------------------------------
# row assembly
# ---------------------------------------------------------------------------

def candidates(model: AntModel, kin: Kinematics):
    """Every collision candidate of the batch → (dist [B, nc], pos
    [B, nc, 3], dirs [B, nc, 3, 3]: the normal and both tangents).  Order:
    the 25 floor spheres (torso, then both ends of each capsule), then per
    wall slot the torso sphere and the capsules' three slots each
    (capsule-major)."""
    t = model_tensors(model, kin.xpos.dtype, kin.xpos.device)
    B, ncap, S = kin.xpos.shape[0], t.ncap, t.n_slots
    xmat_g = kin.xmat[:, t.geom_body]
    centers = kin.xpos[:, t.geom_body] + (xmat_g * t.geom_pos[:, None, :]).sum(-1)
    axis_w = (xmat_g * t.geom_axis[:, None, :]).sum(-1)
    p0 = centers[:, 1:] - t.cap_h * axis_w[:, 1:]              # [B,ncap,3]
    p1 = centers[:, 1:] + t.cap_h * axis_w[:, 1:]

    # floor: z = 0 plane under each sphere
    ends = torch.stack([p0, p1], 2).reshape(B, 2 * ncap, 3)
    sph_c = torch.cat([centers[:, :1], ends], 1)
    dist_f = sph_c[..., 2] - t.sph_r
    pos_f = torch.cat([sph_c[..., :2], (sph_c[..., 2] - (t.sph_r + 0.5 * dist_f))[..., None]], -1)
    t1c, t2c = _capsule_floor_frame(torch.repeat_interleave(axis_w[:, 1:], 2, dim=1))
    n_f = t.floor_n.expand(B, 2 * ncap + 1, 3)
    t1_f = torch.cat([t.torso_t1.expand(B, 1, 3), t1c], 1)
    t2_f = torch.cat([t.torso_t2.expand(B, 1, 3), t2c], 1)

    # walls: every slot at once, [B, S] for the torso, [B, S, ncap] capsules
    torso_c = centers[:, None, 0].expand(B, S, 3)
    lo, hi = _select_bounds(t, torso_c)
    d_t, n_t, q_t, _ = _sphere_box(torso_c, t.geom_r[0], lo, hi, t.face_n)
    mid = (0.5 * (p0 + p1))[:, None].expand(B, S, ncap, 3)
    lo_c, hi_c = _select_bounds(t, mid)
    slots3 = _capsule_box_slots(p0[:, None], p1[:, None], t.cap_r, lo_c, hi_c,
                                t.face_n)
    d_c = torch.stack([torch.where(v, d, BIG) for d, _, _, v in slots3], -1)
    n_c = torch.stack([n for _, n, _, _ in slots3], -2)        # [B,S,ncap,3,3]
    q_c = torch.stack([q for _, _, q, _ in slots3], -2)
    dist_w = torch.cat([d_t[..., None], d_c.reshape(B, S, 3 * ncap)], -1)
    n_w = torch.cat([n_t[:, :, None], n_c.reshape(B, S, 3 * ncap, 3)], 2)
    pos_w = torch.cat([q_t[:, :, None], q_c.reshape(B, S, 3 * ncap, 3)], 2)
    n_w = n_w.reshape(B, -1, 3)
    t1w, t2w = _make_frame(n_w)

    dist = torch.cat([dist_f, dist_w.reshape(B, -1)], 1)
    pos = torch.cat([pos_f, pos_w.reshape(B, -1, 3)], 1)
    dirs = torch.stack([torch.cat([n_f, n_w], 1), torch.cat([t1_f, t1w], 1),
                        torch.cat([t2_f, t2w], 1)], 2)
    return dist, pos, dirs


def constraint_rows(model: AntModel, kin: Kinematics, qpos: torch.Tensor,
                    qvel: torch.Tensor) -> ConstraintRows:
    """The batch's constraint rows: 8 joint limits, then 4 pyramid rows per
    candidate (``constraint_rows_array``'s set, order and formulas)."""
    t = model_tensors(model, qpos.dtype, qpos.device)
    B, nv = qpos.shape[0], t.nv
    dist, pos, dirs = candidates(model, kin)
    jac3 = point_jacobian(model, kin, t.body_c, pos, t.mask_c)  # [B,nc,nv,3]
    jdirs = torch.einsum("ncvi,ncki->nckv", jac3, dirs)          # [B,nc,3,nv]
    k_stiff, b_damp = _kb(model)

    # joint-limit rows (8), the nearer bound of each hinge
    q_j = qpos[:, t.jnt_qpos]
    d_lo, d_hi = q_j - t.jnt_lo, t.jnt_hi - q_j
    lower = d_lo <= d_hi
    pos_lim = torch.where(lower, d_lo, d_hi)
    sign = torch.where(lower, 1.0, -1.0).to(qpos.dtype)
    imp_l = _impedance(model, pos_lim)
    jac_l = sign[..., None] * t.lim_sel
    aref_l = -b_damp * (sign * qvel[:, 6:]) - k_stiff * imp_l * pos_lim
    r_l = (1.0 - imp_l) / imp_l * t.lim_invw
    active_l = (pos_lim < 0.0).to(qpos.dtype)

    # contact pyramid rows (4 per candidate: +t1, -t1, +t2, -t2)
    margin = 2.0 * model.margin
    mu = model.friction
    violation = dist - margin
    active_c = (dist < margin).to(qpos.dtype)
    imp_c = _impedance(model, violation)
    kd = k_stiff * imp_c * violation
    r_c = (1.0 - imp_c) / imp_c * (2.0 * mu * mu * (1.0 + mu * mu)) * t.invw_c
    vel = (jdirs @ qvel[:, None, :, None]).squeeze(-1)           # [B,nc,3]
    jn = jdirs[:, :, :1]
    jac_c = (jn + t.pyr_mu * jdirs[:, :, t.pyr_dir]).reshape(B, -1, nv)
    vel_p = vel[..., :1] + t.pyr_vmu * vel[..., t.pyr_dir]       # [B,nc,4]
    aref_c = (-b_damp * vel_p - kd[..., None]).reshape(B, -1)

    jac = torch.cat([jac_l, jac_c], 1)
    return ConstraintRows(
        jac_t=jac.mT,
        aref=torch.cat([aref_l, aref_c], 1),
        r=torch.cat([r_l, torch.repeat_interleave(r_c, 4, dim=1)], 1),
        active=torch.cat([active_l, torch.repeat_interleave(active_c, 4, dim=1)], 1),
    )


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``A [B, m, n] @ x [B, n]``."""
    return (A @ x[..., None]).squeeze(-1)


def solve_constraints(model: AntModel, M, qacc_smooth, rows: ConstraintRows,
                      iters: int = 250, f0=None):
    """APGD on the dual QP → (qacc, f); the tests' solver.

    ``min_{f≥0} ½fᵀ(A+R)f + fᵀ(J·qacc_smooth − aref)`` with
    ``A = J M⁻¹ Jᵀ``; then ``qacc = qacc_smooth + M⁻¹Jᵀf``.  Inactive rows
    are pinned to f = 0 by projection and masked out of the matrix.  Fixed
    iteration count; the step uses the ∞-norm bound on λmax(A+R), and
    Nesterov momentum restarts on non-monotone steps."""
    j = rows.jac * rows.active[..., None]
    L, _ = torch.linalg.cholesky_ex(M, check_errors=False)
    x = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, j.mT, upper=False),
        upper=True)                                        # [B,nv,ne]
    a = j @ x
    b = (_mv(j, qacc_smooth) - rows.aref) * rows.active
    ar = a + torch.diag_embed(rows.r * rows.active)
    lip = torch.amax(torch.abs(ar).sum(-1), -1, keepdim=True)
    step = 1.0 / lip
    mask = rows.active

    def proj(f):
        return torch.clamp_min(f * mask, 0.0)

    f = proj(torch.zeros_like(b) if f0 is None else f0)
    y = f
    t = torch.ones_like(b[:, :1])
    for _ in range(iters):
        g = _mv(ar, y) + b
        f_new = proj(y - step * g)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        restart = ((y - f_new) * (f_new - f)).sum(-1, keepdim=True) > 0.0
        t_new = torch.where(restart, 1.0, t_new)
        y_new = f_new + ((t - 1.0) / t_new) * (f_new - f)
        y = torch.where(restart, f_new, y_new)
        f, t = f_new, t_new
    return qacc_smooth + _mv(x, f), f


def solve_constraints_newton(model: AntModel, M, qacc_smooth,
                             rows: ConstraintRows, iters: int = 8,
                             ls_iters: int = 10, qacc0=None):
    """Primal Newton solve → (qacc, f), MuJoCo's own solver shape.

    Minimizes the piecewise-quadratic primal cost
    ``φ(q) = ½(q−qs)ᵀM(q−qs) + ½ Σ_i D_i · min(J_i q − aref_i, 0)²``
    (D = 1/R, one-sided rows); forces are ``f_i = −D_i · min(J_i q −
    aref_i, 0)``.  Each of the ``iters`` iterations factors
    ``H = M + Jᵀ diag(D·[J q < aref]) J`` and searches along the Newton
    direction by a fixed ``ls_iters``-step bisection of the monotone
    φ'(α) on [0, 2]: the midpoint of the last bracket, as the JAX
    package's ``(lo, hi)`` loop gives it, walked here as a midpoint that
    moves by halving steps (the same dyadic values).  No exit depends on
    the data, so the loop never waits on the host."""
    J, Jt = rows.jac, rows.jac_t
    aref = rows.aref
    d = rows.active / torch.clamp_min(rows.r, 1e-12)
    q = qacc_smooth if qacc0 is None else qacc0

    def force(jq):
        return -d * torch.clamp_max(jq - aref, 0.0)

    for _ in range(iters):
        jq = _mv(J, q)
        mq = _mv(M, q - qacc_smooth)
        grad = mq - _mv(Jt, force(jq))
        act = d * (jq - aref < 0.0)
        h = M + Jt @ (J * act[..., None])
        dq = -chol_solve(h, grad)
        jdq = _mv(J, dq)
        g0 = (dq * mq).sum(-1, keepdim=True)
        gq = (dq * _mv(M, dq)).sum(-1, keepdim=True)
        w = (jdq * d)[..., None, :]
        alpha = torch.ones_like(g0)
        half = 0.5
        for _ in range(ls_iters):
            slack = torch.addcmul(jq, alpha, jdq) - aref
            dphi = torch.addcmul(g0, alpha, gq) + (
                w @ torch.clamp_max(slack, 0.0)[..., None]).squeeze(-1)
            alpha = alpha + torch.where(dphi > 0.0, -half, half)
            half *= 0.5
        q = torch.addcmul(q, alpha, dq)
    return q, force(_mv(J, q))
