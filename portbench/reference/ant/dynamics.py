"""Smooth rigid-body dynamics for the ant: FK, Jacobians, CRBA, bias.  PyTorch
port of :mod:`gym_po_tpu.physics.dynamics`, its array pipeline
(``smooth_forward_array``).

Every function takes a batch on a leading axis ``[B, ...]`` and computes it
with batched tensor ops: the 13-body tree one depth level at a time (the
four legs of a level together), the Jacobians as ``[B, nb, nv, 3]``
tensors, the mass matrix and the bias force as contractions over them.
The math mirrors MuJoCo (the substrate under the reference's
``gym_po/envs/ant_tag.py:138-158``):

* ``M[d,e] = Σ_b m_b jp_bd·jp_be + jr_bd·I_b^w jr_be + armature δ_de``
  (MuJoCo ``mj_crb``, with the (body, dof) sparsity ``dof_mask`` applied as
  a mask);
* ``qfrc_bias`` is RNEA with q̈ = 0 (MuJoCo ``mj_rne`` with gravity).

Free-joint conventions follow MuJoCo: linear qvel is world-frame, angular
qvel is body-frame, rotation dofs are anchored at the torso frame origin.
Everything follows ``qpos``'s dtype and device; the model's arrays become
tensors once per dtype and device (:func:`model_tensors`).
"""

from __future__ import annotations

import weakref
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .ant_model import AntModel
from .linalg import chol_solve
from .spatial import cross, quat_mul, quat_to_mat

__all__ = ["Kinematics", "model_tensors", "fk", "kinematics", "mass_matrix",
           "bias_force", "point_jacobian", "actuation", "smooth_forward"]

_TENSORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _levels(model: AntModel):
    """The bodies below the torso grouped by tree depth: ``(bodies,
    parents, joints)`` per level, each parent given by its place in the
    level above, joint -1 for a welded body."""
    depth = np.zeros(model.nb, np.int64)
    for b in range(1, model.nb):
        depth[b] = depth[model.parent[b]] + 1
    out, above = [], np.array([0])
    for lv in range(1, int(depth.max()) + 1):
        bodies = np.flatnonzero(depth == lv)
        place = {int(b): k for k, b in enumerate(above)}
        parents = np.array([place[int(model.parent[b])] for b in bodies])
        out.append((bodies, parents, model.body_jnt[bodies]))
        above = bodies
    return out


def model_tensors(model: AntModel, dtype: torch.dtype,
                  device) -> SimpleNamespace:
    """The model's arrays as tensors of ``dtype`` on ``device`` (made once,
    then cached on the model): what the batched engine reads."""
    device = torch.device(device)
    per_model = _TENSORS.setdefault(model, {})
    key = (dtype, device)
    if key in per_model:
        return per_model[key]
    from .contact import _body_invweight, _dof_invweight, _wall_slots

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    nv = model.nv
    jd = np.asarray(model.jnt_dof)
    if not np.array_equal(jd, 6 + np.arange(len(jd))):
        raise ValueError("the engine takes the hinge dofs in order after the "
                         "free joint's six")
    levels = []
    for bodies, parents, joints in _levels(model):
        if (joints >= 0).all():
            axis, qidx = model.jnt_axis[joints], model.jnt_qpos[joints]
        elif (joints < 0).all():
            axis = qidx = None
        else:
            raise ValueError("a tree level mixes hinged and welded bodies")
        levels.append(SimpleNamespace(
            bodies=bodies, parents=i(parents), off=f(model.body_pos[bodies]),
            axis=None if axis is None else f(axis),
            qidx=None if qidx is None else i(qidx)))
    order = np.concatenate([[0]] + [lv.bodies for lv in levels])
    trans = np.zeros(nv)
    trans[:3] = 1.0
    rot = (1.0 - trans) * (np.arange(nv) >= 3)
    anchor = np.zeros(nv, np.int64)
    anchor[jd] = model.jnt_body
    act_of_dof = np.argsort(np.asarray(model.act_dof))  # dof 6 + k <- actuator
    gb = np.asarray(model.geom_body)
    ncap = len(gb) - 1
    # collision candidates: floor (torso sphere, both ends of each capsule),
    # then per wall slot the torso sphere and 3 slots per capsule
    slots = _wall_slots(model.walls)
    body_f = np.concatenate([gb[:1], np.repeat(gb[1:], 2)])
    body_w = np.concatenate([gb[:1], np.repeat(gb[1:], 3)])
    body_c = np.concatenate([body_f] + [body_w] * len(slots))
    sph_r = np.concatenate([model.geom_r[:1], np.repeat(model.geom_r[1:], 2)])
    bpos = np.array([[s[0][0], s[0][1]] for s in slots])       # [S, 2, 3]
    bneg = np.array([[(s[1] or s[0])[0], (s[1] or s[0])[1]] for s in slots])
    slot_ax = np.array([0 if s[2] is None else s[2] for s in slots])
    sel = np.zeros((len(jd), nv))
    sel[np.arange(len(jd)), jd] = 1.0
    eye = np.concatenate([np.eye(3), np.zeros((nv - 3, 3))])
    mu = model.friction
    t = SimpleNamespace(
        nv=nv, levels=levels, body_order=i(np.argsort(order)),
        body_ipos=f(model.body_ipos), body_inertia=f(model.body_inertia),
        body_mass=f(model.body_mass), jnt_body=i(model.jnt_body),
        jnt_axis=f(model.jnt_axis), jnt_qpos=i(model.jnt_qpos),
        jnt_lo=f(model.jnt_range[:, 0]), jnt_hi=f(model.jnt_range[:, 1]),
        dof_mask=f(model.dof_mask), trans=f(trans), rot=f(rot), eye=f(eye),
        mrot=f(model.dof_mask * rot), anchor=i(anchor),
        diag_armature=f(np.diag(model.armature)), damping=f(model.damping),
        act_of_dof=i(act_of_dof), gravity=f([0.0, 0.0, model.gravity]),
        geom_body=i(gb), geom_pos=f(model.geom_pos), geom_axis=f(model.geom_axis),
        geom_r=f(model.geom_r), cap_h=f(model.geom_h[1:, None]),
        cap_r=f(model.geom_r[1:]), ncap=ncap, sph_r=f(sph_r),
        n_slots=len(slots), bpos_lo=f(bpos[:, 0]), bpos_hi=f(bpos[:, 1]),
        bneg_lo=f(bneg[:, 0]), bneg_hi=f(bneg[:, 1]), slot_ax=i(slot_ax),
        body_c=i(body_c), mask_c=f(model.dof_mask[body_c])[..., None],
        invw_c=f(_body_invweight(model)[body_c]), lim_sel=f(sel),
        lim_invw=f(_dof_invweight(model)[jd]),
        floor_n=f([0.0, 0.0, 1.0]), torso_t1=f([[0.0, 1.0, 0.0]]),
        torso_t2=f([[-1.0, 0.0, 0.0]]),
        face_n=f([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]]),
        pyr_dir=i([1, 1, 2, 2]), pyr_mu=f([[mu], [-mu], [mu], [-mu]]),
        pyr_vmu=f([mu, -mu, mu, -mu]),
    )
    per_model[key] = t
    return t


class Kinematics(NamedTuple):
    """Batched kinematics, every field with a leading batch axis ``B``."""

    xpos: torch.Tensor       # [B,nb,3]
    xquat: torch.Tensor      # [B,nb,4]
    xmat: torch.Tensor       # [B,nb,3,3]
    com: torch.Tensor        # [B,nb,3]
    inertia_w: torch.Tensor  # [B,nb,3,3]
    dof_u: torch.Tensor      # [B,nv,3] world axis of each dof
    dof_p: torch.Tensor      # [B,nv,3] its anchor
    trans: torch.Tensor      # [nv] 1.0 for the 3 free translation dofs
    jp: torch.Tensor         # [B,nb,nv,3] CoM linear Jacobians
    jr: torch.Tensor         # [B,nb,nv,3] angular Jacobians


def _hinge_quat(ang: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """Quaternions of rotations by ``ang [B, n]`` about unit ``ax [n, 3]``:
    (cos(a/2), sin(a/2)·ax)."""
    c = torch.cos(0.5 * ang)
    s = torch.sin(0.5 * ang)
    return torch.cat([c[..., None], s[..., None] * ax], dim=-1)


def fk(model: AntModel, qpos: torch.Tensor):
    """Forward kinematics of ``qpos [B, nq]`` → (xpos [B,nb,3],
    xquat [B,nb,4], xmat [B,nb,3,3]), one tree level at a time."""
    t = model_tensors(model, qpos.dtype, qpos.device)
    rq = qpos[:, 3:7]
    inv = 1.0 / torch.sqrt((rq * rq).sum(-1, keepdim=True))
    root_q = rq * inv
    pos, quat, mat = qpos[:, None, 0:3], root_q[:, None], quat_to_mat(root_q)[:, None]
    xpos, xquat, xmat = [pos], [quat], [mat]
    for lv in t.levels:
        p_pos, p_quat, p_mat = pos[:, lv.parents], quat[:, lv.parents], mat[:, lv.parents]
        pos = p_pos + (p_mat * lv.off[:, None, :]).sum(-1)
        if lv.axis is None:
            quat, mat = p_quat, p_mat
        else:
            quat = quat_mul(p_quat, _hinge_quat(qpos[:, lv.qidx], lv.axis))
            mat = quat_to_mat(quat)
        xpos.append(pos)
        xquat.append(quat)
        xmat.append(mat)
    # the levels hold the bodies in depth order: back to the model's order
    return (torch.cat(xpos, 1)[:, t.body_order],
            torch.cat(xquat, 1)[:, t.body_order],
            torch.cat(xmat, 1)[:, t.body_order])


def kinematics(model: AntModel, qpos: torch.Tensor) -> Kinematics:
    """FK plus CoMs, world inertias, dof axes and anchors and the masked
    CoM Jacobians (``smooth_forward_array``'s first half)."""
    t = model_tensors(model, qpos.dtype, qpos.device)
    xpos, xquat, xmat = fk(model, qpos)
    B = qpos.shape[0]
    com = xpos + torch.einsum("nbij,bj->nbi", xmat, t.body_ipos)
    iw = torch.einsum("nbij,bjk,nblk->nbil", xmat, t.body_inertia, xmat)
    axis_w = torch.einsum("njik,jk->nji", xmat[:, t.jnt_body], t.jnt_axis)
    zeros3 = qpos.new_zeros(B, 3, 3)
    dof_u = torch.cat([zeros3, xmat[:, 0].mT, axis_w], 1)
    dof_p = torch.cat([zeros3, xpos[:, :1].expand(B, 3, 3), xpos[:, t.jnt_body]], 1)
    arm = com[:, :, None, :] - dof_p[:, None]                 # [B,nb,nv,3]
    jp = t.dof_mask[:, :, None] * (
        t.trans[:, None] * t.eye
        + t.rot[:, None] * cross(dof_u[:, None], arm))
    jr = t.mrot[:, :, None] * dof_u[:, None]
    return Kinematics(xpos=xpos, xquat=xquat, xmat=xmat, com=com,
                      inertia_w=iw, dof_u=dof_u, dof_p=dof_p, trans=t.trans,
                      jp=jp, jr=jr)


def mass_matrix(model: AntModel, kin: Kinematics) -> torch.Tensor:
    """Joint-space inertia [B,nv,nv] (MuJoCo ``mj_fullM``)."""
    t = model_tensors(model, kin.com.dtype, kin.com.device)
    return (torch.einsum("b,nbdi,nbei->nde", t.body_mass, kin.jp, kin.jp)
            + torch.einsum("nbdi,nbij,nbej->nde", kin.jr, kin.inertia_w, kin.jr)
            + t.diag_armature)


def bias_force(model: AntModel, kin: Kinematics,
               qvel: torch.Tensor) -> torch.Tensor:
    """``qfrc_bias`` [B,nv]: RNEA with q̈ = 0 over the Jacobians."""
    t = model_tensors(model, qvel.dtype, qvel.device)
    cdot = torch.einsum("nbdi,nd->nbi", kin.jp, qvel)          # [B,nb,3]
    omega = torch.einsum("nbdi,nd->nbi", kin.jr, qvel)
    w_a = omega[:, t.anchor]                                   # [B,nv,3]
    udot = cross(w_a, kin.dof_u)
    pdot = cdot[:, t.anchor] + cross(w_a, kin.dof_p - kin.com[:, t.anchor])
    arm = kin.com[:, :, None, :] - kin.dof_p[:, None]
    dcol = (cross(udot[:, None], arm)
            + cross(kin.dof_u[:, None], cdot[:, :, None] - pdot[:, None]))
    a_lin = torch.einsum("bd,nd,nbdi->nbi", t.mrot, qvel, dcol)
    a_ang = torch.einsum("bd,nd,ndi->nbi", t.mrot, qvel, udot)
    f_lin = t.body_mass[:, None] * (a_lin - t.gravity)
    iw = kin.inertia_w
    f_ang = (torch.einsum("nbij,nbj->nbi", iw, a_ang)
             + cross(omega, torch.einsum("nbij,nbj->nbi", iw, omega)))
    return (torch.einsum("nbdi,nbi->nd", kin.jp, f_lin)
            + torch.einsum("nbdi,nbi->nd", kin.jr, f_ang))


def point_jacobian(model: AntModel, kin: Kinematics, body: torch.Tensor,
                   point: torch.Tensor, mask=None) -> torch.Tensor:
    """Linear Jacobians [B, c, nv, 3] of world points ``point [B, c, 3]``
    on bodies ``body [c]`` (``mask`` [c, nv, 1]: ``dof_mask[body]``, when
    the caller holds it)."""
    t = model_tensors(model, point.dtype, point.device)
    if mask is None:
        mask = t.dof_mask[body][..., None]
    arm = point[:, :, None, :] - kin.dof_p[:, None]            # [B,c,nv,3]
    rot_p = cross(kin.dof_u[:, None], arm)
    tr = t.trans[:, None]
    return mask * (tr * t.eye + (1.0 - tr) * rot_p)


def actuation(model: AntModel, ctrl: torch.Tensor) -> torch.Tensor:
    """Generalized force [B, nv] of the gear-15 torque motors, ``ctrl``
    [B, 8] clamped to ±1 (the JAX package's ``actuation_s``)."""
    t = model_tensors(model, ctrl.dtype, ctrl.device)
    tau = model.gear * torch.clamp(ctrl, -1.0, 1.0)
    return torch.cat([ctrl.new_zeros(ctrl.shape[0], 6), tau[:, t.act_of_dof]], 1)


def smooth_forward(model: AntModel, qpos: torch.Tensor, qvel: torch.Tensor,
                   ctrl: torch.Tensor):
    """Unconstrained dynamics → (kin, M, qacc_smooth, qfrc_smooth), each
    batched over the leading axis; ``qacc_smooth`` is MuJoCo's
    ``mjData.qacc_smooth``.  Passive damping and armature included."""
    t = model_tensors(model, qpos.dtype, qpos.device)
    kin = kinematics(model, qpos)
    M = mass_matrix(model, kin)
    bias = bias_force(model, kin, qvel)
    tau = actuation(model, ctrl.to(qpos.dtype))
    qfrc = tau - t.damping * qvel - bias
    qacc = chol_solve(M, qfrc)
    return kin, M, qacc, qfrc
