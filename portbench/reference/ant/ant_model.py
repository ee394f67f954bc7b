"""Static rigid-body model for the ant quadruped, built from first principles:
a copy of :mod:`gym_po_tpu.physics.ant_model` (NumPy only), so that the
port's engine imports nothing of the JAX package.

The kinematic tree, geometry, and mass properties are derived from the same
compact leg specification that generates the MJCF assets
(:mod:`gym_po_tpu_torch.envs.mjcf`) — NOT parsed from a compiled MuJoCo
model, so the engine has no runtime MuJoCo dependency.
``tests/test_torch_physics.py`` holds every array against the JAX package's
model bit for bit and against the MuJoCo-compiled model at f64.

Layout (matches MuJoCo's compilation of the generated XML, reference assets
``gym_po/envs/assets/ant_tag_small.xml`` / ``ant_heaven_hell.xml``):

* 13 moving bodies: torso + 4 × (leg-root, aux, foot).  Leg-root bodies are
  jointless (welded to the torso); aux carries the hip hinge, foot the ankle.
* nq = 15 (free joint 7 + 8 hinges), nv = 14.
* dof order: [tx ty tz  wx wy wz  hip1 ankle1 hip2 ankle2 hip3 ankle3 hip4
  ankle4]; free-joint linear velocity is world-frame, angular is body-frame.
* actuators follow the reference XML order hip_4, ankle_4, hip_1, ankle_1,
  hip_2, ankle_2, hip_3, ankle_3 with gear 15 and ctrlrange ±1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["AntModel", "make_ant_model", "TAG_WALLS", "HEAVEN_HELL_WALLS"]

DENSITY = 5.0
CAPSULE_R = 0.08
TORSO_R = 0.25
GEAR = 15.0
DT = 0.02
GRAVITY = -9.81
MARGIN = 0.01
FRICTION = 1.0           # tangential (condim 3; torsional/rolling unused)
SOLREF = (0.02, 1.0)
SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)
ARMATURE = 1.0
DAMPING = 1.0

# (sx, sy, ankle_axis, ankle_range_deg) per leg 1..4 — mirrors mjcf._LEGS
_LEGS = [
    (1.0, 1.0, (-1.0, 1.0, 0.0), (30.0, 70.0)),
    (-1.0, 1.0, (1.0, 1.0, 0.0), (-70.0, -30.0)),
    (-1.0, -1.0, (-1.0, 1.0, 0.0), (-70.0, -30.0)),
    (1.0, -1.0, (1.0, 1.0, 0.0), (30.0, 70.0)),
]
_ACTUATOR_LEG_ORDER = [4, 1, 2, 3]  # reference ant_tag_small.xml:114-123

# wall boxes as (cx, cy, cz, hx, hy, hz) — mirrors mjcf.ant_tag_xml / _hh_xml
TAG_WALLS = np.array(
    [
        (0.0, 5.25, 1.0, 5.25, 0.25, 1.0),
        (0.0, -5.25, 1.0, 5.25, 0.25, 1.0),
        (5.25, 0.0, 1.0, 0.25, 5.25, 1.0),
        (-5.25, 0.0, 1.0, 0.25, 5.25, 1.0),
    ]
)
HEAVEN_HELL_WALLS = np.array(
    [
        (0.0, 8.25, 1.0, 8.25, 0.25, 1.0),
        (-8.25, 6.25, 1.0, 0.25, 2.0, 1.0),
        (8.25, 6.25, 1.0, 0.25, 2.0, 1.0),
        (-5.5, 4.25, 1.0, 3.0, 0.25, 1.0),
        (5.5, 4.25, 1.0, 3.0, 0.25, 1.0),
        (2.25, 1.5, 1.0, 0.25, 3.0, 1.0),
        (-2.25, 1.5, 1.0, 0.25, 3.0, 1.0),
        (0.0, -1.75, 1.0, 2.5, 0.25, 1.0),
    ]
)


def _sphere_mass_inertia(r: float):
    m = DENSITY * 4.0 / 3.0 * np.pi * r**3
    i = 0.4 * m * r * r
    return m, np.diag([i, i, i])


def _capsule_mass_inertia(r: float, h: float, axis: np.ndarray):
    """Exact capsule (cylinder half-length ``h`` + two hemispherical caps)
    mass and inertia tensor about its CoM, axis ``axis`` (unit)."""
    mc = DENSITY * np.pi * r * r * (2.0 * h)        # cylinder
    ms = DENSITY * 4.0 / 3.0 * np.pi * r**3         # both caps = one sphere
    m = mc + ms
    i_axial = 0.5 * mc * r * r + 0.4 * ms * r * r
    mh = 0.5 * ms                                    # one hemisphere
    d = h + 3.0 * r / 8.0                            # cap centroid offset
    i_perp = (
        mc * (3.0 * r * r + 4.0 * h * h) / 12.0
        + 2.0 * (83.0 / 320.0 * mh * r * r + mh * d * d)
    )
    eye = np.eye(3)
    inertia = i_perp * eye + (i_axial - i_perp) * np.outer(axis, axis)
    return m, inertia


@dataclass(frozen=True)
class AntModel:
    """Static model arrays (NumPy; the engine converts them to tensors once per
    dtype and device).

    Shapes: ``nb`` = 13 bodies, ``nv`` = 14 dofs, ``ng`` = 13 collision geoms
    (1 torso sphere + 12 leg capsules), ``nw`` walls.
    """

    parent: np.ndarray          # [nb] parent body index (-1 = world)
    body_pos: np.ndarray        # [nb,3] frame origin in parent frame
    body_mass: np.ndarray       # [nb]
    body_ipos: np.ndarray       # [nb,3] CoM in body frame
    body_inertia: np.ndarray    # [nb,3,3] about CoM, body frame
    # hinge joints (8): child body, local axis, dof / qpos index, range
    jnt_body: np.ndarray        # [8]
    jnt_axis: np.ndarray        # [8,3] in child body frame
    jnt_dof: np.ndarray         # [8] index into qvel
    jnt_qpos: np.ndarray        # [8] index into qpos
    jnt_range: np.ndarray       # [8,2] radians
    # per-body hinge bookkeeping: -1 for torso/leg-roots
    body_jnt: np.ndarray        # [nb] joint id whose hinge moves this body
    dof_mask: np.ndarray        # [nb,nv] 1.0 where dof is an ancestor of body
    armature: np.ndarray        # [nv]
    damping: np.ndarray         # [nv]
    act_dof: np.ndarray         # [8] dof driven by each actuator
    gear: float
    # collision geoms: spheres are capsules with zero half-length
    geom_body: np.ndarray       # [ng]
    geom_pos: np.ndarray        # [ng,3] center in body frame
    geom_axis: np.ndarray       # [ng,3] unit axis in body frame
    geom_r: np.ndarray          # [ng]
    geom_h: np.ndarray          # [ng] half-length (0 for the torso sphere)
    walls: np.ndarray           # [nw,6] (center, half-extents)
    dt: float = DT
    gravity: float = GRAVITY
    margin: float = MARGIN
    friction: float = FRICTION
    solref: tuple = SOLREF
    solimp: tuple = SOLIMP
    nb: int = 13
    nv: int = 14
    nq: int = 15

    def __hash__(self):  # identity: one model, one set of device tensors
        return hash((id(self.walls), self.dt))

    def __eq__(self, other):
        return self is other


def make_ant_model(walls: np.ndarray) -> AntModel:
    parent = [-1]
    body_pos = [np.zeros(3)]
    mass = []
    ipos = []
    inertia = []
    jnt_body, jnt_axis, jnt_range = [], [], []
    body_jnt = [-1]
    geom_body, geom_pos, geom_axis, geom_r, geom_h = [], [], [], [], []

    m, it = _sphere_mass_inertia(TORSO_R)
    mass.append(m)
    ipos.append(np.zeros(3))
    inertia.append(it)
    geom_body.append(0)
    geom_pos.append(np.zeros(3))
    geom_axis.append(np.array([0.0, 0.0, 1.0]))
    geom_r.append(TORSO_R)
    geom_h.append(0.0)

    for li, (sx, sy, ankle_axis, ankle_range) in enumerate(_LEGS):
        a, b = 0.2 * sx, 0.2 * sy
        seg = np.array([a, b, 0.0])
        axis = seg / np.linalg.norm(seg)
        half = np.linalg.norm(seg) / 2.0
        mcap, icap = _capsule_mass_inertia(CAPSULE_R, half, axis)
        mfoot, ifoot = _capsule_mass_inertia(CAPSULE_R, 2 * half, axis)
        torso_i = 0
        # leg-root (jointless, frame == torso frame), capsule 0→(a,b,0)
        root_i = len(parent)
        parent.append(torso_i)
        body_pos.append(np.zeros(3))
        mass.append(mcap)
        ipos.append(seg / 2.0)
        inertia.append(icap)
        body_jnt.append(-1)
        geom_body.append(root_i)
        geom_pos.append(seg / 2.0)
        geom_axis.append(axis)
        geom_r.append(CAPSULE_R)
        geom_h.append(half)
        # aux body at (a,b,0), hip hinge about z, capsule 0→(a,b,0)
        aux_i = len(parent)
        parent.append(root_i)
        body_pos.append(seg.copy())
        mass.append(mcap)
        ipos.append(seg / 2.0)
        inertia.append(icap)
        jnt_body.append(aux_i)
        jnt_axis.append(np.array([0.0, 0.0, 1.0]))
        jnt_range.append(np.deg2rad([-30.0, 30.0]))
        body_jnt.append(len(jnt_body) - 1)
        geom_body.append(aux_i)
        geom_pos.append(seg / 2.0)
        geom_axis.append(axis)
        geom_r.append(CAPSULE_R)
        geom_h.append(half)
        # foot body at (a,b,0) rel aux, ankle hinge, capsule 0→(2a,2b,0)
        foot_i = len(parent)
        parent.append(aux_i)
        body_pos.append(seg.copy())
        mass.append(mfoot)
        ipos.append(seg.copy())
        inertia.append(ifoot)
        ax = np.asarray(ankle_axis, dtype=np.float64)
        jnt_body.append(foot_i)
        jnt_axis.append(ax / np.linalg.norm(ax))
        jnt_range.append(np.deg2rad(ankle_range))
        body_jnt.append(len(jnt_body) - 1)
        geom_body.append(foot_i)
        geom_pos.append(seg.copy())
        geom_axis.append(axis)
        geom_r.append(CAPSULE_R)
        geom_h.append(2 * half)

    nb, nv = len(parent), 14
    parent = np.asarray(parent)
    jnt_dof = 6 + np.arange(8)
    jnt_qpos = 7 + np.arange(8)

    # ancestor-dof mask: free dofs move everything; a hinge moves the joint's
    # child body and every body below it in the tree
    dof_mask = np.zeros((nb, nv))
    dof_mask[:, :6] = 1.0
    body_jnt = np.asarray(body_jnt)
    for b in range(nb):
        p = b
        while p != -1:
            j = body_jnt[p]
            if j >= 0:
                dof_mask[b, jnt_dof[j]] = 1.0
            p = parent[p]

    armature = np.zeros(nv)
    armature[6:] = ARMATURE
    damping = np.zeros(nv)
    damping[6:] = DAMPING

    # actuator k drives (hip, ankle) of leg _ACTUATOR_LEG_ORDER[k//2]
    act_dof = np.array(
        [6 + 2 * (leg - 1) + j for leg in _ACTUATOR_LEG_ORDER for j in (0, 1)]
    )

    return AntModel(
        parent=parent,
        body_pos=np.stack(body_pos),
        body_mass=np.asarray(mass),
        body_ipos=np.stack(ipos),
        body_inertia=np.stack(inertia),
        jnt_body=np.asarray(jnt_body),
        jnt_axis=np.stack(jnt_axis),
        jnt_dof=jnt_dof,
        jnt_qpos=jnt_qpos,
        jnt_range=np.stack(jnt_range),
        body_jnt=body_jnt,
        dof_mask=dof_mask,
        armature=armature,
        damping=damping,
        act_dof=act_dof,
        gear=GEAR,
        geom_body=np.asarray(geom_body),
        geom_pos=np.stack(geom_pos),
        geom_axis=np.stack(geom_axis),
        geom_r=np.asarray(geom_r),
        geom_h=np.asarray(geom_h),
        walls=np.asarray(walls, dtype=np.float64),
    )
