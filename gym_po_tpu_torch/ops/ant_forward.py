"""The ant engine's ``pipeline="scalar"`` forward: three hand-written CUDA
kernels and their plain twins.

Port of the JAX package's default ant forward
(``gym_po_tpu/physics/engine.py:87-97``: ``smooth_forward_s``,
``contact_candidates_s`` + ``constraint_rows_scalar``,
``solve_constraints_newton_s``), whose per-env scalar code XLA lowers to
straight-line vector code on the TPU.  On the card (``csrc/ant_forward.cu``):

* :func:`ant_smooth` ``(qpos, qvel, ctrl) -> Smooth(M, qacc_smooth, skin)``:
  FK, the mass matrix, the bias force, actuation, damping and the 14x14
  solve; one warp per env, 8 envs a block at f32 (4 at f64), FK a tree
  level at a time and the mass matrix over its support
  (:func:`smooth_table`);
* :func:`ant_rows` ``(skin, qpos, qvel) -> Rows(vals, aref, r, active)``:
  the 8 joint-limit rows and 4 pyramid rows per collision candidate, each
  row's values over its static dof support; one thread per (unit, env), the
  env index fastest within a warp (:func:`units`: a limit row, a floor
  sphere or capsule end, a wall slot's torso sphere-box, or a capsule's
  three capsule-box slots in one wall slot);
* :func:`ant_newton` ``(smooth, rows, warm) -> (qacc, warm')``: the primal
  Newton solve over the active rows; one warp per env, 8 envs a block at
  f32 (4 at f64), each env's M, Hessian, factor and active rows in shared
  memory and registers (:func:`newton_smem_bytes`).

:func:`forward` chains the three on the current stream into buffers made
once per (model, batch, dtype, device), so an env step allocates nothing
but its outputs and never waits on the host; ``engine.forward`` calls it for
``pipeline="scalar"`` on a CUDA tensor.  Its first call for a batch size
must run eagerly, not under CUDA-graph capture: it builds the kernels and
copies the model to the card.

Layouts.  The model's constants are one buffer (:func:`pack_model`, read
back by :func:`unpack_model`); the static dof support of each row (what the
JAX scalar pipeline drops at trace time as Python zeros) is a CSR table
(:func:`row_supports`, :func:`mass_support`); ``ant_rows``' units are an
int32 table (:func:`units`, :data:`UNIT_FIELDS`), and so is the tree that
``ant_smooth`` reads (:func:`smooth_table`, :data:`SMOOTH_FIELDS`).  Every buffer between the
kernels is env-minor, ``[k, B]``: ``M`` ``[196, B]`` (row-major 14x14),
``qacc_smooth`` ``[14, B]``, ``skin`` ``[240, B]`` (:data:`SKIN_FIELDS`:
body xpos and xmat, each dof's world axis and anchor), ``vals`` ``[nnz, B]``
(row after row, each over its support), ``aref``, ``r``, ``active``
``[ne, B]``; ``ant_newton`` copies its block's envs of them into shared
memory with the env index fastest.  ``qpos``, ``qvel``, ``ctrl``, ``warm``
and the outputs are ``[B, n]`` as the engine holds them.

Each kernel wrapper launches its kernel on a CUDA tensor (or raises) and
runs its twin on a CPU tensor: ``smooth_twin``, ``rows_twin`` and
``newton_twin`` are the port's batched array engine
(:mod:`gym_po_tpu_torch.physics`) in the kernels' layouts.  Launch counts:
``ant_smooth.launches`` etc. and ``_build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..physics import contact as _contact
from ..physics import dynamics as _dynamics
from ..physics.ant_model import AntModel
from ..utils.profiling import count_nonzero, counter
from ._build import count_launch

__all__ = [
    "MODEL_FIELDS", "SCALARS", "SKIN_FIELDS", "Smooth", "Rows", "pack_model",
    "unpack_model", "row_supports", "mass_support", "tables", "UNIT_FIELDS",
    "units", "SMOOTH_FIELDS", "smooth_table", "newton_smem_bytes", "newton_rows_cap", "ant_smooth", "ant_rows",
    "ant_newton", "smooth_twin", "rows_twin", "newton_twin", "forward", "dense_rows",
]

NB, NV, NQ, NJ, NU, NG = 13, 14, 15, 8, 8, 13
NL = NV * (NV + 1) // 2     # a packed lower triangle, column after column
NPAIR = 64                  # the (body, rotation dof) pairs ant_smooth holds
NCAP = NG - 1
NFLOOR = 1 + 2 * NCAP       # the torso sphere, both ends of each capsule
NSLOT_CAND = 1 + 3 * NCAP   # per wall slot: the torso, 3 slots per capsule
SLOT_WIDTH = 13             # lo+, hi+, lo-, hi- (3 each), axis

# the model buffer, in the order of the M_* offsets in csrc/ant_forward.cu
MODEL_FIELDS = (
    ("parent", NB), ("body_pos", 3 * NB), ("body_mass", NB),
    ("body_ipos", 3 * NB), ("body_inertia", 9 * NB), ("body_jnt", NB),
    ("dof_mask", NB * NV), ("jnt_body", NJ), ("jnt_axis", 3 * NJ),
    ("jnt_dof", NJ), ("jnt_qpos", NJ), ("jnt_range", 2 * NJ),
    ("armature", NV), ("damping", NV), ("act_dof", NU), ("geom_body", NG),
    ("geom_pos", 3 * NG), ("geom_axis", 3 * NG), ("geom_r", NG),
    ("geom_h", NG), ("body_invweight", NB), ("dof_invweight", NV),
)
SCALARS = ("gear", "gravity", "margin2", "mu", "k_stiff", "b_damp", "d0",
           "dspan", "width", "mid", "power", "imp_a", "imp_b", "pyr")
SKIN_FIELDS = (("xpos", (NB, 3)), ("xmat", (NB, 3, 3)), ("dof_u", (NV, 3)),
               ("dof_p", (NV, 3)))
SKIN = sum(int(np.prod(s)) for _, s in SKIN_FIELDS)
_INT_FIELDS = {"parent", "body_jnt", "jnt_body", "jnt_dof", "jnt_qpos",
               "act_dof", "geom_body"}
# ant_rows' units (the U_* and UF_* enums of csrc/ant_forward.cu)
UNIT_FIELDS = ("kind", "index", "body", "geom", "slot", "end", "hinge0",
               "hinge1")
U_LIMIT, U_FLOOR_TORSO, U_FLOOR_END, U_WALL_TORSO, U_WALL_CAPSULE = range(5)
# ant_smooth's tree table, in the order of the ST_* offsets of
# csrc/ant_forward.cu (smooth_table)
SMOOTH_FIELDS = (
    ("n_levels", 1), ("level", NB), ("parent", NB), ("body_jnt", NB),
    ("body_qpos", NB), ("body_dofs", NB), ("pair_base", NB), ("pairs", NPAIR),
    ("dof_anchor", NV), ("dof_jnt", NV), ("dof_bodies", NV), ("dof_act", NV),
    ("m_entry", NL), ("m_bodies", NL),
)


class Smooth(NamedTuple):
    M: torch.Tensor            # [NV * NV, B] row-major mass matrix
    qacc_smooth: torch.Tensor  # [NV, B]
    skin: torch.Tensor         # [SKIN, B] (SKIN_FIELDS)


class Rows(NamedTuple):
    vals: torch.Tensor    # [nnz, B] each row's values over its support
    aref: torch.Tensor    # [ne, B]
    r: torch.Tensor       # [ne, B] regularizer
    active: torch.Tensor  # [ne, B] {0, 1}


# ------------------------------------------------------------ model packing

def _check_model(model: AntModel) -> None:
    jd = np.asarray(model.jnt_dof)
    if (model.nb, model.nv, model.nq, len(jd), len(model.act_dof),
            len(model.geom_body)) != (NB, NV, NQ, NJ, NU, NG):
        raise ValueError("the kernels take the ant's 13 bodies, 14 dofs, "
                         "8 hinges, 8 actuators and 13 geoms")
    if not (np.asarray(model.dof_mask)[:, :6] == 1).all() or (jd < 6).any():
        raise ValueError("the kernels take the free joint's 6 dofs first")
    if model.geom_h[0] != 0.0 or (np.asarray(model.parent)[1:]
                                  >= np.arange(1, NB)).any():
        raise ValueError("the kernels take geom 0 as the torso sphere and "
                         "each body after its parent")
    if max(len(_hinges(model, b)) for b in range(NB)) > 2:
        raise ValueError("the kernels take at most 2 hinges moving a body")
    parent, bj = np.asarray(model.parent), np.asarray(model.body_jnt)
    jb = np.asarray(model.jnt_body)
    if parent[0] != -1 or bj[0] != -1 or sorted(jd) != list(range(6, NV)):
        raise ValueError("the kernels take body 0 as the free root and one "
                         "hinge for each dof after the 6 free ones")
    if any(bj[b] >= 0 and jb[bj[b]] != b for b in range(NB)) or any(
            bj[jb[j]] != j for j in range(NJ)):
        raise ValueError("the kernels take each hinge moving its own body")
    if int(np.asarray(model.dof_mask)[:, 3:].sum()) > NPAIR:
        raise ValueError(f"ant_smooth holds at most {NPAIR} (body, rotation "
                         "dof) pairs")


def _scalars(model: AntModel) -> dict:
    d0, dmax, width, mid, power = model.solimp
    k, b = _contact._kb(model)
    mu = model.friction
    return dict(gear=model.gear, gravity=model.gravity,
                margin2=2.0 * model.margin, mu=mu, k_stiff=k, b_damp=b, d0=d0,
                dspan=dmax - d0, width=width, mid=mid, power=power,
                imp_a=1.0 / mid ** (power - 1.0),
                imp_b=1.0 / (1.0 - mid) ** (power - 1.0),
                pyr=2.0 * mu * mu * (1.0 + mu * mu))


def pack_model(model: AntModel) -> np.ndarray:
    """The model's constants as the kernels read them: one float64 buffer
    (:data:`MODEL_FIELDS`, then :data:`SCALARS`, then :data:`SLOT_WIDTH`
    values per wall slot: the positive and negative wall's lo and hi and
    the slot's axis, an unpaired slot its one box twice on axis 0)."""
    _check_model(model)
    fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
    fields["body_invweight"] = _contact._body_invweight(model)
    fields["dof_invweight"] = _contact._dof_invweight(model)
    parts = []
    for name, n in MODEL_FIELDS:
        a = np.asarray(fields[name], np.float64).reshape(-1)
        if a.size != n:
            raise ValueError(f"{name}: {a.size} values, the kernels take {n}")
        parts.append(a)
    sc = _scalars(model)
    parts.append(np.array([sc[k] for k in SCALARS], np.float64))
    for bpos, bneg, ax in _contact._wall_slots(model.walls):
        neg = bpos if bneg is None else bneg
        parts.append(np.array([*bpos[0], *bpos[1], *neg[0], *neg[1],
                               0 if ax is None else ax], np.float64))
    return np.concatenate(parts)


def unpack_model(buf, n_slots: int) -> dict:
    """The reader of :func:`pack_model`: each field in the model's shape
    (integer fields as int64), ``"scalars"`` a dict and ``"slots"`` a list
    of ``(lo+, hi+, lo-, hi-, axis)``."""
    buf = np.asarray(buf, np.float64)
    size = sum(n for _, n in MODEL_FIELDS) + len(SCALARS) + SLOT_WIDTH * n_slots
    if buf.size != size:
        raise ValueError(f"{buf.size} values, the layout of {n_slots} wall "
                         f"slots holds {size}")
    shapes = {"body_pos": (NB, 3), "body_ipos": (NB, 3),
              "body_inertia": (NB, 3, 3), "dof_mask": (NB, NV),
              "jnt_axis": (NJ, 3), "jnt_range": (NJ, 2), "geom_pos": (NG, 3),
              "geom_axis": (NG, 3)}
    out, at = {}, 0
    for name, n in MODEL_FIELDS:
        a = buf[at:at + n].reshape(shapes.get(name, (n,)))
        out[name] = a.astype(np.int64) if name in _INT_FIELDS else a
        at += n
    out["scalars"] = dict(zip(SCALARS, buf[at:at + len(SCALARS)].tolist()))
    at += len(SCALARS)
    slots = []
    for _ in range(n_slots):
        s = buf[at:at + SLOT_WIDTH]
        slots.append((tuple(s[0:3]), tuple(s[3:6]), tuple(s[6:9]),
                      tuple(s[9:12]), int(s[12])))
        at += SLOT_WIDTH
    out["slots"] = slots
    return out


# ---------------------------------------------------------- static supports

def _hinges(model: AntModel, body: int) -> list:
    """The hinge dofs that move ``body`` (``_hinges_of_body``)."""
    return [int(model.jnt_dof[j]) for j in range(NJ)
            if model.dof_mask[body, int(model.jnt_dof[j])]]


def row_supports(model: AntModel) -> list:
    """Each constraint row's static dof support, in row order: the dofs
    whose entry the JAX scalar pipeline does not drop as a Python zero.

    A limit row holds its hinge's dof.  A contact row ``n ± μ t`` holds the
    three free rotations and the hinges that move the body, and each
    translation dof unless the normal's and the tangent's components are
    both trace-time constants that sum to zero: the torso's floor frame is
    constant (n = z, t1 = y, t2 = -x), a capsule end's floor frame has a
    constant normal and a zero z tangent, a wall frame none."""
    mu = model.friction
    gb = [int(b) for b in model.geom_body]
    torso_floor = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0))
    capsule_floor = ((0.0, 0.0, 1.0), (None, None, 0.0), (None, None, 0.0))
    wall = ((None,) * 3,) * 3
    cands = [(gb[0], torso_floor)]
    cands += [(gb[g], capsule_floor) for g in range(1, NG) for _ in range(2)]
    for _ in _contact._wall_slots(model.walls):
        cands += [(gb[0], wall)]
        cands += [(gb[g], wall) for g in range(1, NG) for _ in range(3)]
    rows = [[int(model.jnt_dof[j])] for j in range(NJ)]
    for body, (n, t1, t2) in cands:
        for t in (t1, t2):
            for sgn in (1.0, -1.0):
                trans = [d for d in range(3)
                         if n[d] is None or t[d] is None
                         or n[d] + sgn * mu * t[d] != 0.0]
                rows.append(trans + [3, 4, 5] + _hinges(model, body))
    return rows


def mass_support(model: AntModel) -> np.ndarray:
    """[NV, NV] bool: the mass matrix's entries that ``mass_matrix_s`` does
    not leave as a Python zero (the diagonal, and each pair of dofs that
    move one body, but two distinct translations)."""
    S = np.eye(NV, dtype=bool)
    for b in range(NB):
        act = [d for d in range(NV) if model.dof_mask[b, d]]
        for d in act:
            for e in act:
                if not (d < 3 and e < 3 and d != e):
                    S[d, e] = True
    return S


def tables(model: AntModel) -> np.ndarray:
    """The int32 table the kernels read: ``row_ptr [ne + 1]``, ``row_dof
    [nnz]`` (each row's support, ascending) and ``m_rows [NV]`` (a bitmask
    of each mass-matrix row's support)."""
    rows = row_supports(model)
    row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    S = mass_support(model)
    m_rows = [sum(1 << e for e in range(NV) if S[d, e]) for d in range(NV)]
    return np.concatenate([row_ptr, np.concatenate(rows), m_rows]).astype(np.int32)


def _levels(model: AntModel) -> list:
    """Each body's depth in the tree: the root 0, a child its parent's + 1."""
    level = [0] * NB
    for b in range(1, NB):
        level[b] = level[int(model.parent[b])] + 1
    return level


def smooth_table(model: AntModel) -> np.ndarray:
    """The tree as ``ant_smooth`` reads it: int32, :data:`SMOOTH_FIELDS` in
    order.  ``level`` is each body's depth (FK runs a level at a time, each
    body from its parent in the level before); ``body_jnt`` and ``body_qpos``
    the hinge that moves a body from its parent and its qpos index (-1:
    none); ``body_dofs`` a bitmask of the dofs that move a body; ``pairs``
    the (body, rotation dof) pairs, body after body, each ``(body << 8) |
    dof`` (-1 past the last), ``pair_base`` each body's first; per dof its
    anchor body (a hinge's child, the torso for the free dofs), its hinge
    (-1 for the free dofs), a bitmask of the bodies it moves and its
    actuator (the last that drives it, as ``actuation_s`` sets them; -1:
    none); ``m_entry`` the entries of the packed lower triangle (column
    after column, entry t at (i, k)) as ``t | i << 8 | k << 16``, the ones
    with the most bodies first (the kernel's lanes take them in turn, so
    each lane's slots weigh alike), and ``m_bodies`` in the same order the
    bodies that add a term to each in ``mass_matrix_s``: those that both
    dofs move, but none to two distinct translations."""
    _check_model(model)
    mask = np.asarray(model.dof_mask) != 0
    jb, jd = np.asarray(model.jnt_body), np.asarray(model.jnt_dof)
    level = _levels(model)
    pairs = [(b << 8) | d for b in range(NB) for d in range(3, NV) if mask[b, d]]
    pair_base = np.cumsum([0] + [int(mask[b, 3:].sum()) for b in range(NB - 1)])
    dof_jnt = [-1] * NV
    for j in range(NJ):
        dof_jnt[int(jd[j])] = j
    dof_act = [-1] * NV
    for k, d in enumerate(np.asarray(model.act_dof)):
        dof_act[int(d)] = k
    entries = []
    for k in range(NV):
        for i in range(k, NV):
            pure = i < 3 and k < 3 and i != k
            entries.append((len(entries) | i << 8 | k << 16, 0 if pure else sum(
                1 << b for b in range(NB) if mask[b, i] and mask[b, k])))
    entries.sort(key=lambda e: -bin(e[1]).count("1"))
    fields = {
        "n_levels": [max(level) + 1], "level": level,
        "parent": np.asarray(model.parent), "body_jnt": np.asarray(model.body_jnt),
        "body_qpos": [int(model.jnt_qpos[j]) if j >= 0 else -1
                      for j in np.asarray(model.body_jnt)],
        "body_dofs": [sum(1 << d for d in range(NV) if mask[b, d])
                      for b in range(NB)],
        "pair_base": pair_base, "pairs": pairs + [-1] * (NPAIR - len(pairs)),
        "dof_anchor": [int(jb[dof_jnt[d]]) if dof_jnt[d] >= 0 else 0
                       for d in range(NV)],
        "dof_jnt": dof_jnt,
        "dof_bodies": [sum(1 << b for b in range(NB) if mask[b, d])
                       for d in range(NV)],
        "dof_act": dof_act, "m_entry": [e for e, _ in entries],
        "m_bodies": [bs for _, bs in entries],
    }
    parts = []
    for name, n in SMOOTH_FIELDS:
        a = np.asarray(fields[name], np.int64).reshape(-1)
        assert a.size == n, name
        parts.append(a)
    return np.concatenate(parts).astype(np.int32)


def units(model: AntModel) -> np.ndarray:
    """``ant_rows``' units, one thread's work for one env: int32 ``[n,
    len(UNIT_FIELDS)]`` in the JAX candidate order (``contact_candidates_s``:
    the floor spheres, the torso and each capsule's two ends, then per wall
    slot the torso and each capsule's three slots), after the 8 limit rows.
    ``index`` is a limit row's hinge, else the unit's first candidate (a
    capsule-box unit holds three); ``body`` and ``geom`` are the
    candidate's (-1 for a limit row), ``slot`` its wall slot (-1 on the
    floor), ``end`` a floor capsule end's (0 the segment's start, 1 its end);
    ``hinge0``, ``hinge1`` the hinge dofs that move the body, ascending (-1:
    none)."""
    _check_model(model)
    gb = [int(b) for b in model.geom_body]

    def unit(kind, index, geom=-1, slot=-1, end=0):
        body = gb[geom] if geom >= 0 else -1
        hinges = _hinges(model, body) if body >= 0 else []
        return [kind, index, body, geom, slot, end,
                *(hinges + [-1, -1])[:2]]

    out = [unit(U_LIMIT, j) for j in range(NJ)]
    out.append(unit(U_FLOOR_TORSO, 0, 0))
    out += [unit(U_FLOOR_END, 1 + 2 * i + end, 1 + i, end=end)
            for i in range(NCAP) for end in (0, 1)]
    for s in range(len(_contact._wall_slots(model.walls))):
        base = NFLOOR + NSLOT_CAND * s
        out.append(unit(U_WALL_TORSO, base, 0, s))
        out += [unit(U_WALL_CAPSULE, base + 1 + 3 * i, 1 + i, s)
                for i in range(NCAP)]
    return np.array(out, np.int32)


# ------------------------------------------------------------------ plans

_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _capturing(device) -> bool:
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


class _Plan:
    """What the kernels read for one model, dtype and device: the model
    buffer, the support and tree tables, and the buffers of each batch
    size."""

    def __init__(self, model: AntModel, dtype: torch.dtype, device):
        self.dtype, self.device = dtype, torch.device(device)
        rows = row_supports(model)
        self.units = torch.as_tensor(units(model), device=device)
        self.n_slots = len(_contact._wall_slots(model.walls))
        self.ne = len(rows)
        self.nnz = sum(len(r) for r in rows)
        self.row = torch.as_tensor(np.repeat(np.arange(self.ne), [len(r) for r in rows]),
                                   device=device)
        self.dof = torch.as_tensor(np.concatenate(rows), device=device)
        self.model = torch.as_tensor(pack_model(model), dtype=dtype, device=device)
        self.tables = torch.as_tensor(tables(model), device=device)
        self.smooth_table = torch.as_tensor(smooth_table(model), device=device)
        self.buffers: dict = {}
        if self.device.type == "cuda" and (
                _lib().ant_forward_model_len(self.n_slots) != self.model.numel()
                or _lib().ant_forward_unit_width() != len(UNIT_FIELDS)
                or _lib().ant_smooth_table_len() != self.smooth_table.numel()):
            raise RuntimeError("the model buffer's, the units' or the tree "
                               "table's layout is not the kernels'")

    def batch(self, B: int):
        """(smooth, rows) buffers of batch ``B``, made once."""
        dtype, device = self.dtype, self.device
        if B not in self.buffers:
            if _capturing(device):
                raise RuntimeError("the ant kernels' first call at a batch size "
                                   "must run eagerly, before any CUDA graph "
                                   "capture")

            def new(*shape):
                return torch.empty(shape, dtype=dtype, device=device)

            self.buffers[B] = (
                Smooth(new(NV * NV, B), new(NV, B), new(SKIN, B)),
                Rows(new(self.nnz, B), new(self.ne, B), new(self.ne, B),
                     new(self.ne, B)))
        return self.buffers[B]


def _plan(model: AntModel, dtype: torch.dtype, device) -> _Plan:
    device = torch.device(device)
    per_model = _PLANS.setdefault(model, {})
    key = (dtype, device)
    if key not in per_model:
        if _capturing(device):
            raise RuntimeError("the ant kernels' first call must run eagerly, "
                               "before any CUDA graph capture")
        per_model[key] = _Plan(model, dtype, device)
    return per_model[key]


# ---------------------------------------------------------------- launchers

@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library("ant_forward")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ant_forward_model_len.argtypes = [i]
    lib.ant_forward_model_len.restype = i
    lib.ant_forward_unit_width.argtypes = []
    lib.ant_forward_unit_width.restype = i
    lib.ant_smooth_table_len.argtypes = []
    lib.ant_smooth_table_len.restype = i
    lib.ant_newton_smem_bytes.argtypes = [i, i]
    lib.ant_newton_smem_bytes.restype = ctypes.c_longlong
    lib.ant_newton_rows_cap.argtypes = []
    lib.ant_newton_rows_cap.restype = i
    lib.ant_smooth_launch.argtypes = [i, i] + [p] * 9
    lib.ant_rows_launch.argtypes = [i] * 5 + [p] * 11
    lib.ant_newton_launch.argtypes = [i] * 5 + [p] * 12
    for fn in (lib.ant_smooth_launch, lib.ant_rows_launch, lib.ant_newton_launch):
        fn.restype = i
    return lib


def _dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise ValueError(f"the ant kernels take float32 or float64, not {dtype}")


def _check(x: torch.Tensor, shape: tuple, dtype, device, name: str) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} "
                         f"on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, device, *args) -> None:
    """``name``'s launcher on ``device``, made current, and its current
    stream (the stream is the launcher's last argument)."""
    with torch.cuda.device(device):
        err = getattr(_lib(), f"{name}_launch")(
            *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def newton_smem_bytes(model: AntModel, dtype: torch.dtype) -> int:
    """``ant_newton``'s dynamic shared memory a block (its envs' M, factor,
    vectors, active-row indices and rows in shared memory), from the
    kernels' library."""
    return int(_lib().ant_newton_smem_bytes(_dtype_code(dtype),
                                            len(row_supports(model))))


def newton_rows_cap() -> int:
    """``ant_newton``'s active rows an env kept in shared memory for the
    whole solve; more are restaged chunk by chunk in every pass."""
    return int(_lib().ant_newton_rows_cap())


def _ptr(x):
    return None if x is None else x.data_ptr()


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ------------------------------------------------------------------ twins

def _batch_mass(M: torch.Tensor) -> torch.Tensor:
    """``M [NV * NV, B]`` as ``[B, NV, NV]`` (a view)."""
    return M.reshape(NV, NV, -1).permute(2, 0, 1)


def _skin_kinematics(model: AntModel, skin: torch.Tensor) -> _dynamics.Kinematics:
    """The batched :class:`~gym_po_tpu_torch.physics.dynamics.Kinematics`
    that ``constraint_rows`` reads, from ``skin [SKIN, B]`` (the fields it
    does not read are None)."""
    B = skin.shape[1]
    parts, at = {}, 0
    for name, shape in SKIN_FIELDS:
        n = int(np.prod(shape))
        parts[name] = skin[at:at + n].T.reshape((B,) + shape)
        at += n
    t = _dynamics.model_tensors(model, skin.dtype, skin.device)
    return _dynamics.Kinematics(xpos=parts["xpos"], xquat=None,
                                xmat=parts["xmat"], com=None, inertia_w=None,
                                dof_u=parts["dof_u"], dof_p=parts["dof_p"],
                                trans=t.trans, jp=None, jr=None)


def dense_rows(model: AntModel, rows: Rows) -> _contact.ConstraintRows:
    """``rows`` as the batched :class:`ConstraintRows` ``[B, ...]`` of the
    array engine, each row's support scattered into a dense Jacobian."""
    p = _plan(model, rows.vals.dtype, rows.vals.device)
    B = rows.vals.shape[1]
    jac = rows.vals.new_zeros(B, p.ne, NV)
    jac[:, p.row, p.dof] = rows.vals.T
    return _contact.ConstraintRows(jac_t=jac.mT, aref=rows.aref.T,
                                   r=rows.r.T, active=rows.active.T)


def smooth_twin(model: AntModel, qpos, qvel, ctrl) -> Smooth:
    """Plain version of :func:`ant_smooth`: ``dynamics.smooth_forward``."""
    kin, M, qs, _ = _dynamics.smooth_forward(model, qpos, qvel, ctrl)
    B = qpos.shape[0]
    skin = torch.cat([getattr(kin, name).reshape(B, -1)
                      for name, _ in SKIN_FIELDS], 1)
    return Smooth(M.reshape(B, NV * NV).T.contiguous(), qs.T.contiguous(),
                  skin.T.contiguous())


def rows_twin(model: AntModel, skin, qpos, qvel) -> Rows:
    """Plain version of :func:`ant_rows`: ``contact.constraint_rows`` on
    the kinematics in ``skin``, its Jacobian gathered over the supports."""
    p = _plan(model, skin.dtype, skin.device)
    rows = _contact.constraint_rows(model, _skin_kinematics(model, skin), qpos,
                                    qvel)
    return Rows(rows.jac[:, p.row, p.dof].T.contiguous(),
                rows.aref.T.contiguous(), rows.r.T.contiguous(),
                rows.active.T.contiguous())


def newton_twin(model: AntModel, smooth: Smooth, rows: Rows, warm=None,
                iters: int = 8, ls_iters: int = 10):
    """Plain version of :func:`ant_newton`:
    ``contact.solve_constraints_newton`` on the densified rows, from
    ``qacc_smooth + warm``."""
    qs = smooth.qacc_smooth.T
    q0 = qs if warm is None else qs + warm
    q, _ = _contact.solve_constraints_newton(
        model, _batch_mass(smooth.M), qs, dense_rows(model, rows), iters=iters,
        ls_iters=ls_iters, qacc0=q0)
    return q, q - qs


# ---------------------------------------------------------------- kernels

def ant_smooth(model: AntModel, qpos: torch.Tensor, qvel: torch.Tensor,
               ctrl: torch.Tensor, out: Smooth = None) -> Smooth:
    """Smooth dynamics of ``qpos [B, 15]``, ``qvel [B, 14]``, ``ctrl
    [B, 8]``: the kernel on a CUDA tensor (into ``out`` when given), the
    twin on a CPU tensor."""
    B, dt, dev = qpos.shape[0], qpos.dtype, qpos.device
    for x, n, name in ((qpos, NQ, "qpos"), (qvel, NV, "qvel"), (ctrl, NU, "ctrl")):
        _check(x, (B, n), dt, dev, name)
    if _device_kind(qpos) == "cpu":
        return smooth_twin(model, qpos, qvel, ctrl)
    p = _plan(model, dt, dev)
    if out is None:
        out = Smooth(*(torch.empty(n, B, dtype=dt, device=dev)
                       for n in (NV * NV, NV, SKIN)))
    _launch("ant_smooth", dev, _dtype_code(dt), B, _ptr(p.model),
            _ptr(p.smooth_table), _ptr(qpos), _ptr(qvel), _ptr(ctrl),
            *map(_ptr, out))
    count_launch(ant_smooth, "ant_smooth")
    return out


def ant_rows(model: AntModel, skin: torch.Tensor, qpos: torch.Tensor,
             qvel: torch.Tensor, out: Rows = None) -> Rows:
    """Constraint rows from ``skin [SKIN, B]`` (:func:`ant_smooth`'s),
    ``qpos`` and ``qvel``: the kernel on a CUDA tensor (into ``out`` when
    given), the twin on a CPU tensor."""
    B, dt, dev = qpos.shape[0], qpos.dtype, qpos.device
    _check(skin, (SKIN, B), dt, dev, "skin")
    _check(qpos, (B, NQ), dt, dev, "qpos")
    _check(qvel, (B, NV), dt, dev, "qvel")
    if _device_kind(qpos) == "cpu":
        return rows_twin(model, skin, qpos, qvel)
    p = _plan(model, dt, dev)
    if out is None:
        out = Rows(*(torch.empty(n, B, dtype=dt, device=dev)
                     for n in (p.nnz, p.ne, p.ne, p.ne)))
    _launch("ant_rows", dev, _dtype_code(dt), B, p.n_slots, p.ne, len(p.units),
            _ptr(p.model), _ptr(p.tables), _ptr(p.units), _ptr(skin),
            _ptr(qpos), _ptr(qvel), *map(_ptr, out))
    count_launch(ant_rows, "ant_rows")
    return out


def ant_newton(model: AntModel, smooth: Smooth, rows: Rows, warm=None,
               iters: int = 8, ls_iters: int = 10):
    """The primal Newton solve → ``(qacc, qacc - qacc_smooth)``, each
    ``[B, 14]``, from ``qacc_smooth + warm`` (``warm [B, 14]`` or None):
    the kernel on a CUDA tensor, the twin on a CPU tensor.  With spans on
    (:func:`~gym_po_tpu_torch.utils.profiling.enable_spans`) either adds
    the active rows of every env to the ``ant.active_rows`` counter: the
    kernel with one atomic add a block, into the counter whose pointer a
    CUDA graph keeps."""
    dt, dev = smooth.M.dtype, smooth.M.device
    B = smooth.M.shape[1]
    p = _plan(model, dt, dev)
    _check(smooth.M, (NV * NV, B), dt, dev, "M")
    _check(smooth.qacc_smooth, (NV, B), dt, dev, "qacc_smooth")
    for x, n, name in zip(rows, (p.nnz, p.ne, p.ne, p.ne), Rows._fields):
        _check(x, (n, B), dt, dev, name)
    if warm is not None:
        _check(warm, (B, NV), dt, dev, "warm")
    if iters < 0 or ls_iters < 0:
        raise ValueError("iters and ls_iters must be >= 0")
    if _device_kind(smooth.M) == "cpu":
        count_nonzero("ant.active_rows", rows.active)
        return newton_twin(model, smooth, rows, warm, iters, ls_iters)
    qacc = torch.empty(B, NV, dtype=dt, device=dev)
    warm_out = torch.empty_like(qacc)
    _launch("ant_newton", dev, _dtype_code(dt), B, p.ne, iters, ls_iters,
            _ptr(p.tables), _ptr(smooth.M), _ptr(smooth.qacc_smooth),
            *map(_ptr, rows), _ptr(warm), _ptr(qacc), _ptr(warm_out),
            _ptr(counter("ant.active_rows", dev)))
    count_launch(ant_newton, "ant_newton")
    return qacc, warm_out


for _fn in (ant_smooth, ant_rows, ant_newton):
    _fn.launches = 0


def forward(model: AntModel, qpos: torch.Tensor, qvel: torch.Tensor,
            ctrl: torch.Tensor, warm=None, iters: int = 10,
            ls_iters: int = 10):
    """Constrained forward dynamics of a batch ``[B, n]`` → ``(qacc,
    qacc - qacc_smooth)``: ``ant_smooth`` → ``ant_rows`` → ``ant_newton``,
    on a CUDA tensor into the buffers of this (model, batch, dtype,
    device) (on a CPU tensor each wrapper runs its twin)."""
    sm_buf, rows_buf = _plan(model, qpos.dtype, qpos.device).batch(qpos.shape[0])
    smooth = ant_smooth(model, qpos, qvel, ctrl, out=sm_buf)
    rows = ant_rows(model, smooth.skin, qpos, qvel, out=rows_buf)
    return ant_newton(model, smooth, rows, warm, iters, ls_iters)
