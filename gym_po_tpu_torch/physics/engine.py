"""Forward dynamics + RK4 / Euler integration, the ant simulator's outer
loop: PyTorch port of :mod:`gym_po_tpu.physics.engine`.

Mirrors MuJoCo's pipeline (``mj_forward`` → ``mj_RungeKutta``):

* :func:`forward` = smooth dynamics (:mod:`.dynamics`) + constraint rows
  and the primal Newton solve (:mod:`.contact`) → ``(qacc, qacc -
  qacc_smooth)``.  The second value is the warm start of the next solve.
* :func:`rk4_step` = the classic 4-stage tableau on the qpos manifold:
  stage positions integrate the stage velocities from the step's start
  via the quaternion exponential map (``mj_RungeKutta`` +
  ``mj_integratePos``); the warm start runs through all four stages.
* :func:`euler_step` = semi-implicit Euler, one constrained forward per
  step.
* :func:`step` = ``frame_skip`` integrator steps with the control held,
  the warm start carried across them.

Every function takes a batch ``[..., nq]`` and follows ``qpos``'s dtype
and device.  ``pipeline=`` names the JAX package's two forms.
``"scalar"`` (the default, as there) on a CUDA tensor runs the three
hand-written kernels of :mod:`gym_po_tpu_torch.ops.ant_forward`, one env
per thread (``ant_smooth`` → ``ant_rows`` → ``ant_newton``); a failed build
or launch raises.  On a CPU tensor ``"scalar"``, and ``"array"`` on any
device, run the batched tensor code of :mod:`.dynamics` and
:mod:`.contact` (the JAX package's array pipeline), the kernels' plain
twin.  ``unroll=`` (a ``lax.scan`` knob there) is accepted and has no
effect.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import annotate, count_nonzero
from .ant_model import AntModel
from .contact import constraint_rows, solve_constraints_newton
from .dynamics import smooth_forward
from .spatial import quat_integrate, quat_normalize

__all__ = [
    "PhysicsState", "init_state", "forward", "rk4_step", "euler_step", "step",
    "PIPELINES", "INTEGRATORS",
]

PIPELINES = ("scalar", "array")
INTEGRATORS = ("rk4", "euler")


class PhysicsState(NamedTuple):
    qpos: torch.Tensor  # [..., nq]
    qvel: torch.Tensor  # [..., nv]
    warm: torch.Tensor  # [..., nv] warm start: previous (qacc - qacc_smooth)

    @classmethod
    def from_numpy(cls, qpos, qvel, warm, device="cuda") -> "PhysicsState":
        """A state from numpy arrays (e.g. the JAX package's
        ``PhysicsState`` fields through ``np.asarray``), dtypes kept."""
        return cls(*(torch.as_tensor(np.array(x)).to(device)
                     for x in (qpos, qvel, warm)))


def init_state(model: AntModel, qpos, qvel) -> PhysicsState:
    qpos = torch.as_tensor(qpos)
    return PhysicsState(qpos, torch.as_tensor(qvel, dtype=qpos.dtype,
                                              device=qpos.device),
                        qpos.new_zeros(qpos.shape[:-1] + (model.nv,)))


def _check_pipeline(pipeline: str) -> None:
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}")


def forward(model: AntModel, qpos, qvel, ctrl, warm=None, iters: int = 10,
            ls_iters: int = 10, pipeline: str = "scalar"):
    """Constrained forward dynamics of a batch → (qacc, warm_out).

    ``warm`` is the previous constraint correction ``qacc - qacc_smooth``;
    Newton starts from ``qacc_smooth + warm`` (no warm start = the
    unconstrained solution).  ``ls_iters`` = bisections per line search.
    ``pipeline="scalar"`` on a CUDA tensor runs the per-env kernels.
    """
    _check_pipeline(pipeline)
    with annotate("ant.forward", qpos.device):
        lead = qpos.shape[:-1]
        qpos, qvel = qpos.reshape(-1, model.nq), qvel.reshape(-1, model.nv)
        ctrl = ctrl.to(qpos.dtype).reshape(-1, ctrl.shape[-1]).expand(qpos.shape[0], -1)
        if pipeline == "scalar" and qpos.device.type == "cuda":
            from ..ops import ant_forward  # here: ops imports the envs, which import this

            qacc, w = ant_forward.forward(
                model, qpos.contiguous(), qvel.contiguous(), ctrl.contiguous(),
                None if warm is None else warm.reshape(-1, model.nv).contiguous(),
                iters, ls_iters)
            return qacc.reshape(lead + (model.nv,)), w.reshape(lead + (model.nv,))
        kin, M, qacc_smooth, _ = smooth_forward(model, qpos, qvel, ctrl)
        rows = constraint_rows(model, kin, qpos, qvel)
        count_nonzero("ant.active_rows", rows.active)
        q0 = qacc_smooth if warm is None else qacc_smooth + warm.reshape(-1, model.nv)
        qacc, _ = solve_constraints_newton(model, M, qacc_smooth, rows, iters=iters,
                                           ls_iters=ls_iters, qacc0=q0)
        return (qacc.reshape(lead + (model.nv,)),
                (qacc - qacc_smooth).reshape(lead + (model.nv,)))


def _integrate_pos(model: AntModel, qpos, qvel_avg, dt):
    """MuJoCo ``mj_integratePos``: linear position + local-frame quaternion
    exponential + hinge angles."""
    pos = qpos[..., 0:3] + dt * qvel_avg[..., 0:3]
    quat = quat_normalize(quat_integrate(qpos[..., 3:7], qvel_avg[..., 3:6], dt))
    hinges = qpos[..., 7:] + dt * qvel_avg[..., 6:]
    return torch.cat([pos, quat, hinges], -1)


# stage position/velocity coefficients and quadrature weights; the classic
# tableau's A has a single nonzero per row, so stage i only needs stage i-1
_RK_C = (0.0, 0.5, 0.5, 1.0)
_RK_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def rk4_step(model: AntModel, state: PhysicsState, ctrl, iters: int = 10,
             ls_iters: int = 10, pipeline: str = "scalar") -> PhysicsState:
    """One RK4 step of length ``model.dt`` (== ``mj_RungeKutta(m, d, 4)``),
    the warm start carried through the four stages."""
    dt = model.dt
    qpos0, qvel0 = state.qpos, state.qvel
    vel_prev, acc_prev, w = qvel0, torch.zeros_like(qvel0), state.warm
    vsum = asum = torch.zeros_like(qvel0)
    for c, b in zip(_RK_C, _RK_B):
        qpos_i = _integrate_pos(model, qpos0, c * vel_prev, dt)
        qvel_i = qvel0 + (dt * c) * acc_prev
        acc_i, w = forward(model, qpos_i, qvel_i, ctrl, w, iters, ls_iters,
                           pipeline)
        vsum = vsum + b * qvel_i
        asum = asum + b * acc_i
        vel_prev, acc_prev = qvel_i, acc_i
    return PhysicsState(_integrate_pos(model, qpos0, vsum, dt),
                        qvel0 + dt * asum, w)


def euler_step(model: AntModel, state: PhysicsState, ctrl, iters: int = 10,
               ls_iters: int = 10, pipeline: str = "scalar") -> PhysicsState:
    """One semi-implicit Euler step: ``qvel' = qvel + dt qacc``, the position
    integrated with the NEW velocity.  A speed knob, not a parity path (the
    reference models pin RK4; MuJoCo's own Euler treats joint damping
    implicitly)."""
    qacc, w = forward(model, state.qpos, state.qvel, ctrl, state.warm, iters,
                      ls_iters, pipeline)
    qvel = state.qvel + model.dt * qacc
    return PhysicsState(_integrate_pos(model, state.qpos, qvel, model.dt),
                        qvel, w)


def step(model: AntModel, state: PhysicsState, ctrl, frame_skip: int = 15,
         iters: int = 10, integrator: str = "rk4", ls_iters: int = 10,
         unroll: int = 1, pipeline: str = "scalar") -> PhysicsState:
    """``frame_skip`` integrator steps with ``ctrl`` held
    (``MujocoEnv.do_simulation``).  ``integrator``: ``"rk4"`` (the
    reference setting) or ``"euler"``.  ``unroll`` has no effect here."""
    if integrator == "rk4":
        substep = rk4_step
    elif integrator == "euler":
        substep = euler_step
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    _check_pipeline(pipeline)
    for _ in range(frame_skip):
        state = substep(model, state, ctrl, iters, ls_iters, pipeline)
    return state
