"""Quaternion / SO(3) algebra for the ant engine, PyTorch port of
:mod:`gym_po_tpu.physics.spatial`.

Every function works over a trailing axis (``[..., 4]`` quaternions,
``[..., 3]`` vectors) and broadcasts over the leading ones.  Quaternions use
MuJoCo's ``[w, x, y, z]`` layout, so states compare directly with MuJoCo's
``qpos``.
"""

from __future__ import annotations

import torch

__all__ = [
    "cross",
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_rotate_inv",
    "quat_to_mat",
    "axis_angle_quat",
    "quat_integrate",
    "quat_normalize",
]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a × b`` over the trailing axis, broadcasting the leading ones."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q ⊗ p`` ([..., 4] wxyz)."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` [..., 3] by quaternion(s) ``q`` [..., 4]
    (the expanded form: no intermediate quaternion products)."""
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] with ``R @ v_body = v_world``."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def axis_angle_quat(axis_times_angle: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector [..., 3] → quaternion [..., 4],
    with the series ``1/2 - angle²/48`` for sin(angle/2)/angle near 0."""
    angle = torch.linalg.vector_norm(axis_times_angle, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-8
    s = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.where(small, 1.0, angle))
    return torch.cat([torch.cos(half), s * axis_times_angle], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor,
                   dt) -> torch.Tensor:
    """MuJoCo ``mj_integratePos`` for a free joint's orientation: rotate by
    the *local-frame* angular velocity, ``q ⊗ exp(ω_local·dt)``."""
    return quat_mul(q, axis_angle_quat(omega_local * dt))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
