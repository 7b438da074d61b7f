"""Quaternion / SE(3) transforms (port of ``puzzlefusion_plusplus_tpu/utils/transforms.py``).

Quaternions are scalar-first ``(w, x, y, z)``; rotations act on column vectors, ``v' = R v``.
Euler angles use the XYZ convention ``M = Rx(a) @ Ry(b) @ Rz(c)``. Every function broadcasts
over leading dims.
"""

from __future__ import annotations

import math

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """[..., 4] -> unit [..., 4]."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of scalar-first quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    ux, uy, uz = u.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    return torch.stack([uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` [..., 3] by unit ``q`` [..., 4]: v + 2w(u x v) + 2u x (u x v)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_apply_raw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vector part of q (0, v) q* WITHOUT normalizing q (scales by |q|^2 for non-unit q)."""
    p = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_multiply(quat_multiply(q, p), quat_conjugate(q))[..., 1:]


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate clouds ``v`` [..., N, 3] by ``q``; q broadcasts over the point dim."""
    if q.dim() == v.dim() - 1:
        q = q[..., None, :]
    return quat_apply(q, v)


def qtransform(t: torch.Tensor, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if t.dim() == v.dim() - 1:
        t = t[..., None, :]
    return qrot(q, v) + t


def transform_pc(trans: torch.Tensor, rot: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Apply a 7-DoF pose (trans [..., 3], quat [..., 4]) to clouds [..., N, 3]."""
    return qtransform(trans, rot, pc)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = torch.stack(
        [
            1.0 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1.0 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1.0 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> scalar-first unit quaternion [..., 4] (branchless Shepperd selection)."""
    batch = m.shape[:-2]
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def _sqrt_pos(x):
        return torch.sqrt(x.clamp_min(0.0))

    q_abs = torch.stack(
        [
            _sqrt_pos(1.0 + m00 + m11 + m22),
            _sqrt_pos(1.0 + m00 - m11 - m22),
            _sqrt_pos(1.0 - m00 + m11 - m22),
            _sqrt_pos(1.0 - m00 - m11 + m22),
        ],
        dim=-1,
    )
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    cand = cand / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs.argmax(-1)
    q = torch.take_along_dim(cand, best[..., None, None].expand(batch + (1, 4)), dim=-2)
    return quat_normalize(q.reshape(batch + (4,)))


def matrix_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    b = torch.asin(m[..., 0, 2].clamp(-1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def quat_to_euler(q: torch.Tensor, to_degree: bool = True) -> torch.Tensor:
    e = matrix_to_euler_xyz(quat_to_matrix(quat_normalize(q)))
    return e * (180.0 / math.pi) if to_degree else e


def pose_to_affine(trans: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """(trans [..., 3], quat [..., 4]) -> [..., 4, 4] (rotation then translation)."""
    batch = trans.shape[:-1]
    top = torch.cat([quat_to_matrix(quat), trans[..., :, None]], dim=-1)
    # the row [0, 0, 0, 1] made on the device: a tensor built from a host list is a blocking
    # copy, which would make the engine's every denoising step wait for the card
    bottom = torch.eye(4, dtype=trans.dtype, device=trans.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def affine_to_pose(affine: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return affine[..., :3, 3], matrix_to_quat(affine[..., :3, :3])
