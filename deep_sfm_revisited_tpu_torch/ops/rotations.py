"""Rotation helpers (port of `deep_sfm_revisited_tpu/ops/rotations.py`).

The cross-product matrix, the SO(3) exponential map of the
essential-matrix polish, the 'sxyz' Euler conversions, the quaternion
conversions, the reference's `pose_vec2mat` and `Pose2RT`/`RT2Pose`
(PoseNet's output and the pose tools), rigid-transform inversion and
composition, and the geodesic rotation error. Shape-polymorphic over
leading batch dims, like the JAX functions.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map (Rodrigues). omega: (..., 3) -> (..., 3, 3).

    Series fallback near zero, as the JAX version (`rotations.py:57-75`).
    """
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-12
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    K = skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def angle_to_matrix(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles (ax, ay, az), 'sxyz': R = Rz(az) @ Ry(ay) @ Rx(ax).

    angle: (..., 3) -> (..., 3, 3).
    """
    ai, aj, ak = angle[..., 0], angle[..., 1], angle[..., 2]
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    row0 = torch.stack([cj * ck, sj * sc - cs, sj * cc + ss], dim=-1)
    row1 = torch.stack([cj * sk, sj * ss + cc, sj * cs - sc], dim=-1)
    row2 = torch.stack([-sj, cj * si, cj * ci], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_angular_error(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between rotations, (...,3,3)x2 -> (...)."""
    cos = (torch.einsum("...ij,...ij->...", R1, R2) - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def matrix_to_quat(M: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), by the
    branch-free max-component construction of the JAX function (`:108-131`)."""
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    tr = m00 + m11 + m22
    zero = torch.zeros_like(tr)
    qw = torch.sqrt(torch.maximum(zero, 1.0 + tr)) / 2
    qx = torch.sqrt(torch.maximum(zero, 1.0 + m00 - m11 - m22)) / 2
    qy = torch.sqrt(torch.maximum(zero, 1.0 - m00 + m11 - m22)) / 2
    qz = torch.sqrt(torch.maximum(zero, 1.0 - m00 - m11 + m22)) / 2

    def sign_of(ref):
        return torch.where(ref >= 0, 1.0, -1.0).to(ref.dtype)

    qx = qx * sign_of(M[..., 2, 1] - M[..., 1, 2])
    qy = qy * sign_of(M[..., 0, 2] - M[..., 2, 0])
    qz = qz * sign_of(M[..., 1, 0] - M[..., 0, 1])
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def matrix_to_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> Euler angles (ax, ay, az), 'sxyz', with the
    gimbal-lock branch as a `where` (JAX `rotations.py:36-54`).
    matrix: (..., 3, 3) -> (..., 3)."""
    M = matrix
    cy = torch.sqrt(M[..., 0, 0] ** 2 + M[..., 1, 0] ** 2)
    safe = cy > 4e-15
    ax = torch.where(safe, torch.atan2(M[..., 2, 1], M[..., 2, 2]),
                     torch.atan2(-M[..., 1, 2], M[..., 1, 1]))
    ay = torch.atan2(-M[..., 2, 0], cy)
    az = torch.where(safe, torch.atan2(M[..., 1, 0], M[..., 0, 0]), torch.zeros_like(cy))
    return torch.stack([ax, ay, az], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalized first -> rotation matrix.
    (..., 4) -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                       dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                       dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pose_vec2mat(vec: torch.Tensor) -> torch.Tensor:
    """6DoF (tx, ty, tz, rx, ry, rz), translation first -> (..., 3, 4)."""
    return torch.cat([angle_to_matrix(vec[..., 3:]), vec[..., :3, None]], dim=-1)


def pose_to_rt(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (ax, ay, az, tx, ty, tz), the reference's `Pose2RT`."""
    return torch.cat([matrix_to_angle(pose[..., :3, :3]), pose[..., :3, 3]], dim=-1)


def rt_to_pose(rt: torch.Tensor) -> torch.Tensor:
    """(ax, ay, az, tx, ty, tz) -> (..., 3, 4), the reference's `RT2Pose`."""
    return torch.cat([angle_to_matrix(rt[..., :3]), rt[..., 3:, None]], dim=-1)


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Invert a (..., 3, 4) rigid transform: (R, t) -> (R^T, -R^T t)."""
    Rt = pose[..., :3, :3].transpose(-1, -2)
    return torch.cat([Rt, -Rt @ pose[..., :3, 3:]], dim=-1)


def compose_pose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (..., 3, 4) rigid transforms: a @ b (apply b, then a)."""
    Ra, ta = a[..., :3, :3], a[..., :3, 3:]
    return torch.cat([Ra @ b[..., :3, :3], Ra @ b[..., :3, 3:] + ta], dim=-1)
