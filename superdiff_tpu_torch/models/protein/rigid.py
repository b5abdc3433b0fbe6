"""SO(3)/SE(3) algebra: quaternions, rotation matrices, rotation vectors
(port of ``superdiff_tpu/models/protein/rigid.py``).

Plain torch functions batched over any leading dims. Rigids use the
tensor-7 layout ``[qw, qx, qy, qz, tx, ty, tz]`` (quaternion first).
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w,x,y,z], branch-free: the four
    candidates from the diagonal combinations, the best-conditioned one
    picked by ``argmax`` (the first maximum, as ``jnp.argmax``), sign
    canonicalised to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c, d):
        s = torch.sqrt(torch.clamp_min(t, 1e-12)) * 2.0
        return torch.stack([a(s), b(s), c(s), d(s)], dim=-1), t

    q0, t0 = cand(
        1.0 + tr,
        lambda s: 0.25 * s,
        lambda s: (m21 - m12) / s,
        lambda s: (m02 - m20) / s,
        lambda s: (m10 - m01) / s,
    )
    q1, t1 = cand(
        1.0 + m00 - m11 - m22,
        lambda s: (m21 - m12) / s,
        lambda s: 0.25 * s,
        lambda s: (m01 + m10) / s,
        lambda s: (m02 + m20) / s,
    )
    q2, t2 = cand(
        1.0 - m00 + m11 - m22,
        lambda s: (m02 - m20) / s,
        lambda s: (m01 + m10) / s,
        lambda s: 0.25 * s,
        lambda s: (m12 + m21) / s,
    )
    q3, t3 = cand(
        1.0 - m00 - m11 + m22,
        lambda s: (m10 - m01) / s,
        lambda s: (m02 + m20) / s,
        lambda s: (m12 + m21) / s,
        lambda s: 0.25 * s,
    )
    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = torch.argmax(ts, dim=-1)
    q = torch.gather(qs, -2, idx[..., None, None].expand(idx.shape + (1, 4))).squeeze(-2)
    # canonical sign: w >= 0
    return quat_normalize(q * torch.where(q[..., :1] < 0, -1.0, 1.0))


def rotvec_to_rotmat(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (rotation vector) -> rotation matrix via Rodrigues; the
    ``sin(t)/t`` and ``(1-cos(t))/t^2`` factors take their Taylor forms
    below ``eps`` (value and gradient finite at the origin)."""
    theta2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = theta2 < eps
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    kx, ky, kz = v.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], dim=-1)
    K = K.reshape(v.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + A[..., None] * K + B[..., None] * (K @ K)


def rotmat_to_rotvec(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix -> axis-angle via the quaternion logarithm; at the
    identity ``2 atan2(n, w) / n`` takes its limit ``2 / w``."""
    q = rotmat_to_quat(m)
    w = q[..., :1]
    xyz = q[..., 1:]
    n2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = n2 < eps
    n_safe = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    theta = 2.0 * torch.atan2(n_safe, w)
    scale = torch.where(small, 2.0 / torch.clamp_min(w, 0.5), theta / n_safe)
    return xyz * scale


def rotvec_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose rotation vectors: R(out) = R(a) @ R(b)."""
    return rotmat_to_rotvec(rotvec_to_rotmat(a) @ rotvec_to_rotmat(b))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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


def project_rotmat(m: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation matrix onto SO(3) via SVD."""
    u, _, vt = torch.linalg.svd(m, full_matrices=False)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (u * d[..., None, :]) @ vt


# Tensor-7 rigid helpers ------------------------------------------------------


def rigid(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_normalize(quat), trans], dim=-1)


def rigid_quat(r7: torch.Tensor) -> torch.Tensor:
    return r7[..., :4]


def rigid_trans(r7: torch.Tensor) -> torch.Tensor:
    return r7[..., 4:]


def rigid_rotmat(r7: torch.Tensor) -> torch.Tensor:
    return quat_to_rotmat(r7[..., :4])


def rigid_identity(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    r = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    r[..., 0] = 1.0
    return r


def scale_trans(r7: torch.Tensor, s: float) -> torch.Tensor:
    """``r7`` with its translation multiplied by ``s`` (JAX's
    ``r7.at[..., 4:].multiply(s)``)."""
    return torch.cat([r7[..., :4], r7[..., 4:] * s], dim=-1)


def rigid_apply(r7: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply the transform to points (..., 3)."""
    return (rigid_rotmat(r7) @ points[..., None])[..., 0] + rigid_trans(r7)


def rigid_compose_rotvec(r7, rotvec, dtrans):
    """Right-compose a rotation-vector update and add a translation delta."""
    rot = rigid_rotmat(r7) @ rotvec_to_rotmat(rotvec)
    return rigid(rotmat_to_quat(rot), rigid_trans(r7) + dtrans)


def rigid_compose_q_update(r7, update6, mask):
    """AF2 backbone update (openfold ``Rigid.compose_q_update_vec``):
    ``update6[..., :3]`` are the (x, y, z) of a non-unit quaternion update
    (1, x, y, z) composed on the right; ``update6[..., 3:]`` a translation
    delta in the local frame. ``mask`` (..., 1) gates both deltas."""
    q_vec, t_vec = update6[..., :3], update6[..., 3:]
    quats = rigid_quat(r7)
    zero = torch.zeros_like(q_vec[..., :1])
    quat_update = quat_multiply(quats, torch.cat([zero, q_vec], dim=-1))
    new_quats = quat_normalize(quats + quat_update * mask)
    trans_update = torch.einsum("...ij,...j->...i", rigid_rotmat(r7), t_vec)
    new_trans = rigid_trans(r7) + trans_update * mask
    return torch.cat([new_quats, new_trans], dim=-1)
