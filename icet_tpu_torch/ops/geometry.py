"""Geometry on tensors: spherical coordinates, Euler rotations, poses.

Conventions are those of ``icet_tpu/ops/geometry.py``:

* ``(r, theta, phi)``: ``r = |p|``, ``theta = atan2(y, x)`` wrapped to
  ``[0, 2*pi)``, ``phi = acos(z / r)`` from +z; NaN/inf coordinates are
  zeroed and ``r == 0`` maps to ``(0, 0, 0)``.
* ``euler_R(phi, theta, psi)``: body-xyz rotation.
* Scan-2 transform ``p' = euler_R(-angs) p + t``.

``transform_points`` and ``cart_to_spherical`` are written as single
rounded elementwise operations in a fixed order; the fused moments kernel
(``csrc/fused_moments.cu``, built without FMA contraction) repeats that
order, so the two bin and gate points identically.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def cart_to_spherical(pts: torch.Tensor) -> torch.Tensor:
    """Cartesian ``(..., 3)`` -> spherical ``(r, theta, phi)`` ``(..., 3)``."""
    pts = torch.nan_to_num(pts, nan=0.0, posinf=0.0, neginf=0.0)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.atan2(y, x)
    theta = torch.where(theta < 0.0, theta + TWO_PI, theta)
    pos = r > 0.0
    safe_r = torch.where(pos, r, torch.ones_like(r))
    phi = torch.acos(torch.clamp(z / safe_r, -1.0, 1.0))
    zero = torch.zeros_like(r)
    theta = torch.where(pos, theta, zero)
    phi = torch.where(pos, phi, zero)
    return torch.stack([r, theta, phi], dim=-1)


def point_norm(pts: torch.Tensor) -> torch.Tensor:
    """``|p|`` per point, NaN for NaN rows (the raw range gate's input)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.sqrt(x * x + y * y + z * z)


def spherical_to_cart(rtp: torch.Tensor) -> torch.Tensor:
    """Spherical ``(r, theta, phi)`` ``(..., 3)`` -> cartesian."""
    r, theta, phi = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    sp = torch.sin(phi)
    return torch.stack(
        [r * sp * torch.cos(theta), r * sp * torch.sin(theta), r * torch.cos(phi)],
        dim=-1,
    )


def euler_R(angs: torch.Tensor) -> torch.Tensor:
    """Body-xyz Euler rotation: ``(..., 3) -> (..., 3, 3)``."""
    phi, theta, psi = angs[..., 0], angs[..., 1], angs[..., 2]
    cf, sf = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(psi), torch.sin(psi)
    row0 = torch.stack([ct * cp, sp * cf + sf * st * cp, sf * sp - st * cf * cp], -1)
    row1 = torch.stack([-sp * ct, cf * cp - sf * st * sp, sf * cp + st * sp * cf], -1)
    row2 = torch.stack([st, -sf * ct, cf * ct], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_jacobian(angs: torch.Tensor) -> torch.Tensor:
    """``dR/d(angs)`` for a (3,) angle vector, shape (3, 3, 3):
    ``out[..., k] = d euler_R / d angs[k]`` (closed form of the JAX
    package's ``jax.jacfwd(euler_R)``)."""
    phi, theta, psi = angs[0], angs[1], angs[2]
    cf, sf = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(psi), torch.sin(psi)
    z = torch.zeros_like(cf)
    d_phi = [
        [z, -sp * sf + cf * st * cp, cf * sp + st * sf * cp],
        [z, -sf * cp - cf * st * sp, cf * cp - st * sp * sf],
        [z, -cf * ct, -sf * ct],
    ]
    d_theta = [
        [-st * cp, sf * ct * cp, -ct * cf * cp],
        [sp * st, -sf * ct * sp, ct * sp * cf],
        [ct, sf * st, -cf * st],
    ]
    d_psi = [
        [-ct * sp, cp * cf - sf * st * sp, sf * cp + st * cf * sp],
        [-cp * ct, -cf * sp - sf * st * cp, -sf * sp + st * cp * cf],
        [z, z, z],
    ]
    return torch.stack(
        [torch.stack([torch.stack([d[i][j] for d in (d_phi, d_theta, d_psi)])
                      for j in range(3)]) for i in range(3)]
    )


def transform_points(pts: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``p' = euler_R(-X[3:6]) p + X[:3]`` for points ``(N, 3)``, each
    component as ``((x r_i0 + y r_i1) + z r_i2) + t_i``."""
    rot = euler_R(-X[3:6])
    return (
        pts[:, 0:1] * rot[:, 0]
        + pts[:, 1:2] * rot[:, 1]
        + pts[:, 2:3] * rot[:, 2]
        + X[:3]
    )


def measurement_jacobian(mu: torch.Tensor, angs: torch.Tensor) -> torch.Tensor:
    """Per-voxel measurement Jacobian ``H``: ``(V, 3) -> (V, 3, 6)``.

    ``H = [-I_3 | J_phi@mu | J_theta@mu | J_psi@mu]`` at the current angles
    with the current (already transformed) voxel means, as the reference
    computes it (icet.cpp:323-329, ICET_spherical.py:424-425); the
    broadcast sum of ``icet_tpu.ops.geometry.measurement_jacobian``."""
    dR = rotation_jacobian(angs)  # (3, 3, 3), [..., k] = dR/da_k
    rot_block = torch.sum(dR[None] * mu[:, None, :, None], dim=2)
    eye = -torch.eye(3, dtype=mu.dtype, device=mu.device)
    eye = eye.expand(mu.shape[0], 3, 3)
    return torch.cat([eye, rot_block], dim=-1)


def pose_matrix(X: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix of the transform ``p' = R(-angs) p + t``."""
    rot = euler_R(-X[3:6])
    top = torch.cat([rot, X[:3, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=X.dtype, device=X.device)
    return torch.cat([top, bottom], dim=0)


def compose_pose(T_world: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``T_world @ pose_matrix(X)``."""
    return T_world @ pose_matrix(X)


def compose_states(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """State of ``T(xa) @ T(xb)``."""
    return pose_to_state(pose_matrix(xa) @ pose_matrix(xb))


def relative_state(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """State of ``T(xa)^-1 @ T(xb)``, by the rigid inverse ``[R^T | -R^T t]``."""
    ra = euler_R(-xa[3:6])
    rb = euler_R(-xb[3:6])
    rot = ra.T @ rb
    t = ra.T @ (xb[:3] - xa[:3])
    top = torch.cat([rot, t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xa.dtype, device=xa.device)
    return pose_to_state(torch.cat([top, bottom], dim=0))


def euler_from_R(rot: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`euler_R` away from theta = +-pi/2."""
    r_sum = torch.sqrt(
        (rot[..., 0, 0] ** 2 + rot[..., 1, 0] ** 2 + rot[..., 2, 1] ** 2
         + rot[..., 2, 2] ** 2) / 2.0
    )
    phi = torch.atan2(-rot[..., 2, 1], rot[..., 2, 2])
    theta = torch.atan2(rot[..., 2, 0], r_sum)
    psi = torch.atan2(-rot[..., 1, 0], rot[..., 0, 0])
    return torch.stack([phi, theta, psi], dim=-1)


def rotmat_to_euler(rot: torch.Tensor) -> torch.Tensor:
    """Reference ``R2Euler``: inverts the TRANSPOSE of :func:`euler_R`."""
    return euler_from_R(torch.swapaxes(rot, -1, -2))


def pose_to_state(T: torch.Tensor) -> torch.Tensor:
    """6-DOF state of a homogeneous pose; inverse of :func:`pose_matrix`."""
    angs = -euler_from_R(T[..., :3, :3])
    return torch.cat([T[..., :3, 3], angs], dim=-1)
