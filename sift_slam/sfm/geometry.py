"""Projective geometry primitives: SO(3)/SE(3), projection, triangulation.

Batched, jit/vmap-friendly, float32-first (float64 on CPU for tests).
Conventions:

- World-to-camera: ``x_cam = R @ x_world + t`` (pose = (R, t)).
- Pixel projection: ``u = K @ normalize(x_cam)`` with K upper-triangular
  ``[[fx, 0, cx], [0, fy, cy], [0, 0, 1]]``.
- so(3)/se(3) exp/log use the closed-form Rodrigues series with Taylor
  fallbacks near θ=0 so gradients stay finite (important: BA optimizes
  through these maps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat map: ``(..., 3) -> (..., 3, 3)`` skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle ``(..., 3)`` → rotation matrix ``(..., 3, 3)``.

    Taylor expansions below θ²≈1e-8 keep the map and its JVP finite at 0.
    """
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    small = theta2 < 1e-8
    # Double-where: the untaken branch must not compute 0/0, or its NaN
    # poisons gradients through jnp.where.
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    k = hat(w)
    k2 = k @ k
    sin_t = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    cos_t = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), k.shape)
    return eye + sin_t * k + cos_t * k2


def so3_log(rot: jax.Array) -> jax.Array:
    """Rotation matrix ``(..., 3, 3)`` → axis-angle ``(..., 3)``."""
    trace = jnp.trace(rot, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_theta)
    vee = jnp.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        axis=-1,
    )
    # Threshold must sit ABOVE the floor the cos clip imposes
    # (arccos(1 − 1e-7) ≈ 4.5e-4) or the Taylor branch is dead code;
    # 1e-3 keeps θ/(2·sinθ) comfortably stable on the other side.
    small = (theta < 1e-3)[..., None]
    scale = jnp.where(
        small,
        0.5 + theta[..., None] ** 2 / 12.0,
        theta[..., None] / (2.0 * jnp.sin(theta[..., None])),
    )
    return scale * vee


def se3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """se(3) twist ``(..., 6)`` = (ω, v) → ``(R, t)``."""
    w, v = xi[..., :3], xi[..., 3:]
    rot = so3_exp(w)
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    k = hat(w)
    k2 = k @ k
    a = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe
    )
    b = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2_safe * theta),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), k.shape)
    jl = eye + a * k + b * k2
    t = jnp.einsum("...ij,...j->...i", jl, v)
    return rot, t


def se3_log(rot: jax.Array, t: jax.Array) -> jax.Array:
    """``(R, t)`` → twist ``(..., 6)`` = (ω, v) with ``v = J_l(ω)⁻¹ t``.

    Inverse left-Jacobian in closed form with a Taylor fallback near 0;
    valid for θ < π (same branch caveat as :func:`so3_log`).
    """
    w = so3_log(rot)
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    k = hat(w)
    k2 = k @ k
    b = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / theta2_safe)
        - (1.0 + jnp.cos(theta)) / (2.0 * theta * jnp.sin(theta)),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), k.shape)
    jl_inv = eye - 0.5 * k + b * k2
    v = jnp.einsum("...ij,...j->...i", jl_inv, t)
    return jnp.concatenate([w, v], axis=-1)


def compose(r1, t1, r2, t2):
    """(R1,t1)·(R2,t2): apply pose2 then pose1."""
    return r1 @ r2, jnp.einsum("...ij,...j->...i", r1, t2) + t1


def invert(rot, t):
    rt = jnp.swapaxes(rot, -1, -2)
    return rt, -jnp.einsum("...ij,...j->...i", rt, t)


def transform(rot, t, pts):
    """Apply ``(..., 3, 3)``, ``(..., 3)`` to points ``(..., N, 3)``."""
    return jnp.einsum("...ij,...nj->...ni", rot, pts) + t[..., None, :]


def project(pts_cam: jax.Array, k_mat: jax.Array) -> jax.Array:
    """Pinhole projection of camera-frame points ``(..., N, 3)`` → px.

    Depth is clamped away from zero (sign-preserving) so points at/behind
    the camera produce finite-but-wrong pixels instead of NaNs; callers
    mask by depth.
    """
    z = pts_cam[..., 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, jnp.where(z < 0, -1e-6, 1e-6), z)
    uv1 = pts_cam / z_safe
    fx = k_mat[..., 0, 0]
    fy = k_mat[..., 1, 1]
    cx = k_mat[..., 0, 2]
    cy = k_mat[..., 1, 2]
    u = fx[..., None] * uv1[..., 0] + cx[..., None]
    v = fy[..., None] * uv1[..., 1] + cy[..., None]
    return jnp.stack([u, v], axis=-1)


def backproject(uv: jax.Array, k_mat: jax.Array) -> jax.Array:
    """Pixels ``(..., N, 2)`` → normalized camera rays ``(..., N, 3)``."""
    fx = k_mat[..., 0, 0]
    fy = k_mat[..., 1, 1]
    cx = k_mat[..., 0, 2]
    cy = k_mat[..., 1, 2]
    x = (uv[..., 0] - cx[..., None]) / fx[..., None]
    y = (uv[..., 1] - cy[..., None]) / fy[..., None]
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def triangulate_midpoint(
    r1, t1, r2, t2, rays1: jax.Array, rays2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Midpoint triangulation of ray pairs in world frame.

    ``(r_i, t_i)`` are world→camera poses; ``rays_i`` are camera-frame
    unit-ish rays ``(N, 3)``. Solves the 2×2 normal equations for the
    closest points along each ray and returns ``(points (N, 3),
    depths (N, 2))`` — depths in each camera for cheirality tests.

    Closed-form 2×2 solve instead of per-point SVD: batched elementwise
    arithmetic, no LAPACK call per point.
    """
    c1 = invert(r1, t1)
    c2 = invert(r2, t2)
    o1 = c1[1][..., None, :]  # camera centers in world
    o2 = c2[1][..., None, :]
    d1 = jnp.einsum("...ij,...nj->...ni", c1[0], rays1)
    d2 = jnp.einsum("...ij,...nj->...ni", c2[0], rays2)

    b = o2 - o1
    d11 = jnp.sum(d1 * d1, axis=-1)
    d22 = jnp.sum(d2 * d2, axis=-1)
    d12 = jnp.sum(d1 * d2, axis=-1)
    rb1 = jnp.sum(d1 * b, axis=-1)
    rb2 = jnp.sum(d2 * b, axis=-1)
    det = d11 * d22 - d12 * d12
    det_safe = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    s = (rb1 * d22 - rb2 * d12) / det_safe
    u = (rb1 * d12 - rb2 * d11) / det_safe
    p1 = o1 + s[..., None] * d1
    p2 = o2 + u[..., None] * d2
    points = (p1 + p2) / 2.0

    z1 = transform(r1, t1, points)[..., 2]
    z2 = transform(r2, t2, points)[..., 2]
    return points, jnp.stack([z1, z2], axis=-1)
