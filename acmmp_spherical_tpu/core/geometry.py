"""Projective geometry for pinhole and equirectangular-sphere cameras.

Pure, shape-polymorphic functions: every routine takes pixel coordinates /
points as arrays of any broadcastable shape and is safe under ``jit`` /
``vmap`` / ``grad``.  These are the array-program equivalents of the reference's
device geometry helpers (reference ACMMP.cu:98-193, 307-396, 565-644) and host
helpers (reference ACMMP.cpp:247-350).

Conventions
-----------
* ``R`` is world->cam (row-major), ``X_cam = R @ X + t``.
* Plane hypotheses are ``(n, w)`` with the unit normal ``n`` in the *reference
  camera frame* and ``n . X_cam + w = 0`` (reference D4; ACMMP.cu:168-193).
* Depth is z for pinhole, radial ``||X_cam||`` for sphere (see
  :mod:`acmmp_spherical_tpu.core.camera` for why this deviates from the fork).
* Sphere pixel mapping (reference ACMMP.cu:127-133, 624-629):
  ``lon = (x - cx)/W * 2pi``; ``lat = -(y - cy)/H * pi``;
  ``dir = (cos lat sin lon, -sin lat, cos lat cos lon)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.core.camera import Camera, SPHERE, camera_center

PI = jnp.pi
# Sentinel returned by ray-plane intersection when the ray is (near) parallel
# to the plane (reference ACMMP.cu:192).
INVALID_DEPTH = 1.0e6
_PARALLEL_EPS = 1.0e-6


# Camera transforms need full f32 accuracy: an f32 matmul may otherwise run at
# reduced precision (TF32 on the GPU keeps ~3 decimal digits), which is ~0.1 px
# error at 60 px and catastrophic at 3200 px.  K=3 contractions are trivial, so
# HIGHEST costs nothing.
_HI = jax.lax.Precision.HIGHEST


def _mat3_vec(m: jax.Array, v: jax.Array) -> jax.Array:
    """(3,3) @ (..., 3) -> (..., 3)."""
    return jnp.einsum("ij,...j->...i", m, v, precision=_HI)


def _mat3t_vec(m: jax.Array, v: jax.Array) -> jax.Array:
    """(3,3)^T @ (..., 3) -> (..., 3)."""
    return jnp.einsum("ji,...j->...i", m, v, precision=_HI)


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------

def pixel_ray(cam: Camera, x: jax.Array, y: jax.Array) -> jax.Array:
    """Camera-frame ray ``r(x, y)`` such that ``X_cam = depth * r``.

    PINHOLE: ``((x-cx)/fx, (y-cy)/fy, 1)`` (unnormalised; depth==z).
    SPHERE:  unit direction from lon/lat (depth==radial distance).
    Reference: ACMMP.cu:119-134 (but see camera.py on the pinhole convention).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    if cam.model == SPHERE:
        lon = (x - cam.params[1]) / cam.width * (2.0 * PI)
        lat = -(y - cam.params[2]) / cam.height * PI
        cos_lat = jnp.cos(lat)
        return jnp.stack(
            [cos_lat * jnp.sin(lon), -jnp.sin(lat), cos_lat * jnp.cos(lon)], axis=-1
        )
    u = (x - cam.K[0, 2]) / cam.K[0, 0]
    v = (y - cam.K[1, 2]) / cam.K[1, 1]
    return jnp.stack([u, v, jnp.ones_like(u)], axis=-1)


def view_direction(cam: Camera, x: jax.Array, y: jax.Array) -> jax.Array:
    """Unit viewing direction (reference GetViewDirection, ACMMP.cu:161-165)."""
    r = pixel_ray(cam, x, y)
    return r / jnp.linalg.norm(r, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# plane <-> depth
# ---------------------------------------------------------------------------

def depth_from_plane(
    cam: Camera, x: jax.Array, y: jax.Array, normal: jax.Array, w: jax.Array
) -> jax.Array:
    """Ray-plane intersection depth ``-w / (n . r)``.

    Returns ``INVALID_DEPTH`` for near-parallel rays
    (reference ComputeDepthfromPlaneHypothesis, ACMMP.cu:187-193).
    ``normal``: (..., 3) in ref-cam frame; ``w``: (...,).
    """
    r = pixel_ray(cam, x, y)
    denom = jnp.sum(normal * r, axis=-1)
    return jnp.where(jnp.abs(denom) < _PARALLEL_EPS, INVALID_DEPTH, -w / denom)


def dist_to_origin(
    cam: Camera, x: jax.Array, y: jax.Array, depth: jax.Array, normal: jax.Array
) -> jax.Array:
    """Plane offset ``w = -(n . X_cam)`` for the point at ``depth`` on the
    pixel ray (reference GetDistance2Origin, ACMMP.cu:168-173)."""
    r = pixel_ray(cam, x, y)
    return -depth * jnp.sum(normal * r, axis=-1)


# ---------------------------------------------------------------------------
# unproject / project
# ---------------------------------------------------------------------------

def unproject_cam(cam: Camera, x: jax.Array, y: jax.Array, depth: jax.Array) -> jax.Array:
    """Pixel + depth -> camera-frame 3D point
    (reference Get3DPointonRefCam, ACMMP.cpp:287-312)."""
    return pixel_ray(cam, x, y) * depth[..., None]


def cam_to_world(cam: Camera, X_cam: jax.Array) -> jax.Array:
    """Camera-frame -> world: ``R^T X_cam + C``
    (reference Get3DPointonWorld_cu, ACMMP.cu:584-599)."""
    return _mat3t_vec(cam.R, X_cam) + camera_center(cam)


def unproject_world(cam: Camera, x: jax.Array, y: jax.Array, depth: jax.Array) -> jax.Array:
    """Pixel + depth -> world point (reference Get3DPointonWorld_cu)."""
    return cam_to_world(cam, unproject_cam(cam, x, y, depth))


def world_to_cam(cam: Camera, X: jax.Array) -> jax.Array:
    return _mat3_vec(cam.R, X) + cam.t


def project(cam: Camera, X: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """World point -> (x, y, depth).

    PINHOLE: depth = z; (x, y) via K (reference ACMMP.cu:632-643).
    SPHERE:  depth = ||X_cam||; equirectangular mapping with the principal
             point (reference ACMMP.cu:616-630).  Longitude lands in
             ``(-W/2 + cx, W/2 + cx]``; callers wrap as needed.
    """
    Xc = world_to_cam(cam, X)
    if cam.model == SPHERE:
        depth = jnp.linalg.norm(Xc, axis=-1)
        safe = jnp.maximum(depth, _PARALLEL_EPS)
        lat = -jnp.arcsin(jnp.clip(Xc[..., 1] / safe, -1.0, 1.0))
        lon = jnp.arctan2(Xc[..., 0], Xc[..., 2])
        x = lon / (2.0 * PI) * cam.width + cam.params[1]
        y = -lat / PI * cam.height + cam.params[2]
        # degenerate point at the camera center -> principal point
        x = jnp.where(depth < _PARALLEL_EPS, cam.params[1], x)
        y = jnp.where(depth < _PARALLEL_EPS, cam.params[2], y)
        return x, y, depth
    depth = Xc[..., 2]
    # No divide guard: matches the device path (ACMMP.cu:632-643); downstream
    # bounds checks reject the resulting coordinates.
    z = jnp.where(jnp.abs(depth) < _PARALLEL_EPS, _PARALLEL_EPS, depth)
    x = (cam.K[0, 0] * Xc[..., 0] + cam.K[0, 1] * Xc[..., 1] + cam.K[0, 2] * Xc[..., 2]) / z
    y = (cam.K[1, 0] * Xc[..., 0] + cam.K[1, 1] * Xc[..., 1] + cam.K[1, 2] * Xc[..., 2]) / z
    return x, y, depth


# ---------------------------------------------------------------------------
# normals
# ---------------------------------------------------------------------------

def normal_cam_to_world(cam: Camera, n: jax.Array) -> jax.Array:
    """Ref-cam-frame normal -> world (reference TransformNormal, ACMMP.cu:378-386)."""
    return _mat3t_vec(cam.R, n)


def normal_world_to_cam(cam: Camera, n: jax.Array) -> jax.Array:
    """World normal -> ref-cam frame (reference TransformNormal2RefCam,
    ACMMP.cu:388-396)."""
    return _mat3_vec(cam.R, n)


def normalize(v: jax.Array, eps: float = 1.0e-20) -> jax.Array:
    """rsqrt-normalise along the last axis (reference NormalizeVec3,
    ACMMP.cu:110-117)."""
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def angle_between(n1: jax.Array, n2: jax.Array) -> jax.Array:
    """Angle between unit vectors; NaN-safe like reference GetAngle
    (ACMMP.cpp:352-361)."""
    d = jnp.clip(jnp.sum(n1 * n2, axis=-1), -1.0, 1.0)
    return jnp.arccos(d)


def disparity(cam: Camera, x: jax.Array, y: jax.Array, depth: jax.Array) -> jax.Array:
    """Range-to-camera for a pixel at ``depth`` (reference GetDisparity,
    ACMMP.cpp:536-546): radial distance for pinhole (||K^-1 p * z||), the
    depth itself for sphere (already radial)."""
    if cam.model == SPHERE:
        return depth
    X = unproject_cam(cam, x, y, depth)
    return jnp.linalg.norm(X, axis=-1)


# ---------------------------------------------------------------------------
# homography (pinhole pairs; vestigial in the reference cost path but part of
# the public surface -- reference ComputeHomography, ACMMP.cu:307-367)
# ---------------------------------------------------------------------------

def plane_homography(
    ref: Camera, src: Camera, normal: jax.Array, w: jax.Array
) -> jax.Array:
    """Plane-induced homography ``H = K_src (R_rel - t_rel n^T / w') K_ref^-1``
    mapping ref pixels to src pixels for pinhole pairs.

    ``normal``/``w`` in the ref-cam frame as elsewhere.  Broadcasts over leading
    axes of ``normal`` (..., 3) and ``w`` (...,) producing (..., 3, 3).
    """
    R_rel = jnp.matmul(src.R, ref.R.T, precision=_HI)
    C_rel = camera_center(ref) - camera_center(src)
    t_rel = _mat3_vec(src.R, C_rel)
    nw = normal / w[..., None]
    M = R_rel - t_rel[:, None] * nw[..., None, :]
    Kr_inv = jnp.linalg.inv(ref.K)
    return jnp.einsum("ij,...jk,kl->...il", src.K, M, Kr_inv, precision=_HI)


def apply_homography(H: jax.Array, x: jax.Array, y: jax.Array):
    """(reference ComputeCorrespondingPoint, ACMMP.cu:369-376)."""
    p = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    q = jnp.einsum("...ij,...j->...i", H, p, precision=_HI)
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
