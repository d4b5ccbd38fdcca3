"""Multi-view depth-map fusion into a point cloud.

Implements the semantics of the fusion path the reference actually runs
(``SimpleFusionKernel`` / ``RunFusionCuda``, ACMMP.cu:1664-1814): per reference
pixel, project the 3D point into every source view, count sources that agree
(reprojection < 1 px, relative depth < 1%, normal angle < 0.149 rad), and emit
the averaged point/normal/color when at least ``min_consistent`` views
(including the reference) agree.  Per-pixel independent -- no cross-view
masking -- which is exactly what makes it accelerator/distribution friendly
(SURVEY.md section 7).

Dynamic point counts become a fixed-size (H*W) buffer + validity flags
(the reference does the same with ``valid_flags``); compaction happens on the
host.

Documented fixes vs the reference kernel:
* colors are sampled at the exact pixel (the reference's linear-filter texture
  at integer coords averages a 2x2 neighbourhood by accident, ACMMP.cu:1699);
* the output is true RGB (the reference swaps red/blue between fusion and the
  PLY writer).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.config import FusionParams
from acmmp_spherical_tpu.core.camera import Cameras, camera_index
from acmmp_spherical_tpu.core import geometry as G
from acmmp_spherical_tpu.ops.sampling import grid_coords


@functools.partial(jax.jit, static_argnames=("params",))
def fuse_reference_view(
    depths: jax.Array,    # (V, Hp, Wp) all views' depth maps (padded)
    normals: jax.Array,   # (V, Hp, Wp, 3) world-frame normals
    colors: jax.Array,    # (V, Hp, Wp, 3) RGB 0..255
    cams: Cameras,        # batched (V)
    ref_idx: jax.Array,   # scalar int
    src_indices: jax.Array,  # (K,) int32 indices into the V axis; -1 = none
    params: FusionParams,
):
    """Fuse one reference view. Returns (points, normals, colors, valid), all
    (Hp*Wp, ...) with ``valid`` marking emitted points."""
    V, Hp, Wp = depths.shape
    ref_cam = camera_index(cams, ref_idx)
    xs, ys = grid_coords(Hp, Wp)
    in_ref = (xs < ref_cam.width) & (ys < ref_cam.height)

    ref_depth = depths[ref_idx]
    ref_normal = normals[ref_idx]
    ref_color = colors[ref_idx]
    has_depth = (ref_depth > 0.0) & in_ref

    X = G.unproject_world(ref_cam, xs, ys, ref_depth)  # (Hp, Wp, 3)

    def per_src(src_i):
        cam = camera_index(cams, src_i)
        px, py, pd = G.project(cam, X)
        # round-half-up to integer pixel (reference ACMMP.cu:1723-1724)
        xi = jnp.floor(px + 0.5).astype(jnp.int32)
        yi = jnp.floor(py + 0.5).astype(jnp.int32)
        ok = (
            (src_i >= 0)
            & (xi >= 0) & (xi < cam.width.astype(jnp.int32))
            & (yi >= 0) & (yi < cam.height.astype(jnp.int32))
        )
        xi = jnp.clip(xi, 0, Wp - 1)
        yi = jnp.clip(yi, 0, Hp - 1)
        si = jnp.maximum(src_i, 0)
        src_d = depths[si][yi, xi]
        ok = ok & (src_d > 0.0)
        # unproject the *integer* source pixel (reference ACMMP.cu:1735)
        Xs = G.unproject_world(cam, xi.astype(jnp.float32), yi.astype(jnp.float32), src_d)
        bx, by, _ = G.project(ref_cam, Xs)
        reproj = jnp.sqrt((xs - bx) ** 2 + (ys - by) ** 2)
        rel_dd = jnp.abs(pd - src_d) / jnp.maximum(src_d, 1e-20)
        src_n = normals[si][yi, xi]
        angle = G.angle_between(ref_normal, src_n)
        consistent = (
            ok
            & (reproj < params.max_reproj_error)
            & (rel_dd < params.max_rel_depth_diff)
            & (angle < params.max_normal_angle)
        )
        src_c = colors[si][yi, xi]
        cm = consistent[..., None]
        return (
            consistent.astype(jnp.float32),
            jnp.where(cm, Xs, 0.0),
            jnp.where(cm, src_n, 0.0),
            jnp.where(cm, src_c, 0.0),
        )

    n_con, sum_X, sum_n, sum_c = jax.vmap(per_src)(src_indices)
    count = 1.0 + jnp.sum(n_con, axis=0)          # reference view counts itself
    pt = (X + jnp.sum(sum_X, axis=0)) / count[..., None]
    nm = (ref_normal + jnp.sum(sum_n, axis=0)) / count[..., None]
    nm = G.normalize(nm)
    cl = (ref_color + jnp.sum(sum_c, axis=0)) / count[..., None]

    valid = has_depth & (count >= params.min_consistent)
    flat = lambda a: a.reshape(-1, a.shape[-1]) if a.ndim == 3 else a.reshape(-1)
    return flat(pt), flat(nm), flat(cl), flat(valid)


@functools.partial(jax.jit, static_argnames=("params",))
def fuse_reference_view_dynamic(
    depths: jax.Array,
    normals: jax.Array,
    colors: jax.Array,
    cams: Cameras,
    ref_idx: jax.Array,
    src_indices: jax.Array,
    params: FusionParams,
):
    """The reference's *CPU* fusion variant (``RunFusion``, main.cpp:240-390;
    dead code there, provided here for capability parity as an alternative
    mode): looser thresholds (reproj < 2 px, normal angle < 0.174533 rad),
    acceptance when ``n >= 1`` consistent sources AND the dynamic-consistency
    score ``sum(exp(-(err + 200*rel_dd + 10*angle)))`` exceeds ``0.3 * n``.
    Emits the *reference* point (no averaging), like the CPU path.  The CPU
    path's cross-view pixel masking is order-dependent and intentionally
    dropped (the GPU path dropped it too; SURVEY.md section 7).
    """
    V, Hp, Wp = depths.shape
    ref_cam = camera_index(cams, ref_idx)
    xs, ys = grid_coords(Hp, Wp)
    in_ref = (xs < ref_cam.width) & (ys < ref_cam.height)
    ref_depth = depths[ref_idx]
    ref_normal = normals[ref_idx]
    ref_color = colors[ref_idx]
    has_depth = (ref_depth > 0.0) & in_ref
    X = G.unproject_world(ref_cam, xs, ys, ref_depth)

    def per_src(src_i):
        cam = camera_index(cams, src_i)
        px, py, pd = G.project(cam, X)
        xi = jnp.floor(px + 0.5).astype(jnp.int32)
        yi = jnp.floor(py + 0.5).astype(jnp.int32)
        ok = (
            (src_i >= 0)
            & (xi >= 0) & (xi < cam.width.astype(jnp.int32))
            & (yi >= 0) & (yi < cam.height.astype(jnp.int32))
        )
        xi = jnp.clip(xi, 0, Wp - 1)
        yi = jnp.clip(yi, 0, Hp - 1)
        si = jnp.maximum(src_i, 0)
        src_d = depths[si][yi, xi]
        ok = ok & (src_d > 0.0)
        Xs = G.unproject_world(cam, xi.astype(jnp.float32),
                               yi.astype(jnp.float32), src_d)
        bx, by, _ = G.project(ref_cam, Xs)
        reproj = jnp.sqrt((xs - bx) ** 2 + (ys - by) ** 2)
        # CPU path compares the projected depth against the *reference* depth
        # (main.cpp:341), unlike the GPU path's source depth
        rel_dd = jnp.abs(pd - ref_depth) / jnp.maximum(ref_depth, 1e-20)
        angle = G.angle_between(ref_normal, normals[si][yi, xi])
        consistent = ok & (reproj < 2.0) & (rel_dd < 0.01) & (angle < 0.174533)
        score = jnp.where(
            consistent, jnp.exp(-(reproj + 200.0 * rel_dd + 10.0 * angle)), 0.0
        )
        return consistent.astype(jnp.float32), score

    n_con, scores = jax.vmap(per_src)(src_indices)
    num = jnp.sum(n_con, axis=0)
    dyn = jnp.sum(scores, axis=0)
    valid = has_depth & (num >= 1) & (dyn > 0.3 * num)
    flat = lambda a: a.reshape(-1, a.shape[-1]) if a.ndim == 3 else a.reshape(-1)
    return flat(X), flat(ref_normal), flat(ref_color), flat(valid)


def fuse_all_views(
    depths, normals, colors, cams, problems_src_indices, params: FusionParams
):
    """Host loop over reference views (reference ACMMP.cu:2023-2084);
    compacts valid points on the host.

    ``problems_src_indices``: (V, K) int32, -1 padded.
    Returns numpy (N,3) points/normals/colors.
    """
    import numpy as np

    all_p, all_n, all_c = [], [], []
    V = depths.shape[0]
    for i in range(V):
        p, n, c, v = fuse_reference_view(
            depths, normals, colors, cams,
            jnp.asarray(i), jnp.asarray(problems_src_indices[i]), params,
        )
        v = np.asarray(v)
        all_p.append(np.asarray(p)[v])
        all_n.append(np.asarray(n)[v])
        all_c.append(np.asarray(c)[v])
    return (
        np.concatenate(all_p) if all_p else np.zeros((0, 3)),
        np.concatenate(all_n) if all_n else np.zeros((0, 3)),
        np.concatenate(all_c) if all_c else np.zeros((0, 3)),
    )
