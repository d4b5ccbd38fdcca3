"""Bilateral-weighted NCC photo-consistency cost.

Array-program reformulation of the hot inner kernel (reference
ComputeBilateralNCC, ACMMP.cu:398-516; ComputeMultiViewCostVector /
ComputeMultiViewInitialCostandSelectedViews, ACMMP.cu:519-563):

* one invocation evaluates the cost of a *whole plane field* ``(normal, w)``
  -- one hypothesis per pixel -- against every source view at once
  ((S, H, W) output), instead of one CUDA thread per pixel;
* the patch loop (11x11 window, stride 2 -> 36 taps) is a ``lax.scan`` over
  taps; the source-view loop is a ``vmap`` -- both compile to one fused body;
* everything that depends only on the reference image (tap intensities,
  bilateral weights, the per-pixel spherical angular scaling) is precomputed
  once per half-step in :func:`ref_tap_context` and reused by all ~14 candidate
  hypotheses, which the per-pixel CUDA kernel cannot do.

Spherical handling matches the reference: longitude wrap / latitude clamp when
sampling the source (ACMMP.cu:465-474) and *angular* spatial distances
``(dlon cos(lat), dlat)`` with a radian sigma in the bilateral weight
(ACMMP.cu:436-442, 479-486).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core.camera import Camera, Cameras, SPHERE
from acmmp_spherical_tpu.core import geometry as G
from acmmp_spherical_tpu.ops.sampling import (
    grid_coords, sample_bilinear, sample_bilinear_packed,
)

PI = jnp.pi


def tap_offsets(params: PatchMatchParams) -> jnp.ndarray:
    """Static (T, 2) array of (dx, dy) patch offsets.

    radius=patch_size//2, stride=radius_increment (reference ACMMP.cu:450-451):
    11x11 at stride 2 -> 6x6 = 36 taps.
    """
    r = params.patch_size // 2
    offs = [
        (i, j)
        for i in range(-r, r + 1, params.radius_increment)
        for j in range(-r, r + 1, params.radius_increment)
    ]
    return jnp.asarray(offs, jnp.float32)


class RefTapContext(NamedTuple):
    """Per-half-step precomputed reference-side NCC quantities."""

    offsets: jax.Array     # (T, 2) float (dx, dy)
    ref_taps: jax.Array    # (T, H, W) reference intensity at each tap
    weights: jax.Array     # (T, H, W) bilateral weight of each tap
    center: jax.Array      # (H, W) reference intensity at the center
    xs: jax.Array          # (H, W) pixel x grid
    ys: jax.Array          # (H, W) pixel y grid


def ref_tap_context(
    ref_img: jax.Array, ref_cam: Camera, params: PatchMatchParams
) -> RefTapContext:
    """Precompute tap intensities and bilateral weights on the reference view.

    The reference recomputes these per pixel per candidate per source view
    (ACMMP.cu:455, 479-493); they only depend on the reference image, so here
    they are computed once and shared.
    """
    H, W = ref_img.shape
    xs, ys = grid_coords(H, W)
    offsets = tap_offsets(params)
    is_sphere = ref_cam.model == SPHERE

    center, _ = sample_bilinear(ref_img, xs, ys, ref_cam.width, ref_cam.height,
                                wrap_x=is_sphere)

    if is_sphere:
        # angular metric (reference ACMMP.cu:436-442)
        lat_c = -(ys - ref_cam.params[2]) / ref_cam.height * PI
        scale_x = (2.0 * PI / ref_cam.width) * jnp.cos(lat_c)   # (H, W)
        scale_y = PI / ref_cam.height
        sigma_spatial = params.sigma_spatial * (PI / ref_cam.height)
    else:
        scale_x = jnp.ones_like(xs)
        scale_y = 1.0
        sigma_spatial = params.sigma_spatial

    def tap(off):
        dx, dy = off[0], off[1]
        pix, _ = sample_bilinear(
            ref_img, xs + dx, ys + dy, ref_cam.width, ref_cam.height,
            wrap_x=is_sphere,
        )
        # reference ComputeBilateralWeight (ACMMP.cu:398-403): note the
        # *linear* distances in the exponent (not squared), as in the reference.
        sdist = jnp.sqrt((dx * scale_x) ** 2 + (dy * scale_y) ** 2)
        cdist = jnp.abs(pix - center)
        wgt = jnp.exp(
            -sdist / (2.0 * sigma_spatial * sigma_spatial)
            - cdist / (2.0 * params.sigma_color * params.sigma_color)
        )
        return pix, wgt

    ref_taps, weights = jax.lax.map(tap, offsets)
    return RefTapContext(offsets, ref_taps, weights, center, xs, ys)


def multiview_ncc(
    src_images: jax.Array,   # (S, Hp, Wp) padded source stack
    src_cams: Cameras,       # batched pytree, leading axis S
    ref_cam: Camera,
    normal: jax.Array,       # (H, W, 3) ref-cam frame
    w: jax.Array,            # (H, W)
    ctx: RefTapContext,
    params: PatchMatchParams,
    src_packed: jax.Array | None = None,  # (S, Hp*Wp, 4) from pack_bilinear
) -> jax.Array:
    """Bilateral-NCC cost of one plane field against every source view.

    Returns (S, H, W) costs in [0, cost_max]; invalid views / degenerate
    patches get ``cost_max`` (reference ACMMP.cu:497-515).
    """
    cost_max = params.cost_max
    xs, ys = ctx.xs, ctx.ys
    src_is_sphere = src_cams.model == SPHERE

    # -- center validation (reference ACMMP.cu:418-433) ---------------------
    depth_c = G.depth_from_plane(ref_cam, xs, ys, normal, w)
    Xc = G.unproject_world(ref_cam, xs, ys, depth_c)

    def center_valid(cam: Camera):
        px, py, _ = G.project(cam, Xc)
        if src_is_sphere:
            return jnp.ones(px.shape, bool)
        return (px >= 0.0) & (px < cam.width) & (py >= 0.0) & (py < cam.height)

    valid_c = jax.vmap(center_valid)(src_cams)  # (S, H, W)

    # -- tap accumulation ---------------------------------------------------
    S = src_images.shape[0]
    H, W = xs.shape
    zeros = jnp.zeros((S, H, W), jnp.float32)
    init = (zeros, zeros, zeros, zeros, zeros, zeros)

    def body(sums, tap):
        off, ref_pix, wgt = tap
        dx, dy = off[0], off[1]
        d = G.depth_from_plane(ref_cam, xs + dx, ys + dy, normal, w)
        Xt = G.unproject_world(ref_cam, xs + dx, ys + dy, d)  # (H, W, 3)

        if src_packed is not None:
            wp = src_images.shape[-1]

            def per_view(packed, cam):
                px, py, _ = G.project(cam, Xt)
                return sample_bilinear_packed(
                    packed, wp, px, py, cam.width, cam.height,
                    wrap_x=src_is_sphere,
                )

            src_pix, ok = jax.vmap(per_view)(src_packed, src_cams)  # (S, H, W)
        else:
            def per_view(img, cam):
                px, py, _ = G.project(cam, Xt)
                return sample_bilinear(img, px, py, cam.width, cam.height,
                                       wrap_x=src_is_sphere)

            src_pix, ok = jax.vmap(per_view)(src_images, src_cams)  # (S, H, W)
        wv = jnp.where(ok, wgt[None], 0.0)
        s_bw, s_r, s_rr, s_s, s_ss, s_rs = sums
        return (
            s_bw + wv,
            s_r + wv * ref_pix[None],
            s_rr + wv * (ref_pix * ref_pix)[None],
            s_s + wv * src_pix,
            s_ss + wv * src_pix * src_pix,
            s_rs + wv * ref_pix[None] * src_pix,
        ), None

    (s_bw, s_r, s_rr, s_s, s_ss, s_rs), _ = jax.lax.scan(
        body, init, (ctx.offsets, ctx.ref_taps, ctx.weights)
    )

    # -- weighted NCC (reference ACMMP.cu:497-515) --------------------------
    inv_bw = 1.0 / jnp.maximum(s_bw, 1e-12)
    m_ref = s_r * inv_bw
    m_src = s_s * inv_bw
    var_ref = s_rr * inv_bw - m_ref * m_ref
    var_src = s_ss * inv_bw - m_src * m_src
    covar = s_rs * inv_bw - m_ref * m_src
    ncc = 1.0 - covar * jax.lax.rsqrt(jnp.maximum(var_ref * var_src, 1e-30))
    cost = jnp.clip(ncc, 0.0, cost_max)
    degenerate = (s_bw < 1e-6) | (var_ref < 1e-5) | (var_src < 1e-5)
    cost = jnp.where(degenerate | ~valid_c, cost_max, cost)
    return cost


def topk_cost_and_selection(
    cost_vector: jax.Array,   # (S, H, W)
    src_valid: jax.Array,     # (S,) bool -- padded/missing views
    params: PatchMatchParams,
):
    """Aggregate per-view costs into the initial cost and the per-view
    selection mask (reference ComputeMultiViewInitialCostandSelectedViews,
    ACMMP.cu:519-556).

    top_k = min(#views with cost < cost_max, params.top_k) *per pixel*; the
    initial cost is the mean of the best top_k and a view is selected when its
    cost is <= the k-th best.  Returns (cost (H, W), selected (S, H, W) bool).
    """
    cost_max = params.cost_max
    cv = jnp.where(src_valid[:, None, None], cost_vector, cost_max)
    num_valid = jnp.sum(cv < cost_max, axis=0)                   # (H, W)
    k = jnp.minimum(num_valid, params.top_k)                     # (H, W)

    sorted_cv = jnp.sort(cv, axis=0)                             # ascending
    csum = jnp.cumsum(sorted_cv, axis=0)
    k_idx = jnp.clip(k - 1, 0, cv.shape[0] - 1)
    topk_sum = jnp.take_along_axis(csum, k_idx[None], axis=0)[0]
    cost = jnp.where(k > 0, topk_sum / jnp.maximum(k, 1), cost_max)
    threshold = jnp.take_along_axis(sorted_cv, k_idx[None], axis=0)[0]
    selected = (cv <= threshold[None]) & (k > 0)[None] & src_valid[:, None, None]
    return cost, selected
