"""Per-pixel-tile multi-view cost kernel (Pallas, Triton route).

One program evaluates one candidate plane field on one ``BH x BW`` pixel tile
against every source view -- the layout of the reference's per-pixel kernel
(ComputeBilateralNCC / ComputeMultiViewCostVector, ACMMP.cu:398-563): a loop
over the patch taps keeps the six bilateral-NCC sums of every (view, pixel) in
registers, and the bilinear corners are gathered straight from the source
images in device memory.  The XLA path (:func:`ops.ncc.multiview_ncc`) instead
streams six (S, H, W) accumulators through device memory once per tap.

With ``src_depths`` the same program also emits the geometric-consistency
cost (ComputeGeomConsistencyCost, ACMMP.cu:646-671).

Semantics are exactly those of :func:`ops.ncc.multiview_ncc` and
:func:`ops.geom.geom_consistency_cost` for both camera models; those XLA
functions stay as the plain reference the kernel is tested against.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core.camera import Camera, Cameras, SPHERE, camera_center
from acmmp_spherical_tpu.core.geometry import INVALID_DEPTH, _PARALLEL_EPS as _EPS
from acmmp_spherical_tpu.ops.ncc import RefTapContext

PI = math.pi

# Camera table row: R (0-8), t (9-11), centre C (12-14), K row 0 (15-17),
# K row 1 (18-20), sphere cx, cy (21, 22), width, height (23, 24).
_ROW = 32
# elements of one (view, row, col) block: sets the tile height so the six
# per-view sums fit the registers of num_warps warps
_BLOCK_ELEMS = 2048
_TILE_W = 32


def _camera_rows(cams: Cameras) -> jax.Array:
    """(N, _ROW) float32 table of a batched camera pytree."""
    n = cams.t.shape[0]
    C = jax.vmap(camera_center)(cams)
    cols = [
        cams.R.reshape(n, 9), cams.t, C, cams.K[:, 0, :], cams.K[:, 1, :],
        cams.params[:, 1:3], cams.wh,
    ]
    rows = jnp.concatenate(cols, axis=1).astype(jnp.float32)
    return jnp.pad(rows, ((0, 0), (0, _ROW - rows.shape[1])))


def tile_shape(n_views: int) -> tuple[int, int, int]:
    """(S_pad, BH, BW): views padded to a power of two, and a pixel tile that
    keeps ``S_pad * BH * BW`` at ``_BLOCK_ELEMS``."""
    s_pad = 1 << max(n_views - 1, 0).bit_length()
    bh = max(1, min(16, _BLOCK_ELEMS // (s_pad * _TILE_W)))
    return s_pad, bh, _TILE_W


def _pixel_ray(cam, x, y, sphere):
    if sphere:
        lon = (x - cam(21)) / cam(23) * (2.0 * PI)
        lat = -(y - cam(22)) / cam(24) * PI
        cos_lat = jnp.cos(lat)
        return cos_lat * jnp.sin(lon), -jnp.sin(lat), cos_lat * jnp.cos(lon)
    u = (x - cam(17)) / cam(15)
    v = (y - cam(20)) / cam(19)
    return u, v, jnp.ones_like(u)


def _to_world(cam, xc):
    """R^T X_cam + C."""
    return tuple(
        cam(i) * xc[0] + cam(3 + i) * xc[1] + cam(6 + i) * xc[2] + cam(12 + i)
        for i in range(3)
    )


def _project(cam, X, sphere):
    """World point -> (x, y) pixel of ``cam`` (core.geometry.project)."""
    xc = [cam(3 * i) * X[0] + cam(3 * i + 1) * X[1] + cam(3 * i + 2) * X[2]
          + cam(9 + i) for i in range(3)]
    if sphere:
        depth = jnp.sqrt(xc[0] * xc[0] + xc[1] * xc[1] + xc[2] * xc[2])
        safe = jnp.maximum(depth, _EPS)
        lat = -jnp.arcsin(jnp.clip(xc[1] / safe, -1.0, 1.0))
        lon = jnp.arctan2(xc[0], xc[2])
        x = lon / (2.0 * PI) * cam(23) + cam(21)
        y = -lat / PI * cam(24) + cam(22)
        degenerate = depth < _EPS
        return jnp.where(degenerate, cam(21), x), jnp.where(degenerate, cam(22), y)
    z = jnp.where(jnp.abs(xc[2]) < _EPS, _EPS, xc[2])
    x = (cam(15) * xc[0] + cam(16) * xc[1] + cam(17) * xc[2]) / z
    y = (cam(18) * xc[0] + cam(19) * xc[1] + cam(20) * xc[2]) / z
    return x, y


def _plane_point(cam, x, y, normal, w, sphere):
    """World point where the pixel ray meets the plane (depth_from_plane +
    unproject_world)."""
    r = _pixel_ray(cam, x, y, sphere)
    denom = normal[0] * r[0] + normal[1] * r[1] + normal[2] * r[2]
    d = jnp.where(jnp.abs(denom) < _EPS, INVALID_DEPTH, -w / denom)
    return _to_world(cam, (r[0] * d, r[1] * d, r[2] * d))


def _int(v, lo, hi):
    """float -> int32 after clamping to [lo, hi] (keeps the conversion
    defined for far-off projections; bounds are chosen so every later
    validity test and index clamp sees the same result)."""
    return jnp.clip(v, lo, hi).astype(jnp.int32)


def _kernel(ref_tab, src_tab, img_ref, *rest, n_views, height, width,
            s_pad, bh, bw, n_side, radius, inc, sphere, cost_max, geom_max,
            with_geom):
    if with_geom:
        (dep_ref, n_ref, w_ref, xs_ref, ys_ref, taps_ref, wgt_ref,
         out_ref, gout_ref) = rest
    else:
        n_ref, w_ref, xs_ref, ys_ref, taps_ref, wgt_ref, out_ref = rest
    c = pl.program_id(0)
    shape2 = (bh, bw)
    rows = pl.program_id(1) * bh + jax.lax.broadcasted_iota(jnp.int32, shape2, 0)
    cols = pl.program_id(2) * bw + jax.lax.broadcasted_iota(jnp.int32, shape2, 1)
    rows = jnp.minimum(rows, height - 1)
    cols = jnp.minimum(cols, width - 1)
    views = jax.lax.broadcasted_iota(jnp.int32, (s_pad, 1, 1), 0)
    view_idx = jnp.broadcast_to(jnp.minimum(views, n_views - 1), (s_pad, bh, bw))

    ref_vals = [ref_tab[k] for k in range(25)]
    src_vals = [src_tab[k, views] for k in range(25)]
    ref = lambda k: ref_vals[k]
    src = lambda k: src_vals[k]
    src_w, src_h = src(23), src(24)
    src_wi = src_w.astype(jnp.int32)
    src_hi = src_h.astype(jnp.int32)

    xs = xs_ref[rows, cols]
    ys = ys_ref[rows, cols]
    normal = tuple(n_ref[c, rows, cols, k] for k in range(3))
    pw = w_ref[c, rows, cols]

    # centre validation (ACMMP.cu:418-433)
    X0 = _plane_point(ref, xs, ys, normal, pw, sphere)
    px, py = _project(src, X0, sphere)
    if sphere:
        valid_c = jnp.ones((s_pad, bh, bw), jnp.bool_)
    else:
        valid_c = (px >= 0.0) & (px < src_w) & (py >= 0.0) & (py < src_h)

    def tap(t, sums):
        a = t // n_side
        dx = (a * inc - radius).astype(jnp.float32)
        dy = ((t - a * n_side) * inc - radius).astype(jnp.float32)
        ref_pix = taps_ref[t, rows, cols]
        wgt = wgt_ref[t, rows, cols]
        Xt = _plane_point(ref, xs + dx, ys + dy, normal, pw, sphere)
        x, y = _project(src, Xt, sphere)
        # bilinear sample (ops.sampling.sample_bilinear)
        if sphere:
            x = x - jnp.floor(x / src_w) * src_w
            y = jnp.clip(y, 0.0, src_h - 1.0)
            ok = jnp.ones((s_pad, bh, bw), jnp.bool_)
        else:
            ok = (x >= 0.0) & (x < src_w) & (y >= 0.0) & (y < src_h)
        x0f = jnp.floor(x)
        y0f = jnp.floor(y)
        fx = x - x0f
        fy = y - y0f
        x0 = _int(x0f, -2.0, src_w + 1.0)
        y0 = jnp.clip(_int(y0f, -2.0, src_h + 1.0), 0, src_hi - 1)
        y1 = jnp.clip(y0 + 1, 0, src_hi - 1)
        if sphere:
            x0 = jnp.where(x0 < 0, x0 + src_wi,
                           jnp.where(x0 >= src_wi, x0 - src_wi, x0))
            x1 = x0 + 1
            x1 = jnp.where(x1 >= src_wi, x1 - src_wi, x1)
        else:
            x0 = jnp.clip(x0, 0, src_wi - 1)
            x1 = jnp.clip(x0 + 1, 0, src_wi - 1)
        v00 = img_ref[view_idx, y0, x0]
        v01 = img_ref[view_idx, y0, x1]
        v10 = img_ref[view_idx, y1, x0]
        v11 = img_ref[view_idx, y1, x1]
        top = v00 + (v01 - v00) * fx
        bot = v10 + (v11 - v10) * fx
        val = top + (bot - top) * fy

        wv = jnp.where(ok, wgt[None], 0.0)
        s_bw, s_r, s_rr, s_s, s_ss, s_rs = sums
        return (
            s_bw + wv,
            s_r + wv * ref_pix[None],
            s_rr + wv * (ref_pix * ref_pix)[None],
            s_s + wv * val,
            s_ss + wv * val * val,
            s_rs + wv * ref_pix[None] * val,
        )

    zeros = jnp.zeros((s_pad, bh, bw), jnp.float32)
    s_bw, s_r, s_rr, s_s, s_ss, s_rs = jax.lax.fori_loop(
        0, n_side * n_side, tap, (zeros,) * 6)

    # weighted NCC (ACMMP.cu:497-515)
    inv_bw = 1.0 / jnp.maximum(s_bw, 1e-12)
    m_ref = s_r * inv_bw
    m_src = s_s * inv_bw
    var_ref = s_rr * inv_bw - m_ref * m_ref
    var_src = s_ss * inv_bw - m_src * m_src
    covar = s_rs * inv_bw - m_ref * m_src
    ncc = 1.0 - covar * jax.lax.rsqrt(jnp.maximum(var_ref * var_src, 1e-30))
    cost = jnp.clip(ncc, 0.0, cost_max)
    degenerate = (s_bw < 1e-6) | (var_ref < 1e-5) | (var_src < 1e-5)
    out_ref[...] = jnp.where(degenerate | ~valid_c, cost_max, cost)

    if with_geom:
        # forward-backward reprojection (ops.geom.geom_consistency_cost)
        xi = _int(px, -2.0, src_w + 1.0)   # C truncation (ACMMP.cu:656)
        yi = _int(py, -2.0, src_h + 1.0)
        ok = (xi >= 0) & (xi < src_wi) & (yi >= 0) & (yi < src_hi)
        src_d = dep_ref[view_idx, jnp.clip(yi, 0, src_hi - 1),
                        jnp.clip(xi, 0, src_wi - 1)]
        r = _pixel_ray(src, px, py, sphere)
        Xs = _to_world(src, (r[0] * src_d, r[1] * src_d, r[2] * src_d))
        bx, by = _project(ref, Xs, sphere)
        err = jnp.sqrt((xs - bx) ** 2 + (ys - by) ** 2)
        gcost = jnp.minimum(geom_max, err)
        gout_ref[...] = jnp.where(ok & (src_d > 0.0), gcost, geom_max)


@functools.partial(jax.jit, static_argnames=("params", "interpret"))
def tile_cost_vectors(
    src_images: jax.Array,   # (S, Hp, Wp) padded source stack
    src_cams: Cameras,       # batched (S)
    ref_cam: Camera,
    normals: jax.Array,      # (C, H, W, 3) ref-cam frame plane normals
    ws: jax.Array,           # (C, H, W) plane offsets
    ctx: RefTapContext,      # tap context on the same (H, W) grid
    params: PatchMatchParams,
    src_depths: jax.Array | None = None,  # (S, Hp, Wp): also the geom cost
    *,
    interpret: bool = False,
):
    """Photometric cost vectors ``(C, S, H, W)`` of C plane fields -- and,
    with ``src_depths``, the geometric ones as a second output.

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on a
    host without a GPU).
    """
    if ref_cam.model != src_cams.model:
        raise ValueError("mixed camera models in one problem")
    sphere = ref_cam.model == SPHERE
    S = src_images.shape[0]
    C, H, W = ws.shape
    T = ctx.ref_taps.shape[0]
    radius = params.patch_size // 2
    inc = params.radius_increment
    n_side = len(range(-radius, radius + 1, inc))
    if n_side * n_side != T:
        raise ValueError(f"tap context has {T} taps, params give {n_side ** 2}")
    s_pad, bh, bw = tile_shape(S)
    grid = (C, pl.cdiv(H, bh), pl.cdiv(W, bw))
    with_geom = src_depths is not None

    src_tab = _camera_rows(src_cams).T                  # (_ROW, S)
    src_tab = jnp.pad(src_tab, ((0, 0), (0, s_pad - S)), mode="edge")
    ref_tab = _camera_rows(jax.tree.map(lambda a: a[None], ref_cam))[0]

    kernel = functools.partial(
        _kernel, n_views=S, height=H, width=W, s_pad=s_pad, bh=bh, bw=bw,
        n_side=n_side, radius=radius, inc=inc, sphere=sphere,
        cost_max=params.cost_max, geom_max=params.geom_max_cost,
        with_geom=with_geom)
    out_shape = jax.ShapeDtypeStruct(
        (C, s_pad, grid[1] * bh, grid[2] * bw), jnp.float32)
    out_spec = pl.BlockSpec((None, s_pad, bh, bw), lambda c, i, j: (c, 0, i, j))
    args = [ref_tab, src_tab, src_images]
    if with_geom:
        args.append(src_depths)
    args += [normals, ws, ctx.xs, ctx.ys, ctx.ref_taps, ctx.weights]
    whole = pl.BlockSpec()
    out = pl.pallas_call(
        kernel,
        out_shape=(out_shape, out_shape) if with_geom else out_shape,
        grid=grid,
        in_specs=[whole] * len(args),
        out_specs=(out_spec, out_spec) if with_geom else out_spec,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ncc_tile",
    )(*args)
    crop = lambda a: a[:, :S, :H, :W]
    if with_geom:
        return crop(out[0]), crop(out[1])
    return crop(out)


@functools.cache
def available() -> bool:
    """True where the Triton route compiles: one tiny kernel is compiled for
    the default device (nothing is compiled for a CPU-only process)."""
    def probe(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    f = pl.pallas_call(
        probe, out_shape=jax.ShapeDtypeStruct((16,), jnp.float32),
        backend="triton")
    try:
        jax.jit(f).lower(jnp.zeros((16,), jnp.float32)).compile()
    except Exception:  # lowering or compilation refused: no Triton route
        return False
    return True
