"""Image sampling primitives -- the array-program stand-in for CUDA textures.

Bilinear/nearest lookups are explicit gathers plus lerps.  Addressing semantics follow the reference's *effective* behavior
(SURVEY.md quirk notes): the reference sets ``cudaAddressModeWrap`` on
non-normalised coords, which actually clamps; real seam handling is the
explicit longitude wrap in the cost kernel (reference ACMMP.cu:425-427,
465-474).  Here wrap/clamp is explicit and principled:

* ``wrap_x=True`` (sphere): x wraps modulo the view width *including the
  bilinear neighbour*, so interpolation is seam-continuous (the reference
  clamps the last column; we knowingly improve).
* pinhole: out-of-bounds returns ``valid=False`` (callers skip the tap, as the
  reference does) and the gathered value is edge-clamped.

All functions take the *logical* view size (width, height) separately from the
padded array shape, so stacks of differently-sized views can share one padded
array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def grid_coords(height: int, width: int, dtype=jnp.float32):
    """Pixel-center coordinate grids (xs, ys), each (H, W)."""
    ys = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0).astype(dtype)
    xs = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1).astype(dtype)
    return xs, ys


def sample_bilinear(
    img: jax.Array,
    x: jax.Array,
    y: jax.Array,
    width: jax.Array,
    height: jax.Array,
    *,
    wrap_x: bool,
):
    """Bilinear sample at float coords (pixel centers at integers).

    ``img``: (Hp, Wp) padded storage; ``width``/``height``: logical size
    (traced scalars).  Returns ``(value, valid)``.

    Matches the reference's ``tex2D(img, x + 0.5, y + 0.5)`` convention
    (integer coordinates hit exact pixels; reference ACMMP.cu:455, 476).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    if wrap_x:
        x = x - jnp.floor(x / width) * width        # reference ACMMP.cu:467
        y = jnp.clip(y, 0.0, height - 1.0)          # reference ACMMP.cu:468
        valid = jnp.ones(jnp.broadcast_shapes(x.shape, y.shape), bool)
    else:
        valid = (x >= 0.0) & (x < width) & (y >= 0.0) & (y < height)

    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    wi = width.astype(jnp.int32) if hasattr(width, "astype") else jnp.int32(width)
    hi = height.astype(jnp.int32) if hasattr(height, "astype") else jnp.int32(height)
    if wrap_x:
        x0 = jnp.remainder(x0, wi)
        x1 = jnp.remainder(x0 + 1, wi)
    else:
        x0 = jnp.clip(x0, 0, wi - 1)
        x1 = jnp.clip(x0 + 1, 0, wi - 1)
    y0 = jnp.clip(y0, 0, hi - 1)
    y1 = jnp.clip(y0 + 1, 0, hi - 1)

    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy, valid


def pack_bilinear(
    img: jax.Array,
    width: jax.Array,
    height: jax.Array,
    *,
    wrap_x: bool,
) -> jax.Array:
    """Pack the 2x2 bilinear corner neighbourhoods: row ``y*Wp + x`` of the
    result holds ``(img[y,x], img[y,x+1], img[y+1,x], img[y+1,x+1])`` with the
    +1 neighbours edge-clamped (pinhole) or longitude-wrapped (sphere) at the
    *logical* image border.

    One gather row per sample fetches all four corners, in place of four
    scalar gathers on the exact XLA cost path.  The packed table is built
    once per pass with cheap shifts.
    Returns (Hp*Wp, 4) float32.
    """
    hp, wp = img.shape
    wi = width.astype(jnp.int32) if hasattr(width, "astype") else jnp.int32(width)
    hi = height.astype(jnp.int32) if hasattr(height, "astype") else jnp.int32(height)
    cols = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 0)

    sx = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)  # x+1 (padded shift)
    if wrap_x:
        x_edge = jnp.broadcast_to(img[:, :1], (hp, wp))      # wrap to column 0
    else:
        x_edge = img                                          # clamp to itself
    right = jnp.where(cols + 1 < wi, sx, x_edge)

    def down(a):
        sy = jnp.concatenate([a[1:], a[-1:]], axis=0)
        return jnp.where(rows + 1 < hi, sy, a)               # clamp at bottom

    p00 = img
    p01 = right
    p10 = down(img)
    p11 = down(right)
    return jnp.stack([p00, p01, p10, p11], axis=-1).reshape(hp * wp, 4)


def sample_bilinear_packed(
    packed: jax.Array,   # (Hp*Wp, 4) from pack_bilinear
    padded_width: int,   # Wp (static)
    x: jax.Array,
    y: jax.Array,
    width: jax.Array,
    height: jax.Array,
    *,
    wrap_x: bool,
):
    """Bilinear sample using the packed corner table: one gather per sample.

    Semantics identical to :func:`sample_bilinear`.
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    if wrap_x:
        x = x - jnp.floor(x / width) * width
        y = jnp.clip(y, 0.0, height - 1.0)
        valid = jnp.ones(jnp.broadcast_shapes(x.shape, y.shape), bool)
    else:
        valid = (x >= 0.0) & (x < width) & (y >= 0.0) & (y < height)

    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    wi = width.astype(jnp.int32) if hasattr(width, "astype") else jnp.int32(width)
    hi = height.astype(jnp.int32) if hasattr(height, "astype") else jnp.int32(height)
    x0 = x0f.astype(jnp.int32)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, hi - 1)
    if wrap_x:
        x0 = jnp.remainder(x0, wi)
    else:
        x0 = jnp.clip(x0, 0, wi - 1)
    corners = packed[y0 * padded_width + x0]  # (..., 4): one gather row each
    top = corners[..., 0] + (corners[..., 1] - corners[..., 0]) * fx
    bot = corners[..., 2] + (corners[..., 3] - corners[..., 2]) * fx
    return top + (bot - top) * fy, valid


def sample_nearest_trunc(
    img: jax.Array,
    x: jax.Array,
    y: jax.Array,
    width: jax.Array,
    height: jax.Array,
):
    """Nearest sample with C-style truncation-toward-zero indexing.

    Replicates the reference's depth-map lookups
    ``tex2D(depth, (int)x + 0.5, (int)y + 0.5)`` (reference ACMMP.cu:656):
    the (int) cast truncates toward zero.  Returns (value, valid) where valid
    means the *truncated* index is in bounds.
    """
    xi = jnp.trunc(jnp.asarray(x, jnp.float32)).astype(jnp.int32)
    yi = jnp.trunc(jnp.asarray(y, jnp.float32)).astype(jnp.int32)
    wi = width.astype(jnp.int32) if hasattr(width, "astype") else jnp.int32(width)
    hi = height.astype(jnp.int32) if hasattr(height, "astype") else jnp.int32(height)
    valid = (xi >= 0) & (xi < wi) & (yi >= 0) & (yi < hi)
    xi = jnp.clip(xi, 0, wi - 1)
    yi = jnp.clip(yi, 0, hi - 1)
    return img[yi, xi], valid


def sample_nearest_round(
    img: jax.Array,
    x: jax.Array,
    y: jax.Array,
    width: jax.Array,
    height: jax.Array,
):
    """Nearest sample with round-half-up (fusion's ``int(x + 0.5)`` intent,
    reference ACMMP.cu:1723-1724). Returns (value, valid)."""
    xi = jnp.floor(jnp.asarray(x, jnp.float32) + 0.5).astype(jnp.int32)
    yi = jnp.floor(jnp.asarray(y, jnp.float32) + 0.5).astype(jnp.int32)
    wi = width.astype(jnp.int32) if hasattr(width, "astype") else jnp.int32(width)
    hi = height.astype(jnp.int32) if hasattr(height, "astype") else jnp.int32(height)
    valid = (xi >= 0) & (xi < wi) & (yi >= 0) & (yi < hi)
    xi = jnp.clip(xi, 0, wi - 1)
    yi = jnp.clip(yi, 0, hi - 1)
    return img[yi, xi], valid


def shift2d(
    arr: jax.Array,
    dy: int,
    dx: int,
    *,
    fill: float | None = None,
    wrap_x: bool = False,
) -> jax.Array:
    """Static shift: ``out[y, x] = arr[y + dy, x + dx]``.

    ``fill=None`` edge-clamps; otherwise out-of-range reads yield ``fill``.
    ``wrap_x`` wraps the x axis (sphere longitude ring).
    Implemented with pad+slice so XLA lowers it to cheap copies, not gathers.
    """
    h, w = arr.shape[-2:]
    out = arr
    # ---- x axis ----
    if dx != 0:
        if wrap_x:
            out = jnp.roll(out, -dx, axis=-1)
        else:
            pad = [(0, 0)] * (out.ndim - 1)
            if dx > 0:
                sliced = out[..., dx:]
                if fill is None:
                    edge = sliced[..., -1:]
                    tail = jnp.repeat(edge, dx, axis=-1)
                else:
                    tail = jnp.full(out.shape[:-1] + (dx,), fill, out.dtype)
                out = jnp.concatenate([sliced, tail], axis=-1)
            else:
                sliced = out[..., :dx]
                if fill is None:
                    edge = sliced[..., :1]
                    head = jnp.repeat(edge, -dx, axis=-1)
                else:
                    head = jnp.full(out.shape[:-1] + (-dx,), fill, out.dtype)
                out = jnp.concatenate([head, sliced], axis=-1)
    # ---- y axis (no wrap: latitude clamps) ----
    if dy != 0:
        if dy > 0:
            sliced = out[..., dy:, :]
            if fill is None:
                tail = jnp.repeat(sliced[..., -1:, :], dy, axis=-2)
            else:
                tail = jnp.full(out.shape[:-2] + (dy, w), fill, out.dtype)
            out = jnp.concatenate([sliced, tail], axis=-2)
        else:
            sliced = out[..., :dy, :]
            if fill is None:
                head = jnp.repeat(sliced[..., :1, :], -dy, axis=-2)
            else:
                head = jnp.full(out.shape[:-2] + (-dy, w), fill, out.dtype)
            out = jnp.concatenate([head, sliced], axis=-2)
    return out


def checkerboard_pack(arr: jax.Array, parity) -> jax.Array:
    """Pack the checkerboard colour ``(x + y) % 2 == parity`` into a dense
    half-grid: ``(..., H, W) -> (..., H, W//2)`` with rows preserved.

    Row y keeps columns ``x = (parity + y) % 2, +2, ...``.  H and W must be
    even.  ``parity`` may be traced, so one compiled half-step serves both
    colours.  This is how the red-black update avoids evaluating costs for
    the inactive colour (the reference's separate black/red kernel launches,
    ACMMP.cu:1327-1349, achieve the same by construction).
    """
    H, W = arr.shape[-2], arr.shape[-1]
    assert H % 2 == 0 and W % 2 == 0, (H, W)
    a = arr.reshape(*arr.shape[:-2], H // 2, 2, W // 2, 2)
    even = jax.lax.dynamic_index_in_dim(a[..., 0, :, :], parity, axis=-1,
                                        keepdims=False)
    odd = jax.lax.dynamic_index_in_dim(a[..., 1, :, :], 1 - parity, axis=-1,
                                       keepdims=False)
    stacked = jnp.stack([even, odd], axis=-2)  # (..., H/2, 2, W/2)
    return stacked.reshape(*arr.shape[:-2], H, W // 2)


def checkerboard_unpack(packed: jax.Array, full: jax.Array, parity) -> jax.Array:
    """Write a packed half-grid back into ``full`` at its colour's pixels."""
    H, W = full.shape[-2], full.shape[-1]
    pr = packed.reshape(*packed.shape[:-2], H // 2, 2, W // 2)
    f = full.reshape(*full.shape[:-2], H // 2, 2, W // 2, 2)
    even = jax.lax.dynamic_update_index_in_dim(
        f[..., 0, :, :], pr[..., 0, :][..., None], parity, axis=-1)
    odd = jax.lax.dynamic_update_index_in_dim(
        f[..., 1, :, :], pr[..., 1, :][..., None], 1 - parity, axis=-1)
    return jnp.stack([even, odd], axis=-3).reshape(full.shape)


def checkerboard_coords(height: int, width: int, parity: int):
    """(xs, ys) pixel coordinates of the packed half-grid, (H, W//2) each."""
    xs, ys = grid_coords(height, width)
    return checkerboard_pack(xs, parity), checkerboard_pack(ys, parity)


def shift_valid_mask(height: int, width: int, dy: int, dx: int) -> jax.Array:
    """Boolean mask of pixels whose (y+dy, x+dx) neighbour is in bounds."""
    xs, ys = grid_coords(height, width, jnp.int32)
    return (
        (ys + dy >= 0) & (ys + dy < height) & (xs + dx >= 0) & (xs + dx < width)
    )
