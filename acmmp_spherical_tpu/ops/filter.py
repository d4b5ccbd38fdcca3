"""Checkerboard median depth filter.

Reference CheckerboardFilter (ACMMP.cu:1366-1504): after depth extraction, each
pixel whose cost is >= 0.001 replaces its depth with the median over a 21-tap
two-ring checkerboard stencil (self + axis offsets 1/3/5 + 8 diagonal-ish
taps), run black half then red half (the red half sees the black half's
already-filtered depths, which the sequential masked update preserves here).

Array-program form: stack the statically shifted depth maps, mask out-of-bounds taps to
+inf, sort along the tap axis and index the masked median -- an elementwise
sort of 21 lanes instead of per-thread insertion sort.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.ops.sampling import grid_coords, shift2d, shift_valid_mask

# (dy, dx) stencil, in reference read order (ACMMP.cu:1379-1471); index 0 is
# the centre pixel.
_STENCIL = [
    (0, 0),
    (-1, 0), (-3, 0), (-5, 0),      # up
    (1, 0), (3, 0), (5, 0),         # down
    (0, -1), (0, -3), (0, -5),      # left
    (0, 1), (0, 3), (0, 5),         # right
    (-1, 2), (1, 2), (-1, -2), (1, -2),
    (-2, -1), (-2, 1), (2, -1), (2, 1),
]


def _median_halfstep(depth, cost, parity, min_cost, wrap_x):
    H, W = depth.shape
    taps = []
    valid = []
    for dy, dx in _STENCIL:
        taps.append(shift2d(depth, dy, dx, fill=jnp.inf, wrap_x=wrap_x))
        if wrap_x:
            v = shift_valid_mask(H, W, dy, 0)
        else:
            v = shift_valid_mask(H, W, dy, dx)
        valid.append(v)
    taps = jnp.stack(taps)                 # (21, H, W)
    valid = jnp.stack(valid)
    taps = jnp.where(valid, taps, jnp.inf)
    count = jnp.sum(valid, axis=0)         # (H, W) number of in-bounds taps

    s = jnp.sort(taps, axis=0)             # invalid (+inf) sort to the end
    mid = count // 2
    hi = jnp.take_along_axis(s, mid[None], 0)[0]
    lo = jnp.take_along_axis(s, jnp.maximum(mid - 1, 0)[None], 0)[0]
    med = jnp.where(count % 2 == 0, 0.5 * (lo + hi), hi)

    xs, ys = grid_coords(H, W)
    par = ((xs.astype(jnp.int32) + ys.astype(jnp.int32)) % 2) == parity
    do = par & (cost >= min_cost)          # low-cost pixels keep their depth
    return jnp.where(do, med, depth)


def checkerboard_median_filter(
    depth: jax.Array, cost: jax.Array, *, min_cost: float = 0.001,
    wrap_x: bool = False,
) -> jax.Array:
    """Black then red half-step median filtering of the depth map."""
    depth = _median_halfstep(depth, cost, 0, min_cost, wrap_x)
    depth = _median_halfstep(depth, cost, 1, min_cost, wrap_x)
    return depth
