"""Adaptive checkerboard candidate sampling.

Reference CheckerboardPropagation's first stage (ACMMP.cu:956-1144): each pixel
collects 8 candidate hypotheses -- the min-*stored*-cost neighbour from four
V-shaped "near" regions and four 2-px-strided "far" strips along the axes.

Array-program form: each region's candidate search is an elementwise argmin over a
fixed set of statically *shifted* cost maps (cheap pad+slice copies, no
gathers), then the winning neighbour's plane is selected with the same shifts.

Concurrency note: the base offsets and far strips reach the opposite
checkerboard colour, but the fork's V-region extras (dy = -(2+i), dx = -+i;
ACMMP.cu:1047-1061) land on the SAME colour -- in the CUDA kernel those are
racy same-launch reads that may observe either the old or the just-updated
neighbour.  Our functional half-step always reads the pre-halfstep state: a
deterministic serialization of the reference's race envelope (SURVEY.md 5.2).

For spherical cameras the x axis is a longitude ring: shifts wrap, so
propagation crosses the seam (the reference's linear indexing cannot; a
documented improvement).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.ops.sampling import shift2d

INF = jnp.inf

# Region offset tables, (dy, dx), derived from ACMMP.cu:965-1143.
# near V-regions: base +-1 step plus 6 flanking candidates
_UP_NEAR = [(-1, 0)] + [(-(2 + i), -i) for i in range(3)] + [(-(2 + i), i) for i in range(3)]
_DOWN_NEAR = [(1, 0)] + [((2 + i), -i) for i in range(3)] + [((2 + i), i) for i in range(3)]
_LEFT_NEAR = [(0, -1)] + [(-i, -(2 + i)) for i in range(3)] + [(i, -(2 + i)) for i in range(3)]
_RIGHT_NEAR = [(0, 1)] + [(-i, (2 + i)) for i in range(3)] + [(i, (2 + i)) for i in range(3)]
# far strips: +-3, +-5, ..., +-23 along the axis (11 samples)
_UP_FAR = [(-(3 + 2 * i), 0) for i in range(11)]
_DOWN_FAR = [((3 + 2 * i), 0) for i in range(11)]
_LEFT_FAR = [(0, -(3 + 2 * i)) for i in range(11)]
_RIGHT_FAR = [(0, (3 + 2 * i)) for i in range(11)]

# region order matches the reference cost_array indexing (ACMMP.cu:958):
# 0 up_near, 1 up_far, 2 down_near, 3 down_far, 4 left_near, 5 left_far,
# 6 right_near, 7 right_far
REGIONS = [
    _UP_NEAR, _UP_FAR, _DOWN_NEAR, _DOWN_FAR,
    _LEFT_NEAR, _LEFT_FAR, _RIGHT_NEAR, _RIGHT_FAR,
]
# regions whose *base* neighbour feeds the view-selection prior
# (ACMMP.cu:1149-1160): up, down, left, right near.
NEAR_REGION_INDICES = (0, 2, 4, 6)
NEAR_BASE_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))


class Candidates(NamedTuple):
    normal: jax.Array  # (8, H, W, 3)
    w: jax.Array       # (8, H, W)
    valid: jax.Array   # (8, H, W) bool: region base neighbour exists


def gather_candidates(
    normal: jax.Array,   # (H, W, 3) current plane field
    w: jax.Array,        # (H, W)
    cost: jax.Array,     # (H, W) current stored costs
    *,
    wrap_x: bool,
) -> Candidates:
    """Select the min-cost neighbour hypothesis of each of the 8 regions."""
    H, W = cost.shape
    normal_cf = jnp.moveaxis(normal, -1, 0)  # (3, H, W): shift2d is spatial-last
    cand_n, cand_w, cand_valid = [], [], []

    for offsets in REGIONS:
        # stack shifted cost maps; out-of-bounds -> +inf so argmin skips them
        shifted_costs = jnp.stack(
            [shift2d(cost, dy, dx, fill=INF, wrap_x=wrap_x) for dy, dx in offsets]
        )  # (K, H, W)
        best = jnp.argmin(shifted_costs, axis=0)  # (K axis) -> (H, W)

        sel_n = jnp.zeros_like(normal_cf)
        sel_w = jnp.zeros_like(w)
        for k, (dy, dx) in enumerate(offsets):
            m = (best == k)
            sel_n = jnp.where(
                m[None], shift2d(normal_cf, dy, dx, wrap_x=wrap_x), sel_n
            )
            sel_w = jnp.where(m, shift2d(w, dy, dx, wrap_x=wrap_x), sel_w)
        sel_n = jnp.moveaxis(sel_n, 0, -1)  # back to (H, W, 3)

        # region validity: the reference requires the *base* offset in bounds
        # (flag[k], ACMMP.cu:966/985/1004/1023/1042/...); min over shifted
        # costs being finite is equivalent (base offset always has the
        # smallest reach in its region).
        valid = jnp.isfinite(jnp.min(shifted_costs, axis=0))
        cand_n.append(sel_n)
        cand_w.append(sel_w)
        cand_valid.append(valid)

    return Candidates(
        normal=jnp.stack(cand_n),
        w=jnp.stack(cand_w),
        valid=jnp.stack(cand_valid),
    )


def neighbor_selected_views(
    selected: jax.Array,  # (S, H, W) bool
    *,
    wrap_x: bool,
):
    """Shifted selected-view masks of the 4 adjacent pixels plus their
    in-bounds flags; feeds the view-selection prior (ACMMP.cu:1149-1160).

    Returns (neigh_sel (4, S, H, W) bool, neigh_ok (4, H, W) bool).
    """
    S, H, W = selected.shape
    sels, oks = [], []
    for dy, dx in NEAR_BASE_OFFSETS:
        sels.append(shift2d(selected, dy, dx, fill=0, wrap_x=wrap_x))
        ok = jnp.ones((H, W), bool)
        if dy != 0:
            ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
            ok = ok & (ys + dy >= 0) & (ys + dy < H)
        if dx != 0 and not wrap_x:
            xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
            ok = ok & (xs + dx >= 0) & (xs + dx < W)
        oks.append(ok)
    return jnp.stack(sels), jnp.stack(oks)
