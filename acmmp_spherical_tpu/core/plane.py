"""Plane-hypothesis state.

The reference packs a hypothesis into a float4 (normal xyz + plane offset w,
reference D4) living in one AoS buffer.  Here it is struct-of-arrays:
``normal`` (H, W, 3) + ``w`` (H, W), plus the per-pixel cost, the per-view
selection mask (the reference's ``selected_views`` bitfield as a bool plane
per view) and the hierarchy commit threshold ``pre_cost``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class PlaneState(NamedTuple):
    normal: jax.Array    # (H, W, 3), ref-cam frame during optimisation
    w: jax.Array         # (H, W) plane offset (n . X + w = 0)
    cost: jax.Array      # (H, W)
    selected: jax.Array  # (S, H, W) bool
    pre_cost: jax.Array  # (H, W) hierarchy-mode commit threshold


def empty_state(height: int, width: int, num_src: int) -> PlaneState:
    return PlaneState(
        normal=jnp.zeros((height, width, 3), jnp.float32),
        w=jnp.zeros((height, width), jnp.float32),
        cost=jnp.full((height, width), 2.0, jnp.float32),
        selected=jnp.zeros((num_src, height, width), bool),
        pre_cost=jnp.full((height, width), 2.0, jnp.float32),
    )
