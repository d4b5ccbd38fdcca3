"""One full PatchMatch pass over a single Problem (device-side driver).

Equivalent of the reference's ``ACMMP::RunPatchMatch`` launch sequence
(ACMMP.cu:1506-1556): random/seeded init, ``max_iterations`` x (black, red)
propagation half-steps, depth/normal extraction, black/red median filter.
The whole pass is one jit-compiled function: XLA sees the complete program and
fuses across stages; there are no host round-trips between "kernels".
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core.camera import SPHERE
from acmmp_spherical_tpu.core.plane import PlaneState
from acmmp_spherical_tpu.ops.filter import checkerboard_median_filter
from acmmp_spherical_tpu.ops.ncc import ref_tap_context
from acmmp_spherical_tpu.ops.propagate import (
    PatchMatchInputs,
    checkerboard_halfstep,
    extract_depth_and_normal,
    initialize_state,
    prepare_inputs,
)


@functools.partial(jax.jit, static_argnames=("params", "shard_state"))
def run_patchmatch(
    inputs: PatchMatchInputs,
    params: PatchMatchParams,
    key: jax.Array,
    prev_state: Optional[PlaneState] = None,
    seed_normal_world: Optional[jax.Array] = None,
    seed_depth: Optional[jax.Array] = None,
    shard_state=None,
):
    """Run one complete pass.

    Returns (depth (H, W), normal_world (H, W, 3), cost (H, W), state).

    ``shard_state`` (static): optional ``PlaneState -> PlaneState`` hook
    applying ``with_sharding_constraint`` after init and every half-step --
    the intra-image tile-parallel mode (parallel/tile.py) pins the plane
    state to a width sharding so GSPMD partitions the propagation stencils
    with halo exchange (ring on the width axis for SPHERE).
    """
    inputs = prepare_inputs(inputs)
    ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, params)
    k_init, k_iters = jax.random.split(key)

    state = initialize_state(
        inputs, params, k_init,
        prev_state=prev_state,
        seed_normal_world=seed_normal_world,
        seed_depth=seed_depth,
        ctx=ctx,
    )
    if shard_state is not None:
        state = shard_state(state)

    # one scan step per half-step, the colour (parity) traced: the program
    # holds one copy of the half-step instead of two, which halves what XLA
    # compiles.  Iteration i runs black then red with the two halves of
    # split(fold_in(k_iters, i)).
    def step(state, sk):
        k, it, parity = sk
        state = checkerboard_halfstep(state, inputs, ctx, params, k, it, parity)
        if shard_state is not None:
            state = shard_state(state)
        return state, None

    n = params.max_iterations
    keys = jax.vmap(lambda i: jax.random.split(jax.random.fold_in(k_iters, i))
                    )(jnp.arange(n)).reshape(2 * n)
    iters = jnp.repeat(jnp.arange(n), 2)
    parities = jnp.tile(jnp.arange(2), n)
    state, _ = jax.lax.scan(step, state, (keys, iters, parities))

    depth, normal_world = extract_depth_and_normal(state, inputs.ref_cam)
    depth = checkerboard_median_filter(
        depth, state.cost, min_cost=params.filter_min_cost,
        wrap_x=inputs.ref_cam.model == SPHERE,
    )
    return depth, normal_world, state.cost, state

