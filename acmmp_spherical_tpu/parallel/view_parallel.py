"""View-parallel execution: shard Problems over the device mesh.

The distribution strategy (SURVEY.md 5.8): within a pass, Problems are
independent -> pure data parallelism over the ``view`` mesh axis.  Between a
photometric pass and a geometric pass, each problem needs the *depth maps of
its source views*, which live on other devices -> a cross-view exchange,
expressed as a resharding to replicated (XLA lowers it to an all-gather over
ICI) followed by a per-problem gather of its source set.

``multichip_train_step`` builds the full jittable step used both by the
driver's multi-chip dry-run and by scaling benchmarks: photometric pass on
every problem -> all-gather depths -> geometric-consistency pass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core.camera import Cameras
from acmmp_spherical_tpu.ops.ncc import ref_tap_context
from acmmp_spherical_tpu.ops.propagate import (
    PatchMatchInputs,
    checkerboard_halfstep,
    extract_depth_and_normal,
    initialize_state,
    prepare_inputs,
)


class ProblemBatch(NamedTuple):
    """B problems with identical shapes, batched leaf-wise.

    ``images``: (B, V, Hp, Wp) -- view 0 of each problem is its reference.
    ``cams``: Cameras pytree with leaves (B, V, ...).
    ``src_valid``: (B, V-1).
    ``src_view_global``: (B, V-1) int32 index of each source view in the
    global problem list (for the cross-device depth exchange); -1 = padding.
    """

    images: jax.Array
    cams: Cameras
    src_valid: jax.Array
    src_view_global: jax.Array


def _single_problem_inputs(images, cams, src_valid, src_depths=None):
    ref_cam = jax.tree.map(lambda a: a[0], cams)
    src_cams = jax.tree.map(lambda a: a[1:], cams)
    return PatchMatchInputs(
        ref_image=images[0],
        src_images=images[1:],
        ref_cam=ref_cam,
        src_cams=src_cams,
        src_valid=src_valid,
        src_depths=src_depths,
    )


def _photometric_pass(images, cams, src_valid, params, key, n_iterations):
    inputs = prepare_inputs(_single_problem_inputs(images, cams, src_valid))
    ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, params)
    state = initialize_state(inputs, params, key, ctx=ctx)

    def step(state, sk):
        k, it = sk
        k0, k1 = jax.random.split(k)
        state = checkerboard_halfstep(state, inputs, ctx, params, k0, it, 0)
        state = checkerboard_halfstep(state, inputs, ctx, params, k1, it, 1)
        return state, None

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i + 1))(
        jnp.arange(n_iterations)
    )
    state, _ = jax.lax.scan(step, state, (keys, jnp.arange(n_iterations)))
    depth, normal = extract_depth_and_normal(state, inputs.ref_cam)
    return depth, normal, state.cost


def _geom_pass(images, cams, src_valid, seed_normal, seed_depth, src_depths,
               params, key, n_iterations):
    inputs = prepare_inputs(
        _single_problem_inputs(images, cams, src_valid, src_depths)
    )
    ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, params)
    state = initialize_state(
        inputs, params, key,
        seed_normal_world=seed_normal, seed_depth=seed_depth, ctx=ctx,
    )
    state = checkerboard_halfstep(state, inputs, ctx, params, key, 0, 0)
    state = checkerboard_halfstep(state, inputs, ctx, params, key, 0, 1)
    depth, normal = extract_depth_and_normal(state, inputs.ref_cam)
    return depth, normal, state.cost


def multichip_train_step(mesh: Mesh, params: PatchMatchParams,
                         n_iterations: int = 1):
    """Build the jitted sharded step: photometric -> exchange -> geometric.

    Input/output leading axes are sharded over the ``view`` mesh axis; the
    depth exchange reshards per-problem depth maps to replicated, which XLA
    implements as an all-gather over the mesh.
    """
    geom_params = params.with_geom()
    shard = NamedSharding(mesh, P("view"))
    repl = NamedSharding(mesh, P())

    @functools.partial(jax.jit,
                       in_shardings=(shard, repl),
                       out_shardings=(shard, shard, shard))
    def step(batch: ProblemBatch, key):
        B = batch.images.shape[0]
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(B))

        # --- photometric pass, data-parallel over problems ----------------
        depth, normal, cost = jax.vmap(
            lambda im, cam, sv, k: _photometric_pass(
                im, cam, sv, params, k, n_iterations)
        )(batch.images, batch.cams, batch.src_valid, keys)

        # --- cross-view depth exchange (all-gather over ICI) --------------
        all_depths = jax.lax.with_sharding_constraint(depth, repl)  # (B, H, W)

        def gather_src_depths(src_ids):
            # (V-1, H, W): each problem picks its sources from the gathered set
            safe = jnp.maximum(src_ids, 0)
            return jnp.where(
                (src_ids >= 0)[:, None, None], all_depths[safe], 0.0
            )

        src_depths = jax.vmap(gather_src_depths)(batch.src_view_global)

        # --- geometric-consistency pass -----------------------------------
        depth_g, normal_g, cost_g = jax.vmap(
            lambda im, cam, sv, sn, sd, sdep, k: _geom_pass(
                im, cam, sv, sn, sd, sdep, geom_params, k, n_iterations)
        )(batch.images, batch.cams, batch.src_valid, normal, depth,
          src_depths, keys)

        return depth_g, normal_g, cost_g

    return step
