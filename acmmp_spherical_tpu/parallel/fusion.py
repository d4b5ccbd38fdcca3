"""Distributed fusion: reference views sharded over the device mesh.

SURVEY.md 5.8 #3: fusion needs every view's depth/normal/color rasters.  The
Mesh shape: replicate the (V, Hp, Wp) raster stacks across the mesh
(a one-time broadcast; the per-view rasters produced by the view-parallel
passes reshard with one all-gather) and shard the
*reference-view loop* -- each device fuses its shard of reference views into
fixed-size point buffers + validity flags, which are compacted on the host
exactly as in the single-device path.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from acmmp_spherical_tpu.config import FusionParams
from acmmp_spherical_tpu.core.camera import Cameras
from acmmp_spherical_tpu.ops.fusion import fuse_reference_view


def fuse_all_views_sharded(
    mesh: Mesh,
    depths: jax.Array,      # (V, Hp, Wp)
    normals: jax.Array,     # (V, Hp, Wp, 3)
    colors: jax.Array,      # (V, Hp, Wp, 3)
    cams: Cameras,          # batched (V)
    src_indices: np.ndarray,  # (V, K) int32, -1 padded
    params: FusionParams,
    axis: str = "view",
):
    """Fuse every reference view with the per-view work sharded over ``axis``.

    Pads the view list to a multiple of the mesh size, vmaps the per-view
    fusion kernel and shards the vmapped axis; returns host-compacted numpy
    (points, normals, colors).
    """
    V = depths.shape[0]
    n_dev = mesh.devices.size
    Vp = -(-V // n_dev) * n_dev
    ref_ids = np.arange(Vp, dtype=np.int32) % max(V, 1)   # wrap padding refs
    pad_valid = np.arange(Vp) < V
    src_pad = np.full((Vp, src_indices.shape[1]), -1, np.int32)
    src_pad[:V] = src_indices

    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P(axis))

    @functools.partial(
        jax.jit,
        in_shardings=(repl, repl, repl, repl, shard, shard),
        out_shardings=(shard, shard, shard, shard),
        static_argnames=(),
    )
    def run(depths, normals, colors, cams, ref_ids, src_ids):
        return jax.vmap(
            lambda r, s: fuse_reference_view(
                depths, normals, colors, cams, r, s, params)
        )(ref_ids, src_ids)

    pts, nrm, col, valid = run(
        depths, normals, colors, cams,
        jnp.asarray(ref_ids), jnp.asarray(src_pad),
    )
    out_p, out_n, out_c = [], [], []
    valid = np.asarray(valid)
    for i in range(V):
        m = valid[i] if pad_valid[i] else np.zeros_like(valid[i])
        out_p.append(np.asarray(pts[i])[m])
        out_n.append(np.asarray(nrm[i])[m])
        out_c.append(np.asarray(col[i])[m])
    return (
        np.concatenate(out_p) if out_p else np.zeros((0, 3)),
        np.concatenate(out_n) if out_n else np.zeros((0, 3)),
        np.concatenate(out_c) if out_c else np.zeros((0, 3)),
    )
