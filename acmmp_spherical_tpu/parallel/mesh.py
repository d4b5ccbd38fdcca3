"""Device mesh helpers for multi-chip / multi-host runs.

The reference is single-GPU (``cudaSetDevice(0)``, main.cpp:77) with all
cross-view dataflow through the filesystem.  The scaling axes here
(SURVEY.md 5.8) are:

* ``view``: the embarrassingly parallel per-Problem loop (data parallel);
* ``tile``: intra-image tiling for very large frames (halo exchange; the
  longitude axis of spherical frames is a ring).

Shardings are expressed with ``jax.sharding``; XLA inserts the collectives.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_view_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D mesh over the view (problem) axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("view",))


def make_view_tile_mesh(n_view: int, n_tile: int, devices=None) -> Mesh:
    """2D mesh: problems x image tiles."""
    if devices is None:
        devices = jax.devices()
    dev = np.asarray(devices[: n_view * n_tile]).reshape(n_view, n_tile)
    return Mesh(dev, ("view", "tile"))


def view_sharding(mesh: Mesh, *trailing_none: int) -> NamedSharding:
    """Shard the leading (problem) axis over 'view'; replicate the rest."""
    return NamedSharding(mesh, P("view", *([None] * trailing_none)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_over_views(mesh: Mesh, batch):
    """Place a batched pytree with its leading axis sharded over 'view'."""
    def place(x):
        spec = P("view", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, batch)
