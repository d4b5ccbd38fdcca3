"""Device-batched pass execution: problems sharded over the device mesh.

The reference runs its per-image loop strictly serially on one GPU
(main.cpp:431-446) and exchanges depth maps through the filesystem
(ACMMP.cpp:653-678).  Here a whole *chunk* of problems -- one per local
device -- runs as ONE jitted program with the problem axis sharded over the
``view`` mesh axis (parallel/mesh.py): under ``shard_map`` every device runs
the ordinary single-problem pass on its own reference view, with no
per-problem host round-trips inside a chunk.  (``shard_map`` rather than a
GSPMD-partitioned ``vmap``: the Pallas cost kernel is a custom call that the
partitioner cannot split, and its Triton grid has no room for a batch axis.)

.dmb checkpoints are still written after every pass (resume/fusion read
them), but *within* a chunk the data never leaves the devices.  The
geometric-consistency source depths are assembled host-side from the just-
computed results (the checkpoint layer), matching the reference's exchange
semantics while the collective-based exchange (parallel/view_parallel.py)
remains available for fused photometric->geom steps.

Chunks are sized to a multiple of the local device count; the trailing
chunk is padded by repeating its last problem (padded results are simply
not written).  All problems of one scale share identical padded shapes
(load_problem's scene-wide view padding plus the chunk-wide image stack
shape computed here), so one chunk program serves the whole scale.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from acmmp_spherical_tpu.config import PipelineConfig
from acmmp_spherical_tpu.io import dmb
from acmmp_spherical_tpu.io.image import write_png
from acmmp_spherical_tpu.io.scene import Problem, ScenePaths
from acmmp_spherical_tpu.parallel.mesh import make_view_mesh
from acmmp_spherical_tpu.pipeline.pass_runner import (
    LoadedProblem, _load_hierarchy_seed, _load_seed, load_problem,
)
from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_tpu.pipeline.prior import build_planar_prior, draw_triangulation
from acmmp_spherical_tpu.utils.log import get_logger

log = get_logger(__name__)


def _stack_tree(trees):
    """Stack a list of identically-shaped pytrees along a new leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _index_tree(tree, i):
    return jax.tree.map(lambda a: np.asarray(a[i]), tree)


@dataclasses.dataclass
class _Chunk:
    indices: list            # problem indices (without padding)
    lps: list                # LoadedProblem per slot (len = padded size)
    params: object           # shared static PatchMatchParams


def _device_pass(inputs, key, prev_state, seed_normal, seed_depth, *,
                 params):
    """One device's pass: its slice of each argument holds one problem."""
    one = lambda tree: jax.tree.map(lambda a: a[0], tree)
    out = run_patchmatch(one(inputs), params, one(key),
                         prev_state=one(prev_state),
                         seed_normal_world=one(seed_normal),
                         seed_depth=one(seed_depth))
    return jax.tree.map(lambda a: a[None], out)


@functools.partial(jax.jit, static_argnames=("mesh", "params"))
def _run_on_devices(inputs, key, prev_state=None, seed_normal=None,
                    seed_depth=None, *, mesh, params):
    """A chunk's pass: the leading (problem) axis of every argument and
    result is sharded over ``view``, one problem per device."""
    return jax.shard_map(
        functools.partial(_device_pass, params=params), mesh=mesh,
        in_specs=P("view"), out_specs=P("view"),
        # the pass is written for one device; its scan carries start as
        # device-invariant zeros
        check_vma=False,
    )(inputs, key, prev_state, seed_normal, seed_depth)


def _shard_batch(mesh, batch):
    def place(x):
        return jax.device_put(
            x, NamedSharding(mesh, P("view", *([None] * (x.ndim - 1)))))

    return jax.tree.map(place, batch)


def _chunks(sp: ScenePaths, problems: Sequence[Problem], order, cfg,
            mesh, *, geom: bool, multi_geometry: bool):
    """Load problems into device-count-sized chunks of uniform shape.

    Problems are grouped by (ref shape, src-stack shape, camera model) so
    every chunk is one XLA program; groups flush as they fill, trailing
    partial groups are padded by repeating the last member (padded results
    are not written).
    """
    n_dev = mesh.devices.size
    groups: dict = {}
    for idx in order:
        lp, params = load_problem(sp, problems, idx, cfg, geom=geom,
                                  multi_geometry=multi_geometry)
        key = (lp.inputs.ref_image.shape, lp.inputs.src_images.shape,
               lp.ref_cam.model)
        g = groups.setdefault(key, ([], [], []))
        g[0].append(idx)
        g[1].append(lp)
        g[2].append(params)
        if len(g[0]) == n_dev:
            del groups[key]
            yield _make_chunk(g, n_dev)
    for g in groups.values():
        yield _make_chunk(g, n_dev)


def _make_chunk(g, n_dev) -> _Chunk:
    idxs, lps, plist = g
    lps = list(lps)
    while len(lps) < n_dev:          # pad the trailing chunk
        lps.append(lps[-1])
    params = plist[0]
    return _Chunk(indices=list(idxs), lps=lps, params=params)


def _prefetched(it, lookahead: int = 1):
    """Overlap host-side chunk loading (image/dmb IO, rescale, packing) with
    the previous chunk's device execution: the next chunk is materialised on
    a worker thread while the main thread blocks on device results.  The
    reference serialises these (main.cpp:431-446)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=lookahead)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # surface loader errors in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def run_pass_batched(
    sp: ScenePaths,
    problems: Sequence[Problem],
    order: Sequence[int],
    cfg: PipelineConfig,
    *,
    geom: bool = False,
    planar_prior: bool = False,
    hierarchy: bool = False,
    multi_geometry: bool = False,
    seed: Optional[int] = None,
    mesh=None,
) -> None:
    """One full pass over ``order``'s problems, chunked over the mesh.

    Batched equivalent of pass_runner.process_problem (the serial path);
    produces the same .dmb outputs.
    """
    if mesh is None:
        mesh = make_view_mesh()
    base_key = jax.random.key(cfg.seed if seed is None else seed)

    for chunk in _prefetched(_chunks(sp, problems, order, cfg, mesh,
                                     geom=geom,
                                     multi_geometry=multi_geometry)):
        params = chunk.params
        if hierarchy:
            params = params.with_hierarchy()
        binputs = _shard_batch(mesh, _stack_tree([lp.inputs for lp in chunk.lps]))
        ids = [problems[i].ref_image_id for i in chunk.indices]
        keys = jnp.stack([
            jax.random.fold_in(base_key, problems[i].ref_image_id)
            for i in (chunk.indices + [chunk.indices[-1]] *
                      (len(chunk.lps) - len(chunk.indices)))
        ])

        seed_normal = seed_depth = None
        if geom or hierarchy:
            sn, sd = [], []
            for slot, lp in enumerate(chunk.lps):
                pid = problems[chunk.indices[min(slot, len(chunk.indices) - 1)]
                               ].ref_image_id
                if geom:
                    a, b = _load_seed(sp, pid, multi_geometry=multi_geometry)
                else:
                    a, b = _load_hierarchy_seed(sp, lp, pid)
                sn.append(a)
                sd.append(b)
            seed_normal = _shard_batch(mesh, jnp.stack(sn))
            seed_depth = _shard_batch(mesh, jnp.stack(sd))

        log.info("batched pass B=%d ids=%s geom=%s prior=%s hier=%s",
                 len(chunk.lps), ids, geom, planar_prior, hierarchy)

        depth, normal_world, cost, state = _run_on_devices(
            binputs, keys, seed_normal=seed_normal, seed_depth=seed_depth,
            mesh=mesh, params=params)

        if planar_prior:
            # host side: Delaunay prior per problem (ACMMP.cpp:904-1011),
            # then ONE batched prior-mode pass for the problems with priors
            d_h = np.asarray(depth)
            c_h = np.asarray(cost)
            prior_n = np.zeros(d_h.shape + (3,), np.float32)
            prior_w = np.zeros_like(d_h)
            prior_m = np.zeros(d_h.shape, bool)
            any_prior = False
            for slot in range(len(chunk.indices)):
                lp = chunk.lps[slot]
                pid = problems[chunk.indices[slot]].ref_image_id
                dmin, dmax = np.asarray(lp.ref_cam.depth_range)
                pn, pw, mask, tris = build_planar_prior(
                    lp.ref_cam, d_h[slot], c_h[slot],
                    cfg.depth_min_scale * dmin, cfg.depth_max_scale * dmax,
                    cfg.prior,
                )
                sp.result_dir(pid).mkdir(parents=True, exist_ok=True)
                write_png(sp.result_dir(pid) / "triangulation.png",
                          draw_triangulation(lp.ref_image_np, tris))
                if mask.any():
                    any_prior = True
                    prior_n[slot], prior_w[slot], prior_m[slot] = pn, pw, mask
            for slot in range(len(chunk.indices), len(chunk.lps)):
                prior_n[slot] = prior_n[len(chunk.indices) - 1]
                prior_w[slot] = prior_w[len(chunk.indices) - 1]
                prior_m[slot] = prior_m[len(chunk.indices) - 1]
            if any_prior:
                pinputs = binputs._replace(
                    prior_normal=_shard_batch(mesh, jnp.asarray(prior_n)),
                    prior_w=_shard_batch(mesh, jnp.asarray(prior_w)),
                    prior_mask=_shard_batch(mesh, jnp.asarray(prior_m)),
                )
                pparams = params.with_planar_prior()
                pkeys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
                depth, normal_world, cost, state = _run_on_devices(
                    pinputs, pkeys, state, mesh=mesh, params=pparams)

        d_h = np.asarray(depth)
        n_h = np.asarray(normal_world)
        c_h = np.asarray(cost)
        for slot in range(len(chunk.indices)):
            pid = problems[chunk.indices[slot]].ref_image_id
            sp.result_dir(pid).mkdir(parents=True, exist_ok=True)
            dmb.write_dmb(sp.depth_file(pid, geom=geom), d_h[slot])
            dmb.write_dmb(sp.normal_file(pid), n_h[slot])
            dmb.write_dmb(sp.cost_file(pid), c_h[slot])
