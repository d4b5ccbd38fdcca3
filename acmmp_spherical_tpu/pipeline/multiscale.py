"""Coarse-to-fine pipeline driver.

Equivalent of the reference ``main()`` (main.cpp:392-482): compute per-image
pyramid settings, then per scale run [planar-prior pass -> 2 geometric passes]
(the first scale photometric, later scales hierarchy-seeded after a JBU depth
upsample), and finally fuse all views into a colored point cloud.

Adds what the reference lacks: structured logging, per-pass timings, and
manifest-based skip-if-complete resume on top of the .dmb checkpoint layer
(SURVEY.md 5.4).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import jax.numpy as jnp

from acmmp_spherical_tpu.config import PipelineConfig
from acmmp_spherical_tpu.core.camera import scale_camera, stack_cameras
from acmmp_spherical_tpu.io import dmb, write_ply
from acmmp_spherical_tpu.io.image import resize_bilinear
from acmmp_spherical_tpu.io.scene import (
    Problem, ScenePaths, load_image_color, load_image_gray, read_camera_file,
    read_pair_file, is_pass_complete, mark_pass_complete,
)
from acmmp_spherical_tpu.ops.fusion import fuse_all_views
from acmmp_spherical_tpu.ops.jbu import joint_bilateral_upsample
from acmmp_spherical_tpu.pipeline.pass_runner import process_problem, _pad_stack
from acmmp_spherical_tpu.utils.log import get_logger, Timings

log = get_logger(__name__)


@dataclasses.dataclass
class PipelineResult:
    """What :func:`run_pipeline` did: fused points, the (pass, image) pairs
    skipped after two failures, and per-stage wall times."""

    n_points: int
    skipped: list
    timings: Timings


def compute_multiscale_settings(
    sp: ScenePaths, problems: Sequence[Problem], cfg: PipelineConfig
) -> int:
    """Per-image pyramid depth (reference ComputeMultiScaleSettings,
    main.cpp:35-71). Returns the global max number of downscales."""
    max_k = -1
    for p in problems:
        img = load_image_gray(sp.image_file(p.ref_image_id))
        max_size = min(max(img.shape[:2]), cfg.patchmatch.max_image_size)
        p.max_image_size = max_size
        k = 0
        while max_size > cfg.size_bound:
            max_size //= 2
            k += 1
        p.num_downscale = k
        max_k = max(max_k, k)
    return max_k


def joint_bilateral_upsampling_pass(
    sp: ScenePaths, problem: Problem, target_size: int
) -> None:
    """Upsample depths_geom.dmb to the next scale's resolution, writing the
    depths.dmb seed (reference JointBilateralUpsampling, main.cpp:212-238 +
    RunJBU, ACMMP.cpp:1071-1122)."""
    dpath = sp.depth_file(problem.ref_image_id, geom=True)
    if not dpath.exists():
        # this view's previous pass was skipped (and is reported as such);
        # its next-scale pass starts from a fresh random init
        log.warning("JBU skip (missing %s) image=%08d", dpath,
                    problem.ref_image_id)
        return
    depth = dmb.read_depth_dmb(dpath)
    img = load_image_gray(sp.image_file(problem.ref_image_id))
    h, w = img.shape
    factor = min(target_size / w, target_size / h)
    nw, nh = round(w * factor), round(h * factor)
    guide = resize_bilinear(img, nh, nw)

    scale = max(nh // depth.shape[0], nw // depth.shape[1])
    if scale == 1:
        log.info("JBU skip (scale ratio 1) image=%08d", problem.ref_image_id)
        return
    up = joint_bilateral_upsample(jnp.asarray(depth), jnp.asarray(guide))
    dmb.write_dmb(sp.depth_file(problem.ref_image_id, geom=False), np.asarray(up))


def run_fusion(sp: ScenePaths, problems: Sequence[Problem], cfg: PipelineConfig,
               *, geom: bool = True) -> int:
    """Load every view's final results and fuse (RunFusionCuda analog,
    ACMMP.cu:1817-2105). Returns the number of fused points."""
    depths, normals, colors, cams, ids = [], [], [], [], []
    for p in problems:
        dpath = sp.depth_file(p.ref_image_id, geom=geom)
        npath = sp.normal_file(p.ref_image_id)
        if not dpath.exists() or not npath.exists():
            log.warning("fusion: missing results for %08d, skipping", p.ref_image_id)
            continue
        depth = dmb.read_depth_dmb(dpath)
        normal = dmb.read_normal_dmb(npath)
        img = load_image_color(sp.image_file(p.ref_image_id))
        h, w = depth.shape
        cam = read_camera_file(sp.camera_file(p.ref_image_id))
        # RescaleImageAndCamera: match image + intrinsics to the depth size
        sy, sx = h / img.shape[0], w / img.shape[1]
        if img.shape[:2] != (h, w):
            img = resize_bilinear(img, h, w)
        cam = scale_camera(cam, sx, sy, w, h)
        ids.append(p.ref_image_id)
        depths.append(depth)
        normals.append(normal)
        colors.append(img.astype(np.float32))
        cams.append(cam)

    if not depths:
        log.warning("fusion: nothing to fuse")
        return 0

    id_to_index = {im_id: i for i, im_id in enumerate(ids)}
    # fusion remaps up to fusion.max_src_views (32) sources per reference view
    # (reference FusionProblem, ACMMP.cu:1656-1661, 2000-2017) -- independent
    # of the PatchMatch-stack cap cfg.max_src_views, so scenes with long
    # pair.txt neighbour lists keep their fusion evidence.
    K = cfg.fusion.max_src_views
    src_idx = np.full((len(ids), K), -1, np.int32)
    for row, p in enumerate([q for q in problems if q.ref_image_id in id_to_index]):
        col = 0
        for sid in p.src_image_ids:
            if col >= K:
                break
            if sid in id_to_index:
                src_idx[row, col] = id_to_index[sid]
                col += 1

    dstack = jnp.asarray(_pad_stack(depths))
    hp, wp = dstack.shape[1:]
    nstack = np.zeros((len(ids), hp, wp, 3), np.float32)
    cstack = np.zeros((len(ids), hp, wp, 3), np.float32)
    for i, (nr, co) in enumerate(zip(normals, colors)):
        nstack[i, : nr.shape[0], : nr.shape[1]] = nr
        cstack[i, : co.shape[0], : co.shape[1]] = co

    pts, nrm, col = fuse_all_views(
        dstack, jnp.asarray(nstack), jnp.asarray(cstack),
        stack_cameras(cams), src_idx, cfg.fusion,
    )
    sp.output_dir.mkdir(parents=True, exist_ok=True)
    write_ply(sp.ply_file(), pts, nrm, col)
    log.info("fusion wrote %d points -> %s", len(pts), sp.ply_file())
    return len(pts)


def run_pipeline(root, cfg: PipelineConfig = PipelineConfig(),
                 *, mesh=None) -> PipelineResult:
    """Full coarse-to-fine reconstruction of a scene folder.

    Returns the fused point count and the passes that failed.  Mirrors
    reference main(): per scale,
    photometric/hierarchy + planar-prior pass, then ``geom_iterations``
    geometric passes (the 2nd with multi_geometry).

    Multi-host: when ``jax.process_count() > 1`` (the CLI's ``--distributed``
    initialises ``jax.distributed``), problems are round-robin assigned to
    hosts; inter-host exchange stays on the shared filesystem through the
    .dmb checkpoint layer (the reference's own exchange mechanism,
    ACMMP.cpp:653-678), with a cross-host barrier between passes so geometric
    passes always see every source view's previous pass.
    """
    import jax

    sp = ScenePaths(root)
    problems = read_pair_file(sp.pair_file)
    sp.output_dir.mkdir(parents=True, exist_ok=True)
    timings = Timings()

    n_proc = jax.process_count()
    proc = jax.process_index()
    log.info("%d problems, host %d/%d", len(problems), proc, n_proc)

    def _barrier(name: str) -> None:
        if n_proc > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(name)

    # device-batched execution (pipeline/batch_runner): one jitted program per
    # chunk with the problem axis sharded over the local view mesh, replacing
    # the reference's strictly serial per-image loop (main.cpp:431-446)
    tile_mesh = None
    if cfg.tile_shard > 1:
        from acmmp_spherical_tpu.parallel.tile import make_tile_mesh

        tile_mesh = make_tile_mesh(cfg.tile_shard)
        log.info("tile-parallel passes: width sharded over %d devices "
                 "(exact path; view batching off)", cfg.tile_shard)
    batched = tile_mesh is None and (cfg.batch_problems == "on" or (
        cfg.batch_problems == "auto" and jax.local_device_count() > 1))
    if batched:
        from acmmp_spherical_tpu.parallel.mesh import make_view_mesh
        from acmmp_spherical_tpu.pipeline.batch_runner import run_pass_batched

        if mesh is None:
            mesh = make_view_mesh(devices=jax.local_devices())
        log.info("batched pass execution over %d local devices",
                 mesh.devices.size)

    max_k = compute_multiscale_settings(sp, problems, cfg)
    first = True
    scale = max_k
    skipped: list[tuple[str, int]] = []
    while scale >= 0:
        log.info("=== scale %d ===", scale)
        for p in problems:
            if p.num_downscale >= 0:
                p.cur_image_size = p.max_image_size // (2 ** p.num_downscale)
                p.num_downscale -= 1

        def _run_serial(idx, *, geom, prior, hier, multi, tag, pass_name):
            pid = problems[idx].ref_image_id
            # per-problem retry: outputs are idempotent (SURVEY.md 5.3), so a
            # transient failure costs at most one pass re-run; a second
            # failure skips the view, and the run reports it as failed
            for attempt in range(2):
                try:
                    with timings.scope(tag):
                        process_problem(
                            sp, problems, idx, cfg, geom=geom,
                            planar_prior=prior, hierarchy=hier,
                            multi_geometry=multi, tile_mesh=tile_mesh,
                        )
                    mark_pass_complete(sp, pass_name, pid)
                    return
                except Exception:
                    if attempt == 0:
                        log.exception("pass %s image=%08d failed; retrying",
                                      pass_name, pid)
                    else:
                        log.exception("pass %s image=%08d failed twice; "
                                      "skipping view", pass_name, pid)
                        skipped.append((pass_name, pid))

        def _run_all(*, geom, prior, hier, multi, tag):
            pass_name = f"{tag}_s{scale}"
            order = [
                i for i in range(proc, len(problems), n_proc)  # host shard
                if not (cfg.skip_if_complete and is_pass_complete(
                    sp, pass_name, problems[i].ref_image_id))
            ]
            if cfg.skip_if_complete:
                log.info("%s: %d of this host's problems to run",
                         pass_name, len(order))
            if not order:
                _barrier(pass_name)
                return
            if batched:
                with timings.scope(tag):
                    run_pass_batched(
                        sp, problems, order, cfg, geom=geom,
                        planar_prior=prior, hierarchy=hier,
                        multi_geometry=multi, mesh=mesh,
                    )
                for i in order:
                    mark_pass_complete(sp, pass_name,
                                       problems[i].ref_image_id)
                _barrier(pass_name)
                return
            for i in order:
                _run_serial(i, geom=geom, prior=prior, hier=hier, multi=multi,
                            tag=tag, pass_name=pass_name)
            _barrier(pass_name)

        if first:
            first = False
            _run_all(geom=False, prior=cfg.planar_prior, hier=False,
                     multi=False, tag="photometric")
        else:
            for p in problems[proc::n_proc]:
                with timings.scope("jbu"):
                    joint_bilateral_upsampling_pass(sp, p, p.cur_image_size)
            _barrier(f"jbu_s{scale}")
            _run_all(geom=False, prior=cfg.planar_prior, hier=True,
                     multi=False, tag="hierarchy")
        for gi in range(cfg.geom_iterations):
            _run_all(geom=True, prior=False, hier=False, multi=gi > 0,
                     tag=f"geom{gi}")
        scale -= 1

    n = 0
    if proc == 0:
        with timings.scope("fusion"):
            n = run_fusion(sp, problems, cfg, geom=True)
    _barrier("fusion")
    log.info("pipeline timings: %s", timings.summary())
    if skipped:
        log.error("%d pass(es) skipped after repeated failures: %s",
                  len(skipped), skipped)
    return PipelineResult(n_points=n, skipped=skipped, timings=timings)
