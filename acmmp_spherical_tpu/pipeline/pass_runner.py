"""Per-image pass runner: the host orchestration of one PatchMatch pass.

Equivalent of the reference's ``ProcessProblem`` (main.cpp:73-210) +
``ACMMP::InuputInitialization`` / ``CudaSpaceInitialization``
(ACMMP.cpp:567-845): load and rescale the view cluster, move it to the device,
run the (optionally seeded) PatchMatch pass, run the planar-prior second round
when requested, and persist depth/normal/cost as ``.dmb``.

Views are padded to a common stack shape and to a fixed source count so every
problem at a given scale compiles to the same XLA program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.config import PipelineConfig, PatchMatchParams
from acmmp_spherical_tpu.core.camera import Camera, scale_camera, stack_cameras
from acmmp_spherical_tpu.io import dmb
from acmmp_spherical_tpu.io.image import resize_bilinear, write_png
from acmmp_spherical_tpu.io.scene import (
    Problem, ScenePaths, load_image_gray, read_camera_file,
)
from acmmp_spherical_tpu.ops.jbu import joint_bilateral_upsample
from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_tpu.pipeline.prior import build_planar_prior, draw_triangulation
from acmmp_spherical_tpu.utils.log import get_logger

log = get_logger(__name__)


def _load_view(sp: ScenePaths, image_id: int, max_size: int):
    """Load + downscale one view (reference ACMMP.cpp:576-643)."""
    img = load_image_gray(sp.image_file(image_id))
    cam = read_camera_file(sp.camera_file(image_id))
    h, w = img.shape
    cam = scale_camera(cam, 1.0, 1.0, w, h)
    if w > max_size or h > max_size:
        factor = min(max_size / w, max_size / h)
        nw, nh = round(w * factor), round(h * factor)
        img = resize_bilinear(img, nh, nw)
        cam = scale_camera(cam, nw / w, nh / h, nw, nh)
    return img.astype(np.float32), cam


def resolve_cost_kernel(fast_ncc: str) -> str:
    """PipelineConfig.fast_ncc -> PatchMatchParams.cost_kernel.

    "auto" takes the Pallas kernel where its Triton route compiles and the
    exact XLA path elsewhere (never the interpreter); "on" raises where the
    kernel cannot compile."""
    from acmmp_spherical_tpu.ops.pallas import ncc_tile

    if fast_ncc == "off":
        return "xla"
    if fast_ncc not in ("auto", "on"):
        raise ValueError(f"fast_ncc must be auto|on|off, got {fast_ncc!r}")
    if ncc_tile.available():
        return "pallas"
    if fast_ncc == "on":
        raise RuntimeError(
            "fast_ncc='on' but the Pallas-Triton cost kernel does not compile "
            f"on the {jax.default_backend()!r} backend")
    return "xla"


def _pad_stack(arrays: Sequence[np.ndarray], shape=None) -> np.ndarray:
    """Zero-pad 2D arrays to a common (Hp, Wp) and stack."""
    if shape is None:
        hp = max(a.shape[0] for a in arrays)
        wp = max(a.shape[1] for a in arrays)
    else:
        hp, wp = shape
    out = np.zeros((len(arrays), hp, wp), np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0], : a.shape[1]] = a
    return out


@dataclasses.dataclass
class LoadedProblem:
    inputs: PatchMatchInputs
    ref_image_np: np.ndarray
    ref_cam: Camera
    height: int
    width: int


def load_problem(
    sp: ScenePaths,
    problems: Sequence[Problem],
    idx: int,
    cfg: PipelineConfig,
    *,
    geom: bool = False,
    multi_geometry: bool = False,
) -> tuple[LoadedProblem, PatchMatchParams]:
    """Build device inputs for one problem (InuputInitialization analog)."""
    problem = problems[idx]
    by_id = {p.ref_image_id: p for p in problems}

    ref_img, ref_cam = _load_view(sp, problem.ref_image_id, problem.cur_image_size)
    src_imgs, src_cams = [], []
    for sid in problem.src_image_ids[: cfg.max_src_views]:
        cur = by_id[sid].cur_image_size if sid in by_id else problem.cur_image_size
        im, cm = _load_view(sp, sid, cur)
        src_imgs.append(im)
        src_cams.append(cm)

    n_src = len(src_imgs)
    # pad to the scene-wide source count (rounded up for shape stability), not
    # the global cap: padded views are masked but still *computed*, so over-
    # padding multiplies the NCC work
    scene_max = max((min(len(p.src_image_ids), cfg.max_src_views)
                     for p in problems), default=1)
    n_pad = max(1, -(-scene_max // 2) * 2)
    src_valid = np.zeros(n_pad, bool)
    src_valid[:n_src] = True
    while len(src_imgs) < n_pad:
        src_imgs.append(np.zeros((1, 1), np.float32))
        src_cams.append(src_cams[0] if n_src else ref_cam)

    dmin, dmax = np.asarray(ref_cam.depth_range)
    # the working range travels as a traced input (inputs.depth_range), NOT as
    # static params: a static range would recompile every image
    depth_range = jnp.asarray(
        [cfg.depth_min_scale * dmin, cfg.depth_max_scale * dmax], jnp.float32
    )
    params = dataclasses.replace(cfg.patchmatch,
                                 cost_kernel=resolve_cost_kernel(cfg.fast_ncc))
    if geom:
        params = params.with_geom()

    src_depths = None
    if geom:
        # load the previous pass's depth maps of every source view
        # (ACMMP.cpp:653-678); suffix chosen by multi_geometry
        deps = []
        for i, sid in enumerate(problem.src_image_ids[: cfg.max_src_views]):
            path = sp.depth_file(sid, geom=multi_geometry)
            deps.append(dmb.read_depth_dmb(path) if path.exists()
                        else np.zeros((1, 1), np.float32))
        while len(deps) < n_pad:
            deps.append(np.zeros((1, 1), np.float32))
        src_depths = jnp.asarray(_pad_stack(deps))

    inputs = PatchMatchInputs(
        ref_image=jnp.asarray(ref_img),
        src_images=jnp.asarray(_pad_stack(src_imgs)),
        ref_cam=ref_cam,
        src_cams=stack_cameras(src_cams),
        src_valid=jnp.asarray(src_valid),
        src_depths=src_depths,
        depth_range=depth_range,
    )
    lp = LoadedProblem(
        inputs=inputs, ref_image_np=ref_img, ref_cam=ref_cam,
        height=ref_img.shape[0], width=ref_img.shape[1],
    )
    return lp, params


def _load_seed(sp: ScenePaths, image_id: int, *, multi_geometry: bool):
    """Previous-pass seed fields for geom passes (CudaSpaceInitialization,
    ACMMP.cpp:753-785)."""
    depth = dmb.read_depth_dmb(sp.depth_file(image_id, geom=multi_geometry))
    normal = dmb.read_normal_dmb(sp.normal_file(image_id))
    return jnp.asarray(normal), jnp.asarray(depth)


def _load_hierarchy_seed(sp: ScenePaths, lp: LoadedProblem, image_id: int):
    """Coarse-scale seed for hierarchy passes (ACMMP.cpp:788-844).

    The inter-scale JBU pass has already written a full-resolution depths.dmb
    seed; normals/costs are still at the coarse resolution and are upsampled
    here with the same guided filter the reference applies in-kernel
    (ACMMP.cu:713-779).
    """
    depth = dmb.read_depth_dmb(sp.depth_file(image_id, geom=False))
    normal = dmb.read_normal_dmb(sp.normal_file(image_id))
    H, W = lp.height, lp.width
    if depth.shape != (H, W):
        # JBU was skipped (scale ratio 1); fall back to the freshest depth
        gpath = sp.depth_file(image_id, geom=True)
        if gpath.exists():
            d2 = dmb.read_depth_dmb(gpath)
            if d2.shape == (H, W):
                depth = d2
    if normal.shape[:2] != (H, W):
        normal = np.asarray(
            joint_bilateral_upsample(jnp.asarray(normal), jnp.asarray(lp.ref_image_np))
        )
        norms = np.linalg.norm(normal, axis=-1, keepdims=True)
        normal = normal / np.maximum(norms, 1e-12)
    if depth.shape != (H, W):
        # final fallback: plain guided upsample of whatever depth we have
        depth = np.asarray(
            joint_bilateral_upsample(jnp.asarray(depth), jnp.asarray(lp.ref_image_np))
        )
    return jnp.asarray(normal), jnp.asarray(depth)


def process_problem(
    sp: ScenePaths,
    problems: Sequence[Problem],
    idx: int,
    cfg: PipelineConfig,
    *,
    geom: bool = False,
    planar_prior: bool = False,
    hierarchy: bool = False,
    multi_geometry: bool = False,
    seed: Optional[int] = None,
    tile_mesh=None,
) -> None:
    """Run one pass for one problem and persist the results
    (ProcessProblem analog, main.cpp:73-210).

    ``tile_mesh``: intra-image tile parallelism (parallel/tile.py) -- the
    plane state is sharded along the image width over the mesh's ``tile``
    axis (GSPMD halo exchange; SURVEY.md 5.8 #4).  For frames whose working
    set exceeds one device; runs the exact array-program path (the Pallas
    cost kernel does not partition)."""
    problem = problems[idx]
    image_id = problem.ref_image_id
    sp.result_dir(image_id).mkdir(parents=True, exist_ok=True)

    lp, params = load_problem(
        sp, problems, idx, cfg, geom=geom, multi_geometry=multi_geometry
    )
    if hierarchy:
        params = params.with_hierarchy()
    shard_state = None
    if tile_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from acmmp_spherical_tpu.parallel.tile import make_state_sharder

        params = dataclasses.replace(params, cost_kernel="xla")
        shard_state = make_state_sharder(tile_mesh)
        lp.inputs = jax.device_put(lp.inputs, NamedSharding(tile_mesh, P()))

    key = jax.random.fold_in(
        jax.random.key(cfg.seed if seed is None else seed), image_id
    )
    seed_normal = seed_depth = None
    if geom:
        seed_normal, seed_depth = _load_seed(sp, image_id, multi_geometry=multi_geometry)
    elif hierarchy:
        seed_normal, seed_depth = _load_hierarchy_seed(sp, lp, image_id)

    log.info("pass image=%08d size=%dx%d geom=%s prior=%s hier=%s multi=%s",
             image_id, lp.width, lp.height, geom, planar_prior, hierarchy,
             multi_geometry)
    depth, normal_world, cost, state = run_patchmatch(
        lp.inputs, params, key, seed_normal_world=seed_normal,
        seed_depth=seed_depth, shard_state=shard_state,
    )

    if planar_prior:
        # second round with the Delaunay planar prior (main.cpp:113-197)
        dmin, dmax = np.asarray(lp.ref_cam.depth_range)
        prior_normal, prior_w, mask, tris = build_planar_prior(
            lp.ref_cam, np.asarray(depth), np.asarray(cost),
            cfg.depth_min_scale * dmin, cfg.depth_max_scale * dmax, cfg.prior,
        )
        write_png(sp.result_dir(image_id) / "triangulation.png",
                  draw_triangulation(lp.ref_image_np, tris))
        if mask.any():
            prior_inputs = lp.inputs._replace(
                prior_normal=jnp.asarray(prior_normal),
                prior_w=jnp.asarray(prior_w),
                prior_mask=jnp.asarray(mask),
            )
            if tile_mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                prior_inputs = jax.device_put(
                    prior_inputs, NamedSharding(tile_mesh, P()))
            pparams = params.with_planar_prior()
            key2 = jax.random.fold_in(key, 1)
            depth, normal_world, cost, state = run_patchmatch(
                prior_inputs, pparams, key2, prev_state=state,
                shard_state=shard_state,
            )

    dmb.write_dmb(sp.depth_file(image_id, geom=geom), np.asarray(depth))
    dmb.write_dmb(sp.normal_file(image_id), np.asarray(normal_world))
    dmb.write_dmb(sp.cost_file(image_id), np.asarray(cost))
