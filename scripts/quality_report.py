#!/usr/bin/env python
"""Quality report: reconstruct a synthetic golden scene and print ETH3D-style
accuracy/completeness + depth-error statistics as JSON.

Usage: python scripts/quality_report.py [--model pinhole|sphere] [--size W H]
       [--views N] [--fast on|off|auto]

The golden is the analytic cube room (utils/synthetic.py): ground truth is
exact, so the numbers measure the engine, not the fixture.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="pinhole", choices=["pinhole", "sphere"])
    ap.add_argument("--size", type=int, nargs=2, default=[128, 96])
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--fast", default="auto", choices=["on", "off", "auto"])
    ap.add_argument("--scene", default="cube", choices=["cube", "occluded"])
    ap.add_argument("--hostile", action="store_true",
                    help="per-view gain/bias + specular lobe + sensor noise "
                         "+ JPEG round-trip (render_scene_hostile)")
    ap.add_argument("--tau", type=float, default=0.08,
                    help="accuracy threshold (scene units; room is 8 units)")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()

    from acmmp_spherical_tpu.config import PipelineConfig
    from acmmp_spherical_tpu.io import read_ply
    from acmmp_spherical_tpu.io.dmb import read_depth_dmb
    from acmmp_spherical_tpu.io.scene import ScenePaths
    from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline
    from acmmp_spherical_tpu.utils.metrics import (
        cloud_accuracy_completeness, cube_surface_distance, depth_error_stats,
    )
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, OccludedRoom, make_ring_of_cameras, render_scene,
        render_scene_hostile, write_synthetic_scene_to_disk,
    )
    from acmmp_spherical_tpu.core import geometry as G

    W, H = args.size
    scene = OccludedRoom() if args.scene == "occluded" else CubeRoom()
    cams = make_ring_of_cameras(args.views, model=args.model, width=W, height=H,
                                focal=0.9 * W)
    if args.hostile:
        images, gt_depths, _ = render_scene_hostile(cams, scene, W, H)
    else:
        images, gt_depths, _ = render_scene(cams, scene, W, H)
    root = tempfile.mkdtemp() + "/dense"
    write_synthetic_scene_to_disk(root, cams, images)

    import jax

    from acmmp_spherical_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = dataclasses.replace(PipelineConfig(), fast_ncc=args.fast)
    t0 = time.time()
    result = run_pipeline(root, cfg)
    wall = time.time() - t0
    if result.skipped:
        raise RuntimeError(f"passes skipped: {result.skipped}")
    n_points = result.n_points

    sp = ScenePaths(root)
    depth_stats = depth_error_stats(read_depth_dmb(sp.depth_file(0, geom=True)),
                                    gt_depths[0])

    pts, _, _ = read_ply(sp.ply_file())
    # GT cloud: unproject every view's GT depth
    gt_pts = []
    for v, cam in enumerate(cams):
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        gt_pts.append(np.asarray(
            G.unproject_world(cam, xs, ys, gt_depths[v])).reshape(-1, 3))
    gt_pts = np.concatenate(gt_pts)[::7]  # subsample for the KD-tree
    cloud = cloud_accuracy_completeness(pts, gt_pts, args.tau)
    cloud["frac_on_surface"] = float(
        np.mean(cube_surface_distance(pts, scene.half) < args.tau))

    report = {
        "scene": f"{args.scene}_room_{args.model}_{W}x{H}x{args.views}v"
                 + ("_hostile" if args.hostile else ""),
        "fast_ncc": args.fast,
        "device": jax.devices()[0].device_kind,
        "wall_s": round(wall, 1),
        "n_points": int(n_points),
        **{k: round(v, 4) for k, v in depth_stats.items()},
        **{k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in cloud.items()},
    }
    print(json.dumps(report))
    if args.out:
        import pathlib

        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
