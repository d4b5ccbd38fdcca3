"""End-to-end pipeline test (BASELINE.json config 1: a small pinhole scene run
from the on-disk layout through photometric + planar-prior + geometric passes
to a fused point cloud)."""

import numpy as np
import pytest

from acmmp_spherical_tpu.config import PipelineConfig
from acmmp_spherical_tpu.core.camera import PINHOLE
from acmmp_spherical_tpu.io import read_ply
from acmmp_spherical_tpu.io.dmb import read_depth_dmb
from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline
from acmmp_spherical_tpu.utils.metrics import (
    cube_surface_distance, depth_error_stats,
)
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene, write_synthetic_scene_to_disk,
)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene") / "dense"
    scene = CubeRoom()
    W, H, n = 64, 48, 5
    cams = make_ring_of_cameras(n, model=PINHOLE, width=W, height=H, focal=56.0)
    images, depths, normals = render_scene(cams, scene, W, H)
    sp = write_synthetic_scene_to_disk(root, cams, images)
    return root, scene, depths


@pytest.mark.slow
def test_full_pipeline_small_pinhole(scene_dir):
    root, scene, gt_depths = scene_dir
    result = run_pipeline(root, PipelineConfig())
    assert result.skipped == []
    n_points = result.n_points

    # per-view geometric depth maps exist and are accurate
    from acmmp_spherical_tpu.io.scene import ScenePaths

    sp = ScenePaths(root)
    d0 = read_depth_dmb(sp.depth_file(0, geom=True))
    stats = depth_error_stats(d0, gt_depths[0])
    assert stats["median_rel_err"] < 0.02, stats

    # fused cloud: enough points, on the cube surface
    assert n_points > 2000, n_points
    pts, nrm, col = read_ply(sp.ply_file())
    dist = cube_surface_distance(pts, scene.half)
    acc = np.mean(dist < 0.08)  # 1% of the 8-unit room
    assert acc > 0.9, f"only {acc:.2%} of fused points within tau"

    # costs/normals written for every view
    for i in range(5):
        assert sp.normal_file(i).exists()
        assert sp.cost_file(i).exists()
        assert (sp.result_dir(i) / "triangulation.png").exists()


@pytest.mark.slow
def test_pipeline_resume_skips(scene_dir):
    root, *_ = scene_dir
    import dataclasses

    cfg = dataclasses.replace(PipelineConfig(), skip_if_complete=True)
    # second run with resume: all passes skip, fusion still runs
    import time

    t0 = time.time()
    n_points = run_pipeline(root, cfg).n_points
    assert n_points > 2000
    assert time.time() - t0 < 60.0  # no recompute of the patchmatch passes


@pytest.mark.slow
def test_convert_then_reconstruct_e2e(tmp_path):
    """The reference user flow end-to-end (README.md:24-31): a COLMAP sparse
    model through the converter CLI, then reconstruction, then a fused cloud
    checked against the analytic surface.  Exercises the converter's depth
    ranges / pair selection feeding real passes, not just file parity."""
    from tests.test_convert import _write_synthetic_colmap
    from acmmp_spherical_tpu.pipeline.cli import main

    colmap = tmp_path / "colmap"
    colmap.mkdir()
    _write_synthetic_colmap(colmap, n_views=5)
    scene = tmp_path / "scene"
    rc = main(["convert", "--dense_folder", str(colmap),
               "--save_folder", str(scene), "--top_k", "4",
               "--min_shared", "5", "--theta0", "0.05"])
    assert rc == 0
    rc = main(["reconstruct", str(scene), "--batch", "off"])
    assert rc == 0
    pts, _, _ = read_ply(scene / "ACMMP" / "ACMMP_model.ply")
    assert len(pts) > 1000
    m = np.abs(np.asarray(pts)).max(axis=1)
    on_surface = np.abs(m - 4.0) < 0.08
    assert on_surface.mean() > 0.97, on_surface.mean()
