"""Configs 2 and 4 (BASELINE.json): multi-scale pyramid with hierarchy+JBU
seeding, and the spherical camera model end-to-end."""

import dataclasses

import numpy as np
import pytest

from acmmp_spherical_tpu.config import PipelineConfig
from acmmp_spherical_tpu.core.camera import PINHOLE, SPHERE
from acmmp_spherical_tpu.io import read_ply
from acmmp_spherical_tpu.io.dmb import read_depth_dmb
from acmmp_spherical_tpu.io.scene import ScenePaths
from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline
from acmmp_spherical_tpu.utils.metrics import cube_surface_distance, depth_error_stats
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene, write_synthetic_scene_to_disk,
)


@pytest.mark.slow
def test_multiscale_pyramid_pipeline(tmp_path):
    """96px images with size_bound=48 -> 2 pyramid scales: exercises the
    coarse photometric pass, inter-scale JBU, hierarchy-seeded fine pass and
    geometric refinement at both scales."""
    scene = CubeRoom()
    W, H, n = 96, 72, 5
    cams = make_ring_of_cameras(n, model=PINHOLE, width=W, height=H, focal=80.0)
    images, depths, _ = render_scene(cams, scene, W, H)
    root = tmp_path / "dense"
    write_synthetic_scene_to_disk(root, cams, images)

    cfg = dataclasses.replace(PipelineConfig(), size_bound=48)
    n_points = run_pipeline(root, cfg).n_points

    sp = ScenePaths(root)
    d0 = read_depth_dmb(sp.depth_file(0, geom=True))
    assert d0.shape == (H, W)  # final scale is full resolution
    stats = depth_error_stats(d0, depths[0])
    assert stats["median_rel_err"] < 0.02, stats
    assert n_points > 4000, n_points
    pts, _, _ = read_ply(sp.ply_file())
    dist = cube_surface_distance(pts, scene.half)
    assert np.mean(dist < 0.08) > 0.9


import pytest


@pytest.mark.slow
def test_sphere_pipeline_e2e(tmp_path):
    """Spherical end-to-end: equirectangular views to fused cloud, exercising
    longitude wrap in sampling, propagation and the angular bilateral metric."""
    scene = CubeRoom()
    W, H, n = 128, 64, 4
    cams = make_ring_of_cameras(n, model=SPHERE, width=W, height=H)
    images, depths, _ = render_scene(cams, scene, W, H)
    root = tmp_path / "dense"
    write_synthetic_scene_to_disk(root, cams, images)

    n_points = run_pipeline(root, PipelineConfig()).n_points

    sp = ScenePaths(root)
    d0 = read_depth_dmb(sp.depth_file(0, geom=True))
    rel = np.abs(d0 - depths[0]) / depths[0]
    # big equirect pixels (~3 deg) at this test size: accept coarse agreement
    assert np.median(rel) < 0.08, np.median(rel)
    assert n_points > 1500, n_points
    pts, _, _ = read_ply(sp.ply_file())
    dist = cube_surface_distance(pts, scene.half)
    assert np.mean(dist < 0.2) > 0.7, np.mean(dist < 0.2)
