"""Device-batched pass execution (pipeline/batch_runner) on the 8-device
virtual CPU mesh: the production pipeline dispatches problem chunks over the
view mesh (replacing the reference's serial loop, main.cpp:431-446) and must
produce depth maps of the same quality as the serial path."""

import dataclasses

import numpy as np
import pytest

from acmmp_spherical_tpu.config import PipelineConfig
from acmmp_spherical_tpu.core.camera import PINHOLE
from acmmp_spherical_tpu.io.dmb import read_depth_dmb
from acmmp_spherical_tpu.io.scene import ScenePaths
from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline
from acmmp_spherical_tpu.utils.metrics import depth_error_stats
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene, write_synthetic_scene_to_disk,
)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    scene = CubeRoom()
    W, H, n = 48, 36, 5
    cams = make_ring_of_cameras(n, model=PINHOLE, width=W, height=H, focal=42.0)
    images, depths, normals = render_scene(cams, scene, W, H)
    return cams, images, depths


def _write(tmp_path, scene_data, name):
    cams, images, _ = scene_data
    root = tmp_path / name / "dense"
    write_synthetic_scene_to_disk(root, cams, images)
    return root


def test_batched_pipeline_quality(scene, tmp_path, monkeypatch):
    """Batched execution (forced on) produces accurate per-view depths and
    writes every checkpoint artifact the serial path writes."""
    import jax

    assert jax.local_device_count() >= 2  # conftest provides 8 virtual devices
    cams, images, depths = scene
    root = _write(tmp_path, scene, "batched")
    cfg = dataclasses.replace(PipelineConfig(), batch_problems="on")

    # assert the batched path really ran and the serial path never did
    from acmmp_spherical_tpu.pipeline import batch_runner
    from acmmp_spherical_tpu.pipeline import multiscale as ms

    calls = []
    real = batch_runner.run_pass_batched
    monkeypatch.setattr(batch_runner, "run_pass_batched",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    monkeypatch.setattr(
        ms, "process_problem",
        lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("serial path must not run")))

    n_points = run_pipeline(root, cfg).n_points
    assert n_points > 500
    assert len(calls) == 3  # photometric + 2 geometric passes

    sp = ScenePaths(root)
    for i in range(len(cams)):
        d = read_depth_dmb(sp.depth_file(i, geom=True))
        stats = depth_error_stats(d, depths[i])
        assert stats["median_rel_err"] < 0.02, (i, stats)
        assert sp.normal_file(i).exists()
        assert sp.cost_file(i).exists()
        assert (sp.result_dir(i) / "triangulation.png").exists()


def test_batched_chunking_pads_trailing(scene, tmp_path):
    """5 problems over an 8-device mesh: one padded chunk; padded slots are
    not written and real slots all are."""
    from acmmp_spherical_tpu.parallel.mesh import make_view_mesh
    from acmmp_spherical_tpu.pipeline.batch_runner import _chunks

    cams, images, _ = scene
    root = _write(tmp_path, scene, "chunks")
    sp = ScenePaths(root)
    from acmmp_spherical_tpu.io.scene import read_pair_file
    from acmmp_spherical_tpu.pipeline.multiscale import compute_multiscale_settings

    problems = read_pair_file(sp.pair_file)
    cfg = PipelineConfig()
    compute_multiscale_settings(sp, problems, cfg)
    for p in problems:
        p.cur_image_size = p.max_image_size // (2 ** max(p.num_downscale, 0))
    mesh = make_view_mesh()
    chunks = list(_chunks(sp, problems, range(len(problems)), cfg, mesh,
                          geom=False, multi_geometry=False))
    assert sum(len(c.indices) for c in chunks) == len(problems)
    for c in chunks:
        assert len(c.lps) == mesh.devices.size  # padded to the mesh width
