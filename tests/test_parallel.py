"""Multi-device view-parallel tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from acmmp_spherical_tpu.parallel import (
    make_view_mesh, shard_batch_over_views, multichip_train_step,
)
from acmmp_spherical_tpu.parallel.synthetic_batch import make_synthetic_batch


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_view_parallel_step_8_devices():
    mesh = make_view_mesh(8)
    batch, params, gt = make_synthetic_batch(8, width=32, height=24, n_src=3)
    batch = shard_batch_over_views(mesh, batch)

    step = multichip_train_step(mesh, params, n_iterations=1)
    depth, normal, cost = step(batch, jax.random.key(0))
    depth = np.asarray(jax.device_get(depth))
    assert depth.shape == (8, 24, 32)
    assert np.isfinite(depth).all()
    # the sharded step should actually produce usable depth: at this tiny
    # resolution just require gross agreement for a majority of pixels
    rel = np.abs(depth - gt) / gt
    assert np.median(rel) < 0.2, np.median(rel)

    # outputs keep the view sharding across all 8 devices
    d2, _, _ = step(batch, jax.random.key(0))
    assert len(d2.sharding.device_set) == 8


def test_view_parallel_deterministic():
    mesh = make_view_mesh(4)
    batch, params, _ = make_synthetic_batch(4, width=32, height=24, n_src=2)
    batch = shard_batch_over_views(mesh, batch)
    step = multichip_train_step(mesh, params, n_iterations=1)
    d1, *_ = step(batch, jax.random.key(3))
    d2, *_ = step(batch, jax.random.key(3))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_tile_parallel_matches_single_device():
    """Width-sharded pass must produce exactly the same result as unsharded
    (GSPMD halo exchange is semantics-preserving)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from acmmp_spherical_tpu.parallel.tile import tile_parallel_pass
    from acmmp_spherical_tpu.parallel.synthetic_batch import make_synthetic_batch
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs

    batch, params, gt = make_synthetic_batch(4, width=64, height=32, n_src=3)
    inputs = PatchMatchInputs(
        ref_image=batch.images[0, 0],
        src_images=batch.images[0, 1:],
        ref_cam=jax.tree.map(lambda a: a[0, 0], batch.cams),
        src_cams=jax.tree.map(lambda a: a[0, 1:], batch.cams),
        src_valid=batch.src_valid[0],
    )
    mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("tile",))
    run4 = tile_parallel_pass(mesh4, params, n_iterations=1)
    d4, n4, c4 = run4(inputs, jax.random.key(0))
    assert len(d4.sharding.device_set) == 4

    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tile",))
    run1 = tile_parallel_pass(mesh1, params, n_iterations=1)
    d1, n1, c1 = run1(inputs, jax.random.key(0))

    np.testing.assert_allclose(np.asarray(d4), np.asarray(d1), rtol=1e-5,
                               atol=1e-4)
    rel = np.abs(np.asarray(d4) - gt[0]) / gt[0]
    assert np.median(rel) < 0.25


def test_sharded_fusion_matches_single_device():
    from acmmp_spherical_tpu.config import FusionParams
    from acmmp_spherical_tpu.core.camera import PINHOLE, stack_cameras
    from acmmp_spherical_tpu.ops.fusion import fuse_all_views
    from acmmp_spherical_tpu.parallel.fusion import fuse_all_views_sharded
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )
    from jax.sharding import Mesh
    import jax.numpy as jnp

    scene = CubeRoom()
    W, H, n = 48, 36, 5
    cams = make_ring_of_cameras(n, model=PINHOLE, width=W, height=H, focal=44.0)
    images, depths, normals = render_scene(cams, scene, W, H)
    colors = np.repeat(images[..., None], 3, axis=-1)
    src_idx = np.array([[j for j in range(n) if j != i] for i in range(n)],
                       np.int32)

    p1, n1, c1 = fuse_all_views(
        jnp.asarray(depths), jnp.asarray(normals), jnp.asarray(colors),
        stack_cameras(cams), src_idx, FusionParams(),
    )
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("view",))
    p2, n2, c2 = fuse_all_views_sharded(
        mesh, jnp.asarray(depths), jnp.asarray(normals), jnp.asarray(colors),
        stack_cameras(cams), src_idx, FusionParams(),
    )
    assert len(p1) == len(p2)
    np.testing.assert_allclose(np.sort(p1, axis=0), np.sort(p2, axis=0),
                               atol=1e-4)


@pytest.mark.slow
def test_tile_shard_pipeline_matches_serial(tmp_path):
    """The product --tile-shard path (config.tile_shard): the full pipeline
    with every depth map width-sharded over 4 virtual devices produces the
    same results as the unsharded run (with_sharding_constraint only moves
    data; semantics are identical up to f32 reduction order)."""
    import dataclasses

    from acmmp_spherical_tpu.config import PipelineConfig
    from acmmp_spherical_tpu.io.dmb import read_depth_dmb
    from acmmp_spherical_tpu.io.scene import ScenePaths
    from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
        write_synthetic_scene_to_disk,
    )

    scene = CubeRoom()
    W, H, n = 64, 48, 4
    cams = make_ring_of_cameras(n, width=W, height=H, focal=56.0)
    images, depths, _ = render_scene(cams, scene, W, H)

    results = {}
    for shard in (1, 4):
        root = tmp_path / f"dense_{shard}"
        write_synthetic_scene_to_disk(root, cams, images)
        cfg = PipelineConfig(tile_shard=shard, batch_problems="off")
        n_pts = run_pipeline(root, cfg).n_points
        assert n_pts > 500, (shard, n_pts)
        results[shard] = read_depth_dmb(
            ScenePaths(root).depth_file(0, geom=True))

    rel = np.abs(results[4] - results[1]) / np.maximum(results[1], 1e-6)
    # identical seeds + value-preserving sharding: near-exact agreement
    assert np.median(rel) < 1e-5, np.median(rel)
    assert np.mean(rel < 1e-3) > 0.99, np.mean(rel < 1e-3)
    gt_rel = np.abs(results[4] - depths[0]) / depths[0]
    assert np.median(gt_rel[4:-4, 4:-4]) < 0.02
