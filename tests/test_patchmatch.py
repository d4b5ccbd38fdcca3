"""End-to-end PatchMatch tests on synthetic scenes (SURVEY.md section 4:
propagation on a scene with analytic ground truth)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core import geometry as G
from acmmp_spherical_tpu.core.camera import PINHOLE, SPHERE, stack_cameras
from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene,
)


def make_inputs(model, n_views=4, W=64, H=48):
    scene = CubeRoom()
    cams = make_ring_of_cameras(n_views, model=model, width=W, height=H,
                                focal=56.0)
    images, depths, normals = render_scene(cams, scene, W, H)
    images = jnp.asarray(images)
    dmin, dmax = np.asarray(cams[0].depth_range)
    params = PatchMatchParams().with_depth_range(dmin, dmax)
    inputs = PatchMatchInputs(
        ref_image=images[0],
        src_images=images[1:],
        ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]),
        src_valid=jnp.ones(n_views - 1, bool),
    )
    return inputs, params, depths, normals, cams


@pytest.mark.parametrize("model", [PINHOLE, SPHERE])
def test_photometric_pass_recovers_depth(model):
    # sphere needs more resolution: equirect pixels at 96px span ~4 degrees
    W, H, n = (64, 48, 4) if model == PINHOLE else (160, 80, 5)
    inputs, params, depths, normals, cams = make_inputs(model, n_views=n, W=W, H=H)
    key = jax.random.key(0)
    depth, normal_world, cost, state = run_patchmatch(inputs, params, key)
    depth = np.asarray(depth)

    gt = depths[0]
    interior = np.s_[6:-6, 6:-6]
    rel = np.abs(depth[interior] - gt[interior]) / gt[interior]
    med = np.median(rel)
    frac_good = np.mean(rel < 0.02)
    assert med < 0.02, f"median rel depth error {med}"
    assert frac_good > 0.6, f"only {frac_good:.2%} pixels within 2%"

    # normals should roughly agree with GT on good pixels
    nw = np.asarray(normal_world)[interior]
    ng = normals[0][interior]
    cosang = np.clip(np.sum(nw * ng, -1), -1, 1)
    good = rel < 0.02
    assert np.median(np.degrees(np.arccos(cosang[good]))) < 30.0


def test_determinism():
    inputs, params, *_ = make_inputs(PINHOLE, W=48, H=32)
    d1, n1, c1, _ = run_patchmatch(inputs, params, jax.random.key(7))
    d2, n2, c2, _ = run_patchmatch(inputs, params, jax.random.key(7))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    d3, *_ = run_patchmatch(inputs, params, jax.random.key(8))
    assert not np.array_equal(np.asarray(d1), np.asarray(d3))


def test_median_filter_removes_spikes():
    from acmmp_spherical_tpu.ops.filter import checkerboard_median_filter

    depth = jnp.ones((20, 24))
    depth = depth.at[10, 12].set(50.0)  # spike
    cost = jnp.full((20, 24), 0.5)
    out = np.asarray(checkerboard_median_filter(depth, cost))
    assert out[10, 12] == 1.0
    # low-cost pixels keep their depth
    depth2 = jnp.ones((20, 24)).at[5, 5].set(50.0)
    cost2 = jnp.zeros((20, 24))
    out2 = np.asarray(checkerboard_median_filter(depth2, cost2))
    assert out2[5, 5] == 50.0


def test_odd_size_fallback_path():
    """Odd image sizes take the dense parity-masked path; results stay sane."""
    from acmmp_spherical_tpu.utils.synthetic import CubeRoom, make_ring_of_cameras, render_scene
    from acmmp_spherical_tpu.core.camera import stack_cameras
    import jax

    scene = CubeRoom()
    W, H = 63, 47  # odd
    cams = make_ring_of_cameras(4, width=W, height=H, focal=56.0)
    images, depths, _ = render_scene(cams, scene, W, H)
    dmin, dmax = np.asarray(cams[0].depth_range)
    params = PatchMatchParams(max_iterations=2).with_depth_range(dmin, dmax)
    inputs = PatchMatchInputs(
        ref_image=jnp.asarray(images[0]),
        src_images=jnp.asarray(images[1:]),
        ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]),
        src_valid=jnp.ones(3, bool),
    )
    depth, *_ = run_patchmatch(inputs, params, jax.random.key(0))
    rel = np.abs(np.asarray(depth)[6:-6, 6:-6] - depths[0][6:-6, 6:-6]) / depths[0][6:-6, 6:-6]
    assert np.median(rel) < 0.05

