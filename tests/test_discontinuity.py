"""Adversarial depth-discontinuity golden (VERDICT round 1, item 5).

The CubeRoom goldens have no internal occlusions.  This golden renders an
interior occluding box (true fore/background steps) and gates both cost
paths -- the exact XLA path and the per-pixel-tile kernel (in the Pallas
interpreter here) -- on it: overall accuracy AND accuracy inside the band
around the silhouette edges.

Mirrors the reference's implicit contract: ComputeBilateralNCC's bilateral
weights (ACMMP.cu:438-466) exist precisely to keep depth edges sharp.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core.camera import PINHOLE, stack_cameras
from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, OccludedRoom, make_ring_of_cameras, render_scene,
)

W, H, N = 96, 64, 4


@pytest.fixture(scope="module")
def box_scene():
    scene = OccludedRoom()
    cams = make_ring_of_cameras(N, model=PINHOLE, width=W, height=H,
                                focal=80.0)
    images, depths, normals = render_scene(cams, scene, W, H)
    gt = depths[0]
    # edge band: pixels within 3 px of a GT depth step > 5% of depth
    step = np.maximum(
        np.abs(np.diff(gt, axis=0, prepend=gt[:1])),
        np.abs(np.diff(gt, axis=1, prepend=gt[:, :1])),
    ) > 0.05 * gt
    band = step.copy()
    for _ in range(3):
        band[1:] |= band[:-1]
        band[:-1] |= band[1:]
        band[:, 1:] |= band[:, :-1]
        band[:, :-1] |= band[:, 1:]
    return cams, images, gt, band


def test_box_scene_has_occlusions(box_scene):
    cams, images, gt, band = box_scene
    # the box must actually occlude: a real step and a non-trivial band
    assert band.mean() > 0.03, band.mean()
    assert gt.max() / gt.min() > 1.5


def _run(cams, images, *, cost_kernel):
    images = jnp.asarray(images)
    ref_cam = cams[0]
    src_cams = stack_cameras(cams[1:])
    dr = jnp.asarray(np.asarray(ref_cam.depth_range), jnp.float32)
    params = dataclasses.replace(PatchMatchParams(), cost_kernel=cost_kernel)
    inputs = PatchMatchInputs(
        ref_image=images[0], src_images=images[1:], ref_cam=ref_cam,
        src_cams=src_cams, src_valid=jnp.ones(N - 1, bool), depth_range=dr,
    )
    d, _, _, _ = run_patchmatch(inputs, params, jax.random.key(3))
    return np.asarray(d)


@pytest.mark.parametrize("cost_kernel", ["xla", "interpret"])
@pytest.mark.slow
def test_discontinuity_quality(box_scene, cost_kernel):
    cams, images, gt, band = box_scene
    d = _run(cams, images, cost_kernel=cost_kernel)
    rel = np.abs(d - gt) / gt
    interior = np.s_[6:-6, 6:-6]
    med = np.median(rel[interior])
    med_band = np.median(rel[interior][band[interior]])
    # overall accuracy unaffected by the occluder
    assert med < 0.02, (cost_kernel, med)
    # the edge band is harder, but must not smear the silhouette: half the
    # band pixels land within 6% of the true (fg or bg) depth
    assert med_band < 0.06, (cost_kernel, med_band)
