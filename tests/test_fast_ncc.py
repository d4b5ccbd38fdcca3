"""Per-pixel-tile cost kernel (ops/pallas/ncc_tile.py) in the Pallas
interpreter against the plain XLA reference (ops/ncc.multiview_ncc and
ops/geom.geom_consistency_cost), and the switch that picks it.

Tolerance: 1e-3 absolute on at least 99% of the (candidate, view, pixel)
costs.  The kernel evaluates the same formulas in the same tap order, but its
projections are written out as scalar products instead of ``einsum``, so
results differ in the last bits; a sample that lands exactly on an image
border or a patch at the variance threshold can then flip between valid and
invalid, which moves that one cost by up to ``cost_max``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core import geometry as G
from acmmp_spherical_tpu.core.camera import PINHOLE, SPHERE, stack_cameras
from acmmp_spherical_tpu.ops.geom import geom_consistency_cost
from acmmp_spherical_tpu.ops.ncc import multiview_ncc, ref_tap_context
from acmmp_spherical_tpu.ops.pallas import ncc_tile
from acmmp_spherical_tpu.ops.sampling import grid_coords
from acmmp_spherical_tpu.pipeline.pass_runner import resolve_cost_kernel
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene,
)

TOL = 1e-3
AGREE = 0.99


def _fields(model, n_src, W, H):
    """Rendered views plus three candidate plane fields: ground truth and two
    perturbations of its depth (the second one far off).  The cameras are
    tilted slightly, so no view maps a row exactly onto another's border."""
    kw = {} if model == SPHERE else {"focal": 0.8 * W}
    cams = make_ring_of_cameras(n_src + 1, model=model, width=W, height=H,
                                look_jitter=0.03, **kw)
    images, depths, normals = render_scene(cams, CubeRoom(), W, H)
    ref = cams[0]
    xs, ys = grid_coords(H, W)
    n_cam = G.normal_world_to_cam(ref, jnp.asarray(normals[0]))
    d0 = jnp.asarray(depths[0])
    rng = np.random.default_rng(n_src)
    ws = [G.dist_to_origin(ref, xs, ys, d0 * s, n_cam)
          for s in (1.0, 1.0 + 0.03 * rng.standard_normal((H, W)), 1.5)]
    normals_c = jnp.broadcast_to(n_cam, (3,) + n_cam.shape)
    return (jnp.asarray(images), jnp.asarray(depths), cams, normals_c,
            jnp.stack(ws).astype(jnp.float32), xs, ys)


@pytest.mark.parametrize("model", [PINHOLE, SPHERE])
@pytest.mark.parametrize("geom", [False, True])
@pytest.mark.parametrize("n_src", [1, 3, 8])
@pytest.mark.parametrize("shape", [(40, 24), (37, 21)], ids=["even", "odd"])
def test_kernel_matches_reference(model, geom, n_src, shape):
    W, H = shape
    images, depths, cams, normals, ws, xs, ys = _fields(model, n_src, W, H)
    ref, src = cams[0], stack_cameras(cams[1:])
    params = PatchMatchParams()
    ctx = ref_tap_context(images[0], ref, params)
    src_depths = depths[1:] if geom else None

    out = ncc_tile.tile_cost_vectors(images[1:], src, ref, normals, ws, ctx,
                                     params, src_depths, interpret=True)
    cv, gv = out if geom else (out, None)
    assert cv.shape == (3, n_src, H, W)
    cv = np.asarray(cv)
    assert cv.min() >= 0.0 and cv.max() <= params.cost_max
    for c in range(3):
        exact = np.asarray(multiview_ncc(images[1:], src, ref, normals[c],
                                         ws[c], ctx, params))
        agree = np.mean(np.abs(cv[c] - exact) <= TOL)
        assert agree >= AGREE, (c, agree)
        if geom:
            eg = np.asarray(geom_consistency_cost(
                depths[1:], src, ref, normals[c], ws[c], xs, ys, params))
            gagree = np.mean(np.abs(np.asarray(gv[c]) - eg) <= TOL)
            assert gagree >= AGREE, (c, gagree)


@pytest.mark.parametrize("n_views,expect", [
    (1, (1, 16, 32)), (3, (4, 16, 32)), (6, (8, 8, 32)), (8, (8, 8, 32)),
    (20, (32, 2, 32)),
])
def test_tile_shape_keeps_block_size(n_views, expect):
    s_pad, bh, bw = ncc_tile.tile_shape(n_views)
    assert (s_pad, bh, bw) == expect
    assert s_pad >= n_views and s_pad & (s_pad - 1) == 0


def test_auto_picks_exact_path_on_cpu():
    # no GPU here: "auto" takes the XLA path outright, never the interpreter
    assert not ncc_tile.available()
    assert resolve_cost_kernel("auto") == "xla"


def test_on_raises_where_kernel_cannot_compile():
    with pytest.raises(RuntimeError, match="does not compile"):
        resolve_cost_kernel("on")


def test_off_picks_exact_path():
    assert resolve_cost_kernel("off") == "xla"
    with pytest.raises(ValueError):
        resolve_cost_kernel("fast")


def test_compiled_kernel_refused_on_cpu():
    """Without ``interpret=True`` the kernel is never interpreted: on the CPU
    the Triton lowering refuses it."""
    images, depths, cams, normals, ws, *_ = _fields(PINHOLE, 1, 16, 8)
    params = PatchMatchParams()
    ctx = ref_tap_context(images[0], cams[0], params)
    with pytest.raises(Exception, match="interpret"):
        ncc_tile.tile_cost_vectors(images[1:], stack_cameras(cams[1:]),
                                   cams[0], normals, ws, ctx, params)


def test_kernel_pass_recovers_depth_interpret():
    """A full pass with every cost evaluation on the kernel (interpreter),
    random-depth candidates included."""
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch

    W, H, n = 64, 32, 4
    cams = make_ring_of_cameras(n, model=PINHOLE, width=W, height=H, focal=56.0)
    images, depths, _ = render_scene(cams, CubeRoom(), W, H)
    dmin, dmax = np.asarray(cams[0].depth_range)
    params = dataclasses.replace(
        PatchMatchParams(max_iterations=2).with_depth_range(dmin, dmax),
        cost_kernel="interpret",
    )
    inputs = PatchMatchInputs(
        ref_image=jnp.asarray(images[0]),
        src_images=jnp.asarray(images[1:]),
        ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]),
        src_valid=jnp.ones(n - 1, bool),
    )
    depth, *_ = run_patchmatch(inputs, params, jax.random.key(0))
    gt = depths[0]
    rel = np.abs(np.asarray(depth)[4:-4, 4:-4] - gt[4:-4, 4:-4]) / gt[4:-4, 4:-4]
    assert np.median(rel) < 0.05, np.median(rel)


@pytest.mark.gpu
@pytest.mark.parametrize("model", [PINHOLE, SPHERE])
def test_compiled_kernel_matches_reference_on_gpu(gpu, model):
    """The kernel as Triton compiles it for the card, against the reference
    under "highest" matmul precision."""
    images, depths, cams, normals, ws, xs, ys = _fields(model, 6, 96, 48)
    ref, src = cams[0], stack_cameras(cams[1:])
    params = PatchMatchParams()
    ctx = ref_tap_context(images[0], ref, params)
    cv, gv = ncc_tile.tile_cost_vectors(images[1:], src, ref, normals, ws, ctx,
                                        params, depths[1:])
    with jax.default_matmul_precision("highest"):
        for c in range(3):
            exact = multiview_ncc(images[1:], src, ref, normals[c], ws[c], ctx,
                                  params)
            eg = geom_consistency_cost(depths[1:], src, ref, normals[c], ws[c],
                                       xs, ys, params)
            assert np.mean(np.abs(np.asarray(cv[c] - exact)) <= TOL) >= AGREE
            assert np.mean(np.abs(np.asarray(gv[c] - eg)) <= TOL) >= AGREE
