"""Golden-file regression fixture (SURVEY test strategy / ROADMAP).

One seeded photometric pass on the analytic golden, summarised by regional
statistics and compared against a committed snapshot.  The quality gates
elsewhere bound *error*; this fixture detects unintended *behavioral* drift
(a change that moves estimates around while medians stay fine).  Statistics
(not raw dmb bytes) make the fixture robust to benign jaxlib changes; the
tolerance is far tighter than any quality gate.

The snapshot was taken on the CPU with the exact XLA cost path.  The same
snapshot gates both cost paths (``cost_kernel``): here the Pallas kernel in
the interpreter, and on the GPU (``chip_smoke.py``) the exact path and the
compiled kernel.

Regenerate deliberately after an intended algorithm change:
    python tests/test_regression_fixture.py --regen
"""

import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp

import pytest

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_pass_stats.json"


def _run_golden_pass(cost_kernel: str = "xla"):
    import dataclasses

    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core.camera import PINHOLE, stack_cameras
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    W, H, n = 96, 64, 4
    cams = make_ring_of_cameras(n, model=PINHOLE, width=W, height=H,
                                focal=80.0)
    images, depths, _ = render_scene(cams, CubeRoom(), W, H)
    images = jnp.asarray(images)
    dr = jnp.asarray(np.asarray(cams[0].depth_range), jnp.float32)
    inputs = PatchMatchInputs(
        ref_image=images[0], src_images=images[1:], ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]), src_valid=jnp.ones(n - 1, bool),
        depth_range=dr,
    )
    params = dataclasses.replace(PatchMatchParams(), cost_kernel=cost_kernel)
    d, nrm, cost, _ = run_patchmatch(inputs, params, jax.random.key(2333))
    return np.asarray(d), np.asarray(nrm), np.asarray(cost)


def _stats(d, nrm, cost):
    out = {}
    H, W = d.shape
    for qi, sl in enumerate([np.s_[: H // 2, : W // 2],
                             np.s_[: H // 2, W // 2:],
                             np.s_[H // 2:, : W // 2],
                             np.s_[H // 2:, W // 2:]]):
        out[f"depth_mean_q{qi}"] = float(np.mean(d[sl]))
        out[f"depth_median_q{qi}"] = float(np.median(d[sl]))
        out[f"cost_mean_q{qi}"] = float(np.mean(cost[sl]))
    out["normal_mean_abs"] = float(np.mean(np.abs(nrm)))
    out["depth_p10"] = float(np.percentile(d, 10))
    out["depth_p90"] = float(np.percentile(d, 90))
    return out


def check_against_fixture(stats: dict, ref: dict, *, rtol: float = 2e-3,
                          atol: float = 2e-3):
    for k, v in ref.items():
        assert abs(stats[k] - v) <= max(atol, rtol * abs(v)), (
            k, stats[k], v,
            "intended change? regenerate: python "
            "tests/test_regression_fixture.py --regen")


@pytest.mark.parametrize("cost_kernel", ["xla", "interpret"])
def test_golden_pass_regression(cost_kernel):
    stats = _stats(*_run_golden_pass(cost_kernel))
    check_against_fixture(stats, json.loads(FIXTURE.read_text()))


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        import os

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        jax.config.update("jax_platforms", "cpu")
        FIXTURE.parent.mkdir(parents=True, exist_ok=True)
        FIXTURE.write_text(json.dumps(_stats(*_run_golden_pass()), indent=1))
        print(f"wrote {FIXTURE}")
