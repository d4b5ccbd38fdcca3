#!/usr/bin/env python
"""Benchmark: depth-maps per second on one GPU.

Measures the steady-state throughput of the densest unit of work in the
pipeline -- one full photometric PatchMatch pass (random init + 3 iterations of
black/red checkerboard propagation with joint view selection and refinement +
depth extraction + median filter) -- at the reference's coarsest-scale
operating point (~1000 px images, SURVEY.md section 6) with 8 source views,
plus the geometric pass and both passes for an equirectangular ring at
1024x512 with 6 sources.  The cost evaluation is the one the pipeline picks
(``PipelineConfig.fast_ncc="auto"``).

Prints exactly one JSON line:
    {"metric": "depth_maps_per_s_per_chip", "value": ..., "unit": "1024x768x8src photometric passes/s", "vs_baseline": ..., "device": {...}, ...}

vs_baseline: the reference repo publishes no numbers (BASELINE.md).  The
anchor is an *analytic* GTX 1080 Ti estimate derived in BASELINE.md ("Analytic
1080 Ti anchor"): ~1.07 TFLOP per 1024x768x8src photometric pass through the
reference kernels (ACMMP.cu:938-1349 op counts) at a 10-25% - of - peak
efficiency band for this divergent, gather-heavy workload on an 11.3 TFLOP/s
part -> 1.0-2.6 passes/s, central estimate 1.6.

Fails (exit 2) when JAX finds no GPU.  ``ACMMP_BENCH_SMALL=1`` shrinks every
section for a quick check of the script itself.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_PASSES_PER_S = 1.6  # analytic GTX 1080 Ti anchor (BASELINE.md)


def _power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _timed_passes(run, reps):
    """(first-call seconds, steady-state seconds of each repetition, output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(run(0))
    first = time.perf_counter() - t0
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(r + 1))
        times.append(time.perf_counter() - t0)
    return first, times, out


def main() -> None:
    small = os.environ.get("ACMMP_BENCH_SMALL") == "1"
    if small:
        shapes = {"pinhole": (96, 72, 3), "sphere": (128, 64, 3)}
        reps = 2
    else:
        shapes = {"pinhole": (1024, 768, 8), "sphere": (1024, 512, 6)}
        reps = 3

    import jax
    import jax.numpy as jnp

    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs
    from acmmp_spherical_tpu.pipeline.pass_runner import resolve_cost_kernel
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_tpu.utils.compile_cache import enable_compile_cache
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        sys.exit(2)
    enable_compile_cache()
    cost_kernel = resolve_cost_kernel("auto")
    print(f"[bench] device: {dev.device_kind}; cost path {cost_kernel}",
          file=sys.stderr)

    results = {}
    compile_s = {}
    for model, (W, H, n_src) in shapes.items():
        kw = {"focal": 0.9 * W, "radius": 0.25} if model == "pinhole" else {}
        cams = make_ring_of_cameras(1 + n_src, model=model, width=W, height=H,
                                    **kw)
        images, gt_depth, _ = render_scene(cams, CubeRoom(), W, H)
        images_d = jnp.asarray(images)

        def inputs_for(i, src_depths=None):
            others = [j for j in range(1 + n_src) if j != i]
            dmin, dmax = np.asarray(cams[i].depth_range)
            return PatchMatchInputs(
                ref_image=images_d[i],
                src_images=images_d[jnp.asarray(others)],
                ref_cam=cams[i],
                src_cams=stack_cameras([cams[j] for j in others]),
                src_valid=jnp.ones(n_src, bool),
                src_depths=src_depths,
                # traced working range, like the production pipeline (so the
                # per-view seed passes reuse one compiled program)
                depth_range=jnp.asarray([dmin, dmax], jnp.float32),
            )

        dmin, dmax = np.asarray(cams[0].depth_range)
        params = dataclasses.replace(
            PatchMatchParams().with_depth_range(dmin, dmax),
            cost_kernel=cost_kernel)
        inputs = inputs_for(0)
        first, times, out = _timed_passes(
            lambda r: run_patchmatch(inputs, params, jax.random.key(r)), reps)
        compile_s[model] = round(first, 1)
        results[model] = min(times)
        c = np.s_[8:-8, 8:-8]
        rel = np.abs(np.asarray(out[0])[c] - gt_depth[0][c]) / gt_depth[0][c]
        print(f"[bench] {model} pass times {['%.4f' % t for t in times]}; "
              f"median rel depth err {np.median(rel):.5f}", file=sys.stderr)

        # geometric-consistency pass (2 iterations, seeded from the
        # photometric result; reference main.cpp:436-446).  Source depths
        # come from each view's OWN photometric pass, as the pipeline
        # exchanges previous-pass outputs (ACMMP.cpp:653-678).
        src_depths = jnp.stack([
            run_patchmatch(inputs_for(i), params, jax.random.key(1000 + i))[0]
            for i in range(1, 1 + n_src)])
        geom_inputs = inputs._replace(src_depths=src_depths)
        first, times, gout = _timed_passes(
            lambda r: run_patchmatch(geom_inputs, params.with_geom(),
                                     jax.random.key(100 + r),
                                     seed_normal_world=out[1],
                                     seed_depth=out[0]), reps)
        compile_s[f"{model}_geom"] = round(first, 1)
        results[f"{model}_geom"] = min(times)
        grel = (np.abs(np.asarray(gout[0])[c] - gt_depth[0][c])
                / gt_depth[0][c])
        print(f"[bench] {model} geom pass times "
              f"{['%.4f' % t for t in times]}; median rel depth err "
              f"{np.median(grel):.5f}", file=sys.stderr)

    unit = lambda m: "{}x{}x{}src".format(*shapes[m])
    value = 1.0 / results["pinhole"]
    print(json.dumps({
        "metric": "depth_maps_per_s_per_chip",
        "value": value,
        "unit": f"{unit('pinhole')} photometric passes/s",
        "vs_baseline": value / BASELINE_PASSES_PER_S,
        "geom_value": 1.0 / results["pinhole_geom"],
        "geom_unit": f"{unit('pinhole')} geometric passes/s",
        "sphere_value": 1.0 / results["sphere"],
        "sphere_unit": f"{unit('sphere')} spherical photometric passes/s",
        "sphere_geom_value": 1.0 / results["sphere_geom"],
        "sphere_geom_unit": f"{unit('sphere')} spherical geometric passes/s",
        # first call of each section: compilation plus one pass
        "compile_s": compile_s,
        "cost_kernel": cost_kernel,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "name_power_limit": _power_limit()},
    }))


if __name__ == "__main__":
    main()
