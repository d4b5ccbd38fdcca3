#!/usr/bin/env python
"""Exact XLA cost path against the Pallas cost kernel, per pass, on one GPU.

For each camera model at its bench width (pinhole 1024x768 with 8 sources,
sphere 1024x512 with 6) this times, in one process and after warm-up:

  * one batched cost evaluation of 9 candidate fields (the propagation
    batch) and of 5 (the refinement batch), on the checkerboard half-grid;
  * one full photometric pass (random init + 3 iterations + filter);
  * one full geometric pass (2 seeded iterations with the geom term).

Each measurement runs in turns -- exact, kernel, kernel, exact -- and ends in
``block_until_ready``.  Output: one JSON line per (model, measurement) with
every repetition, then the card's name and power limit.

    python scripts/profile_pass.py [--models pinhole sphere] [--reps 3]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

SHAPES = {"pinhole": (1024, 768, 8), "sphere": (1024, 512, 6)}


def timed(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["pinhole", "sphere"],
                    choices=sorted(SHAPES))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context
    from acmmp_spherical_tpu.ops.propagate import (
        PatchMatchInputs, _batched_cost_vectors, prepare_inputs,
    )
    from acmmp_spherical_tpu.ops.sampling import checkerboard_pack
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_tpu.utils.compile_cache import enable_compile_cache
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"profile_pass: needs a GPU, found {dev.platform}")

    for model in args.models:
        W, H, n_src = SHAPES[model]
        kw = {"focal": 0.9 * W, "radius": 0.25} if model == "pinhole" else {}
        cams = make_ring_of_cameras(1 + n_src, model=model, width=W, height=H,
                                    **kw)
        images, depths, _ = render_scene(cams, CubeRoom(), W, H)
        images = jnp.asarray(images)
        dmin, dmax = np.asarray(cams[0].depth_range)
        inputs = prepare_inputs(PatchMatchInputs(
            ref_image=images[0], src_images=images[1:], ref_cam=cams[0],
            src_cams=stack_cameras(cams[1:]), src_valid=jnp.ones(n_src, bool),
            depth_range=jnp.asarray([dmin, dmax], jnp.float32)))
        base = PatchMatchParams().with_depth_range(dmin, dmax)
        variants = {k: dataclasses.replace(base, cost_kernel=k)
                    for k in ("xla", "pallas")}

        # a converged field to seed the geometric pass and the cost batches
        depth, normal_w, _, state = run_patchmatch(
            inputs, variants["xla"], jax.random.key(0))
        ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, base)
        ctx_p = ctx._replace(
            ref_taps=checkerboard_pack(ctx.ref_taps, 0),
            weights=checkerboard_pack(ctx.weights, 0),
            center=checkerboard_pack(ctx.center, 0),
            xs=checkerboard_pack(ctx.xs, 0), ys=checkerboard_pack(ctx.ys, 0))
        n_p = jnp.moveaxis(checkerboard_pack(jnp.moveaxis(state.normal, -1, 0),
                                             0), 0, -1)
        w_p = checkerboard_pack(state.w, 0)
        geom_inputs = inputs._replace(src_depths=jnp.asarray(depths[1:]))

        cost_fn = jax.jit(
            lambda inp, c, n, w, p: _batched_cost_vectors(inp, c, p, n, w),
            static_argnums=4)
        n9, w9 = jnp.stack([n_p] * 9), jnp.stack([w_p] * 9)
        runs = {
            "cost_C9": lambda p: cost_fn(geom_inputs, ctx_p, n9, w9,
                                         p.with_geom()),
            "cost_C5": lambda p: cost_fn(inputs, ctx_p, n9[:5], w9[:5], p),
            "photometric_pass": lambda p: run_patchmatch(
                inputs, p, jax.random.key(1)),
            "geometric_pass": lambda p: run_patchmatch(
                geom_inputs, p.with_geom(), jax.random.key(2),
                seed_normal_world=normal_w, seed_depth=depth),
        }
        for name, run in runs.items():
            compile_s = {}
            for k, p in variants.items():
                t0 = time.perf_counter()
                jax.block_until_ready(run(p))
                compile_s[k] = time.perf_counter() - t0
            order = ["xla", "pallas", "pallas", "xla"]
            times = {"xla": [], "pallas": []}
            for k in order:
                times[k] += timed(lambda: run(variants[k]), args.reps)
            print(json.dumps({
                "model": model, "shape": f"{W}x{H}x{n_src}src",
                "measure": name, "seconds_exact": times["xla"],
                "seconds_kernel": times["pallas"],
                "first_call_s": compile_s,
                "median_ratio_exact_over_kernel":
                    float(np.median(times["xla"]) / np.median(times["pallas"])),
            }), flush=True)
    stats = dev.memory_stats() or {}
    print(json.dumps({"device": dev.device_kind,
                      "peak_bytes_in_use": stats.get("peak_bytes_in_use")}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
