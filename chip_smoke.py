#!/usr/bin/env python
"""Smoke run of the MVS pipeline on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py              # one GPU: phases 1-4
    python chip_smoke.py --cards 4    # four GPUs: phase 1 and phase 5 only

Everything runs in this one process, so each card is opened once.  Any
failed phase raises, and the script then exits non-zero without its result
line.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Phases
  1. Device: the card's name and power limit (nvidia-smi, from a child that
     never imports JAX); JAX must report platform "gpu".
  2. Cost kernel: the Pallas-Triton kernel (ops/pallas/ncc_tile.py) is
     compiled at 1024x768 with 8 sources (pinhole) and 1024x512 with 6
     (sphere), for 9 candidate fields with the geometric term, and compared
     with ops.ncc.multiview_ncc / ops.geom.geom_consistency_cost under
     "highest" matmul precision: at least 99% of the costs within 1e-3
     (tests/test_fast_ncc.py gives the reason for that tolerance).
  3. Golden fixture: tests/test_regression_fixture.py's seeded pass on the
     card, with the exact path and with the kernel, against the committed
     snapshot.
  4. Main path: ``python -m acmmp_spherical_tpu reconstruct`` (cli.main) on
     a synthetic pinhole scene, 1600x1200 frames, 7 views of 6 sources
     (size_bound 1000), and on an equirectangular scene, 2048x1024, 5 views
     of 4 sources (size_bound 1024).  Both give two pyramid scales:
     photometric pass with planar prior, JBU, hierarchy pass with prior, 2
     geometric passes per scale, fusion.
     Checked: every view's .dmb files and the .ply exist; no pass was retried
     or skipped; median relative depth error against the analytic truth
     below 1% (pinhole) and 2% (sphere); at least 90% (pinhole) and 80%
     (sphere) of the fused points within 0.08 (1% of the room) of the cube
     surface.
  5. (--cards 4) Multi-device: a pinhole scene at 640x480 (one scale) with 8
     views of 7 sources, ``reconstruct --no-prior`` batched over a 4-card
     view mesh against the serial run on card 0, and ``--tile-shard 4``
     against the single-card run on the same (exact) cost path.  Each pair must agree
     per view: median relative depth difference below 1e-3 and at least 95%
     of the pixels within 1%.  The batched run must put a problem on every
     card.

Cut from a full-size run: views (7 and 5 instead of the tens a capture
holds), so that phases 1-4 finish within 20 minutes with a cold compile
cache; in phase 5 also the frame size and the prior pass, which only
multiply the programs to compile.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

KERNEL_TOL, KERNEL_AGREE = 1e-3, 0.99
PAIR_MEDIAN, PAIR_FRAC = 1e-3, 0.95


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_info() -> str:
    """nvidia-smi's name and power limit, from a child without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check_device():
    """The JAX devices, which must be GPUs; exits with code 2 otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    return devices


class Recorder(logging.Handler):
    """Keeps the pipeline's error records and timing lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.errors: list[str] = []
        self.timings: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        if record.levelno >= logging.ERROR:
            self.errors.append(msg)
        elif msg.startswith("pipeline timings:"):
            self.timings.append(msg)


class CompileClock:
    """Sums XLA backend compile time (JAX's own monitoring events)."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration
            self.count += 1


def peak_bytes(device) -> int:
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", 0))


def _scene(model, width, height, n_views):
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    kw = {"focal": 0.9 * width, "radius": 0.25} if model == "pinhole" else {}
    cams = make_ring_of_cameras(n_views, model=model, width=width,
                                height=height, **kw)
    images, depths, normals = render_scene(cams, CubeRoom(), width, height)
    return cams, images, depths, normals


def phase_kernel():
    import jax
    import jax.numpy as jnp

    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core import geometry as G
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops.geom import geom_consistency_cost
    from acmmp_spherical_tpu.ops.ncc import multiview_ncc, ref_tap_context
    from acmmp_spherical_tpu.ops.pallas import ncc_tile
    from acmmp_spherical_tpu.ops.sampling import grid_coords

    if not ncc_tile.available():
        raise RuntimeError("the Pallas-Triton cost kernel does not compile")
    params = PatchMatchParams()
    for model, W, H, S in [("pinhole", 1024, 768, 8), ("sphere", 1024, 512, 6)]:
        cams, images, depths, normals_w = _scene(model, W, H, S + 1)
        images = jnp.asarray(images)
        src_depths = jnp.asarray(depths[1:])
        ref, src = cams[0], stack_cameras(cams[1:])
        xs, ys = grid_coords(H, W)
        n_cam = G.normal_world_to_cam(ref, jnp.asarray(normals_w[0]))
        d0 = jnp.asarray(depths[0])
        rng = np.random.default_rng(0)
        ws = jnp.stack([G.dist_to_origin(
            ref, xs, ys, d0 * (1.0 + 0.01 * i * rng.standard_normal((H, W))),
            n_cam) for i in range(9)]).astype(jnp.float32)
        normals = jnp.broadcast_to(n_cam, (9,) + n_cam.shape)
        ctx = ref_tap_context(images[0], ref, params)

        kernel = jax.jit(lambda img, dep, n, w, c: ncc_tile.tile_cost_vectors(
            img, src, ref, n, w, c, params, dep))
        t0 = time.perf_counter()
        compiled = kernel.lower(images[1:], src_depths, normals, ws, ctx).compile()
        log(f"kernel {model} {W}x{H}x{S}src C=9: compiled in "
            f"{time.perf_counter() - t0:.1f}s; {compiled.memory_analysis()}")
        cv, gv = compiled(images[1:], src_depths, normals, ws, ctx)

        def exact(img, dep, n, w, c):
            one = lambda nw: (
                multiview_ncc(img, src, ref, nw[0], nw[1], c, params),
                geom_consistency_cost(dep, src, ref, nw[0], nw[1], xs, ys,
                                      params))
            return jax.lax.map(one, (n, w))

        with jax.default_matmul_precision("highest"):
            ecv, egv = jax.jit(exact)(images[1:], src_depths, normals, ws, ctx)
        for name, a, b in [("ncc", cv, ecv), ("geom", gv, egv)]:
            d = np.abs(np.asarray(a) - np.asarray(b))
            agree = float(np.mean(d <= KERNEL_TOL))
            log(f"kernel {model} {name}: {agree:.6f} of costs within "
                f"{KERNEL_TOL} of the reference (mean |d| {d.mean():.3g})")
            if agree < KERNEL_AGREE:
                raise AssertionError(f"kernel {model} {name} agreement {agree}")


def phase_golden():
    # loaded by path: an installed package may also be called "tests"
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "test_regression_fixture.py"
    spec = importlib.util.spec_from_file_location("golden_fixture", path)
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)

    ref = json.loads(fixture.FIXTURE.read_text())
    for cost_kernel in ("xla", "pallas"):
        stats = fixture._stats(*fixture._run_golden_pass(cost_kernel))
        fixture.check_against_fixture(stats, ref)
        log(f"golden fixture ({cost_kernel}): within tolerance of "
            f"{fixture.FIXTURE.name}")


def _reconstruct(root, *extra):
    from acmmp_spherical_tpu.pipeline.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(["reconstruct", str(root), "--platform", "gpu", *extra])
    if rc != 0:
        raise RuntimeError(f"reconstruct {root} {extra} exited {rc}")
    return time.perf_counter() - t0


def phase_main_path(workdir, recorder, clock, device):
    from acmmp_spherical_tpu.io import read_ply
    from acmmp_spherical_tpu.io.dmb import read_depth_dmb
    from acmmp_spherical_tpu.io.scene import ScenePaths
    from acmmp_spherical_tpu.utils.metrics import (
        cube_surface_distance, depth_error_stats,
    )
    from acmmp_spherical_tpu.utils.synthetic import write_synthetic_scene_to_disk

    cases = [("pinhole", 1600, 1200, 7, 0.01, 0.90, ()),
             ("sphere", 2048, 1024, 5, 0.02, 0.80, ("--size-bound", "1024"))]
    for model, W, H, n, max_err, min_on_surface, extra in cases:
        cams, images, depths, _ = _scene(model, W, H, n)
        root = Path(workdir) / model
        write_synthetic_scene_to_disk(root, cams, images)
        n_err = len(recorder.errors)
        c0, k0 = clock.seconds, clock.count
        wall = _reconstruct(root, *extra)
        if len(recorder.errors) > n_err:
            raise AssertionError(f"{model}: passes failed or were retried: "
                                 f"{recorder.errors[n_err:]}")
        sp = ScenePaths(root)
        for i in range(n):
            for path in (sp.depth_file(i, geom=False), sp.depth_file(i, geom=True),
                         sp.normal_file(i), sp.cost_file(i)):
                if not path.exists():
                    raise AssertionError(f"{model}: missing {path}")
        errs = [depth_error_stats(read_depth_dmb(sp.depth_file(i, geom=True)),
                                  depths[i], border=16)["median_rel_err"]
                for i in range(n)]
        pts, _, _ = read_ply(sp.ply_file())
        on_surface = float(np.mean(cube_surface_distance(pts, 4.0) < 0.08))
        log(f"reconstruct {model} {W}x{H} x{n} views: {wall:.1f}s wall, "
            f"{clock.seconds - c0:.1f}s compiling ({clock.count - k0} "
            f"programs), peak_bytes_in_use {peak_bytes(device)}")
        log(f"reconstruct {model} {recorder.timings[-1]}")
        log(f"reconstruct {model}: median rel depth error per view "
            f"{[round(e, 5) for e in errs]}; {len(pts)} fused points, "
            f"{on_surface:.4f} within 0.08 of the surface")
        if max(errs) >= max_err:
            raise AssertionError(f"{model}: depth error {max(errs)} >= {max_err}")
        if on_surface < min_on_surface:
            raise AssertionError(f"{model}: surface share {on_surface}")


def _pair_check(name, root_a, root_b, n):
    from acmmp_spherical_tpu.io.dmb import read_depth_dmb
    from acmmp_spherical_tpu.io.scene import ScenePaths

    for i in range(n):
        a = read_depth_dmb(ScenePaths(root_a).depth_file(i, geom=True))
        b = read_depth_dmb(ScenePaths(root_b).depth_file(i, geom=True))
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
        med, frac = float(np.median(rel)), float(np.mean(rel < 1e-2))
        log(f"{name} view {i}: median rel diff {med:.3g}, "
            f"{frac:.4f} of pixels within 1%")
        if med >= PAIR_MEDIAN or frac < PAIR_FRAC:
            raise AssertionError(f"{name} view {i}: {med}, {frac}")


def phase_multi_device(workdir, devices):
    from acmmp_spherical_tpu.pipeline import batch_runner
    from acmmp_spherical_tpu.utils.synthetic import write_synthetic_scene_to_disk

    n = 8
    cams, images, _, _ = _scene("pinhole", 640, 480, n)
    roots = {k: Path(workdir) / k
             for k in ("batched", "serial", "tile4", "serial_exact")}
    for root in roots.values():
        write_synthetic_scene_to_disk(root, cams, images)

    seen = set()
    real = batch_runner._run_on_devices

    def recording(*a, **k):
        out = real(*a, **k)
        seen.update(s.device for s in out[0].addressable_shards)
        return out

    batch_runner._run_on_devices = recording
    try:
        log(f"batched over {len(devices)} cards: "
            f"{_reconstruct(roots['batched'], '--no-prior', '--batch', 'on'):.1f}s")
    finally:
        batch_runner._run_on_devices = real
    if seen != set(devices):
        raise AssertionError(f"batched problems ran on {seen}, not {devices}")
    log(f"serial on card 0: "
        f"{_reconstruct(roots['serial'], '--no-prior', '--batch', 'off'):.1f}s")
    _pair_check("batched vs serial", roots["batched"], roots["serial"], n)

    log(f"tile-shard 4: "
        f"{_reconstruct(roots['tile4'], '--no-prior', '--tile-shard', '4'):.1f}s")
    log(f"single card, exact path: "
        f"{_reconstruct(roots['serial_exact'], '--no-prior', '--batch', 'off', '--fast-ncc', 'off'):.1f}s")
    _pair_check("tile-shard 4 vs single card", roots["tile4"],
                roots["serial_exact"], n)
    for d in devices:
        log(f"{d}: peak_bytes_in_use {peak_bytes(d)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the multi-device phase on four cards")
    args = ap.parse_args(argv)

    log(f"card: {card_info()}")
    devices = check_device()
    import jax

    from acmmp_spherical_tpu.utils.compile_cache import enable_compile_cache

    if len(devices) < args.cards:
        raise RuntimeError(f"--cards {args.cards} but JAX sees {len(devices)}")
    log(f"devices: {devices}; compile cache {enable_compile_cache()}")
    recorder = Recorder()
    logging.getLogger("acmmp_spherical_tpu").addHandler(recorder)
    clock = CompileClock()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.cards == 4:
            phase_multi_device(workdir, devices[:4])
        else:
            for name, fn in [("kernel", phase_kernel), ("golden", phase_golden),
                             ("main path", lambda: phase_main_path(
                                 workdir, recorder, clock, devices[0]))]:
                t0 = time.perf_counter()
                fn()
                log(f"phase {name} done in {time.perf_counter() - t0:.1f}s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": args.cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
