"""Command-line interface.

The reference exposes one positional-argument binary (``ACMMP dense_folder``,
reference main.cpp:392-399) plus the converter script.  Here both live under
one CLI:

.. code-block:: bash

    python -m acmmp_spherical_tpu reconstruct <dense_folder> [--no-prior]
        [--resume] [--seed N] [--max-src-views K] [--platform auto|cpu|gpu]
        [--fast-ncc auto|on|off]
    python -m acmmp_spherical_tpu convert --dense_folder D --save_folder S
        [--model_ext .txt|.bin] [--top_k 20] [--min_shared 10] [--theta0 1.0]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _set_platform(platform: str) -> None:
    """Pin the JAX backend ("auto": JAX's default) and set up the persistent
    compilation cache."""
    import jax

    from acmmp_spherical_tpu.utils.compile_cache import enable_compile_cache

    if platform != "auto":
        jax.config.update("jax_platforms", platform)
        # the setting is ignored once a backend is up: check what JAX uses
        found = jax.devices()[0].platform
        if found != platform:
            raise RuntimeError(f"--platform {platform}: JAX runs on {found!r}")
    enable_compile_cache()


def _reconstruct(args) -> int:
    _set_platform(args.platform)
    if args.distributed:
        # multi-host: every host runs the same command; problems are
        # round-robin assigned per host inside run_pipeline and exchanged
        # through the shared scene folder (the reference's own exchange
        # mechanism, ACMMP.cpp:653-678)
        import jax

        jax.distributed.initialize(
            coordinator_address=args.coordinator or None,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from acmmp_spherical_tpu.config import PipelineConfig
    from acmmp_spherical_tpu.pipeline.multiscale import run_pipeline

    cfg = PipelineConfig(
        planar_prior=not args.no_prior,
        seed=args.seed,
        skip_if_complete=args.resume,
        max_src_views=args.max_src_views,
        batch_problems=args.batch,
        size_bound=args.size_bound,
        tile_shard=args.tile_shard,
        fast_ncc=args.fast_ncc,
    )
    result = run_pipeline(args.dense_folder, cfg)
    if result.skipped:
        print(f"reconstruct: {len(result.skipped)} pass(es) skipped after "
              f"repeated failures: {result.skipped}", file=sys.stderr)
        return 1
    return 0 if result.n_points > 0 else 1


def _convert(args) -> int:
    _set_platform(args.platform)
    from acmmp_spherical_tpu.pipeline.convert import ConvertOptions, convert_colmap_scene

    opts = ConvertOptions(
        model_ext=args.model_ext,
        max_d=args.max_d,
        interval_scale=args.interval_scale,
        theta0=args.theta0,
        top_k=args.top_k,
        min_shared=args.min_shared,
    )
    convert_colmap_scene(args.dense_folder, args.save_folder, opts)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="acmmp_spherical_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("reconstruct", help="dense reconstruction of a scene folder")
    r.add_argument("dense_folder")
    r.add_argument("--no-prior", action="store_true",
                   help="disable the planar-prior second round")
    r.add_argument("--resume", action="store_true",
                   help="skip passes recorded complete in the manifest")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--max-src-views", type=int, default=20)
    r.add_argument("--batch", default="auto", choices=["auto", "on", "off"],
                   help="device-batched pass execution over the local devices"
                        " (auto: on when >1 device)")
    r.add_argument("--size-bound", type=int, default=1000,
                   help="pyramid coarsest-scale bound (reference main.cpp:38)")
    r.add_argument("--tile-shard", type=int, default=1,
                   help="intra-image tile parallelism: shard each depth map "
                        "along the image width over N local devices (GSPMD "
                        "halo exchange) for frames too large for one device; "
                        "forces the exact path and disables view batching")
    r.add_argument("--fast-ncc", default="auto", choices=["auto", "on", "off"],
                   help="per-pixel-tile Pallas cost kernel (auto: where its "
                        "Triton route compiles; off: the exact XLA path)")
    r.add_argument("--distributed", action="store_true",
                   help="initialise jax.distributed for multi-host runs; "
                        "each host runs this same command against the shared "
                        "scene folder")
    r.add_argument("--coordinator", default="",
                   help="coordinator address host:port (default: "
                        "auto-detect from the cluster environment)")
    r.add_argument("--num-processes", type=int, default=None)
    r.add_argument("--process-id", type=int, default=None)
    r.add_argument("--platform", default="auto",
                   choices=["auto", "cpu", "gpu"],
                   help="pin the jax backend (auto: the default platform)")
    r.set_defaults(fn=_reconstruct)

    c = sub.add_parser("convert", help="COLMAP sparse model -> scene folder")
    c.add_argument("--dense_folder", required=True)
    c.add_argument("--save_folder", required=True)
    c.add_argument("--model_ext", default=".txt", choices=[".txt", ".bin"])
    c.add_argument("--max_d", type=int, default=192)
    c.add_argument("--interval_scale", type=float, default=1.0)
    c.add_argument("--theta0", type=float, default=1.0)
    c.add_argument("--top_k", type=int, default=20)
    c.add_argument("--min_shared", type=int, default=10)
    c.add_argument("--platform", default="auto",
                   choices=["auto", "cpu", "gpu"])
    c.set_defaults(fn=_convert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
