"""ACMMP-Spherical in JAX: a multi-view stereo engine for NVIDIA GPUs.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the
contineu-ai/ACMMP-Spherical reference (multi-scale geometric-consistency guided,
planar-prior assisted PatchMatch MVS with pinhole + equirectangular spherical
cameras):

* every CUDA kernel of the reference is a pure array program (vectorised over
  all pixels); the multi-view cost evaluation also has a per-pixel-tile Pallas
  kernel compiled through Triton,
* the red-black checkerboard PatchMatch is a functional half-lattice update,
* multi-device scaling shards view clusters ("Problems") over a
  ``jax.sharding.Mesh`` and exchanges depth rasters with XLA collectives,
* all randomness is counter-based (``jax.random``) and fully deterministic.

Package layout:

* :mod:`acmmp_spherical_tpu.core`     cameras, projective geometry, plane state
* :mod:`acmmp_spherical_tpu.io`       .dmb / .ply codecs, scene layout, COLMAP readers
* :mod:`acmmp_spherical_tpu.ops`      the compute kernels (NCC, propagation, fusion, ...)
* :mod:`acmmp_spherical_tpu.pipeline` per-pass runner and coarse-to-fine driver
* :mod:`acmmp_spherical_tpu.parallel` mesh sharding / multi-host orchestration
* :mod:`acmmp_spherical_tpu.utils`    synthetic scenes, logging, profiling
"""

__version__ = "0.1.0"

from acmmp_spherical_tpu.config import (  # noqa: F401
    PatchMatchParams,
    FusionParams,
    PipelineConfig,
)
