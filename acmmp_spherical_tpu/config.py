"""Configuration dataclasses.

The reference scatters its hyper-parameters over compile-time defaults
(reference ACMMP.h:32-55), magic constants at use sites (see SURVEY.md section 5.6)
and converter argparse flags (colmap2mvsnet_acm.py:411-430).  Here every knob
lives in one frozen dataclass, with the reference values as defaults, so a run
is fully described by its config + seed.

All classes are plain (hashable, static) Python dataclasses: they are closed
over by jit-compiled functions, so changing a value triggers a recompile, which
is the intended semantics for algorithm hyper-parameters.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PatchMatchParams:
    """Per-pass PatchMatch hyper-parameters.

    Defaults mirror reference ACMMP.h:32-55 plus the magic constants inlined in
    ACMMP.cu / main.cpp (citations on each field).
    """

    # -- core schedule (ACMMP.h:33-40) --------------------------------------
    max_iterations: int = 3          # photometric; geom passes force 2 (ACMMP.cpp:551)
    patch_size: int = 11             # NCC window (ACMMP.h:34)
    radius_increment: int = 2        # NCC tap stride (ACMMP.h:37) -> 6x6=36 taps
    sigma_spatial: float = 5.0       # bilateral spatial sigma, px (ACMMP.h:38)
    sigma_color: float = 3.0         # bilateral color sigma (ACMMP.h:39)
    top_k: int = 4                   # views aggregated in the initial cost (ACMMP.h:40)
    max_image_size: int = 3200       # long-side cap (ACMMP.h:36)

    # -- working depth range (set per problem; ACMMP.cpp:645-646) -----------
    depth_min: float = 0.0
    depth_max: float = 1.0

    # -- mode flags (ACMMP.h:50-54) -----------------------------------------
    # note: the reference's ``upsample`` flag (ACMMP.h:54) has no equivalent
    # here by design -- the in-kernel hypothesis JBU of RandomInitialization
    # mode (c) (ACMMP.cu:713-779) is replaced by a host-side JBU of the coarse
    # depth/normal fields before seeding (pass_runner.py), so no kernel needs
    # to know whether sizes differ.
    geom_consistency: bool = False
    planar_prior: bool = False
    hierarchy: bool = False
    # the reference's multi_geometry flag only picks which source depth maps
    # a geometric pass reads (depths_geom.dmb after the first one); that is
    # host-side file selection here (pass_runner), not a pass parameter

    # -- propagation / view selection constants (ACMMP.cu) ------------------
    num_votes: int = 15              # importance-sample votes (ACMMP.cu:1187)
    view_prior_selected: float = 0.9  # neighbor-selected prior (ACMMP.cu:1154)
    view_prior_unselected: float = 0.1  # (ACMMP.cu:1156)
    cost_threshold_base: float = 0.8  # anneal: 0.8*exp(-iter^2/90) (ACMMP.cu:1163)
    cost_threshold_anneal: float = 90.0
    view_weight_beta: float = 0.18   # exp(-c^2/0.18) good-view weight (ACMMP.cu:1170)
    view_fallback_beta: float = 0.32  # exp(-thr^2/0.32) fallback (ACMMP.cu:1181)
    bad_cost: float = 1.2            # "false" view threshold (ACMMP.cu:1173)
    max_bad_views: int = 3           # reject view if >=3 candidates cost >1.2 (ACMMP.cu:1177)
    min_good_candidates: int = 2     # need count>2 for the mean path (ACMMP.cu:1177)
    geom_weight_prop: float = 0.2    # geom cost weight in propagation (ACMMP.cu:1216)
    geom_weight_refine: float = 0.1  # geom cost weight in refinement (ACMMP.cu:890)
    # note: the reference's 0.1*3.0 penalty for invalid candidates in geom mode
    # (ACMMP.cu:1219) has no knob here: invalid candidate regions carry cost
    # +inf (a documented intended-semantics fix, see ops/propagate.py), so they
    # can never win the argmin and the penalty term is unreachable.
    geom_max_cost: float = 3.0       # geometric consistency clamp (ACMMP.cu:648)
    cost_max: float = 2.0            # NCC cost clamp (ACMMP.cu:414)

    # -- refinement (ACMMP.cu:797-936) ---------------------------------------
    refine_perturbation: float = 0.02  # depth window +-2%, normal 0.02*pi (ACMMP.cu:815)

    # -- cost evaluation ----------------------------------------------------
    # "xla": the exact XLA path (ops/ncc.multiview_ncc + ops/geom), the
    # plain reference; "pallas": the per-pixel-tile kernel compiled through
    # Pallas-Triton (ops/pallas/ncc_tile.py); "interpret": that kernel in the
    # Pallas interpreter (tests).  The pipeline resolves
    # PipelineConfig.fast_ncc to one of the first two.
    cost_kernel: str = "xla"

    # -- planar prior model (ACMMP.cu:818-824, 1249-1255) --------------------
    prior_gamma: float = 0.5
    prior_beta: float = 0.18
    prior_angle_sigma_deg: float = 5.0
    prior_depth_sigma_div: float = 64.0  # sigma_d = (dmax-dmin)/64
    prior_init_perturbation: float = 0.02  # init perturb 3*0.02 (ACMMP.cu:692-699)

    # -- hierarchy (ACMMP.cu:713-779, 1315-1320) -----------------------------
    hierarchy_commit_margin: float = 0.1  # commit only if cost improves by >0.1
    jbu_sigma_spatial: float = 0.5   # hypothesis-upsampling sigmas (ACMMP.cu:715-716)
    jbu_sigma_range: float = 25.5

    # -- median filter (ACMMP.cu:1366-1480) ----------------------------------
    filter_min_cost: float = 0.001   # pixels below keep their depth

    # number of source views actually present (ref counts num_images = 1+src;
    # we keep the padded source count separately in the problem batch).
    @property
    def prior_angle_sigma(self) -> float:
        return math.pi * self.prior_angle_sigma_deg / 180.0

    def with_geom(self) -> "PatchMatchParams":
        """SetGeomConsistencyParams (reference ACMMP.cpp:548-555)."""
        return dataclasses.replace(self, geom_consistency=True, max_iterations=2)

    def with_hierarchy(self) -> "PatchMatchParams":
        return dataclasses.replace(self, hierarchy=True)

    def with_planar_prior(self) -> "PatchMatchParams":
        return dataclasses.replace(self, planar_prior=True)

    def with_depth_range(self, dmin: float, dmax: float) -> "PatchMatchParams":
        return dataclasses.replace(self, depth_min=float(dmin), depth_max=float(dmax))


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Planar-prior construction (host side; reference ACMMP.cpp:904-1011)."""

    cell_size: int = 5               # support-point grid (ACMMP.cpp:907)
    support_cost_threshold: float = 0.1  # (ACMMP.cpp:925)


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """GPU-path fusion thresholds (the path the reference actually runs,
    ACMMP.cu:1758-1778). The stricter of the two reference fusion variants."""

    max_reproj_error: float = 1.0
    max_rel_depth_diff: float = 0.01
    max_normal_angle: float = 0.149  # radians
    min_consistent: int = 3          # including the reference view itself
    max_src_views: int = 32          # FusionProblem cap (ACMMP.cu:1659)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Coarse-to-fine driver settings (reference main.cpp:392-482)."""

    patchmatch: PatchMatchParams = PatchMatchParams()
    prior: PriorConfig = PriorConfig()
    fusion: FusionParams = FusionParams()

    size_bound: int = 1000           # pyramid coarsest bound (main.cpp:38)
    geom_iterations: int = 2         # geometric passes per scale (main.cpp:412)
    depth_min_scale: float = 0.6     # working range padding (ACMMP.cpp:645-646)
    depth_max_scale: float = 1.2
    planar_prior: bool = True        # run the prior-assisted second round
    fast_ncc: str = "auto"           # per-pixel-tile cost kernel: "auto" =
                                     # on where the Pallas-Triton route
                                     # compiles, "on" (error where it cannot),
                                     # "off" (exact XLA path)
    seed: int = 0                    # global RNG seed (reference used clock64();
                                     # we are deterministic by design)
    max_src_views: int = 20          # pad/truncate source views per problem
                                     # (converter default top_k, colmap2mvsnet_acm.py:424)
    skip_if_complete: bool = False   # resume support: skip passes whose outputs exist
    tile_shard: int = 1              # intra-image tile parallelism: shard
                                     # each depth map along the image width
                                     # over this many local devices (GSPMD
                                     # halo exchange; parallel/tile.py).  For
                                     # frames too large for one device; forces
                                     # the exact array-program path and
                                     # disables view batching.
    batch_problems: str = "auto"     # device-batched pass execution over the
                                     # local view mesh (pipeline/batch_runner):
                                     # "auto" = on when >1 local device,
                                     # "on", "off".  Replaces the reference's
                                     # strictly serial per-image loop
                                     # (main.cpp:431-446)


DEFAULT_CONFIG = PipelineConfig()
