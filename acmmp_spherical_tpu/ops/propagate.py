"""Checkerboard PatchMatch: initialisation, propagation half-steps, refinement.

Array-program reformulation of the reference's per-pixel CUDA kernels:

* ``RandomInitialization`` (ACMMP.cu:673-795)  -> :func:`initialize_state`
* ``CheckerboardPropagation`` (ACMMP.cu:938-1325) + ``PlaneHypothesisRefinement``
  (ACMMP.cu:797-936) -> :func:`checkerboard_halfstep`

One half-step functionally updates all pixels of one checkerboard colour: the
update is computed as a full-grid array program and committed through a parity
mask, so the red-black (Gauss-Seidel) ordering of the reference is preserved
while races are impossible by construction (SURVEY.md 5.2).

Documented deviations from the reference fork (intended-semantics fixes):

* the fork's local ``plane_hypotheses_now`` is read uninitialised when no
  propagation candidate is accepted (ACMMP.cu:1301-1323); we initialise the
  running hypothesis from the centre pixel, which is the evident intent (and
  what upstream ACMMP does);
* in prior mode the fork's acceptance writes ``plane_hypotheses[center]``
  directly but the final unconditional store clobbers it with the
  uninitialised local (ACMMP.cu:1283 vs 1323); our acceptance updates the
  running local coherently;
* invalid candidate regions get cost ``+inf`` rather than the fork's
  uninitialised-stack costs (ACMMP.cu:957 aggregate-init quirk), so border
  pixels propagate from their *valid* regions instead of being disabled;
* the planar-prior branch of ``RandomInitialization`` is dead code in the fork
  (the first branch shadows it, ACMMP.cu:686); we implement the intended
  reachable semantics, with the world->cam rebase the fork's prior-else branch
  forgot (ACMMP.cu:704-710).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_tpu.core.camera import Camera, Cameras, SPHERE
from acmmp_spherical_tpu.core import geometry as G
from acmmp_spherical_tpu.core.plane import PlaneState
from acmmp_spherical_tpu.ops import rng as R
from acmmp_spherical_tpu.ops.candidates import (
    Candidates,
    NEAR_REGION_INDICES,
    gather_candidates,
)
from acmmp_spherical_tpu.ops.geom import geom_consistency_cost
from acmmp_spherical_tpu.ops.ncc import (
    RefTapContext,
    multiview_ncc,
    ref_tap_context,
    topk_cost_and_selection,
)
from acmmp_spherical_tpu.ops.sampling import (
    checkerboard_coords,
    checkerboard_pack,
    checkerboard_unpack,
    grid_coords,
)
from acmmp_spherical_tpu.ops.view_select import (
    joint_view_selection,
    view_selection_priors,
)


class PatchMatchInputs(NamedTuple):
    """Device-resident inputs of one Problem (one reference view + sources)."""

    ref_image: jax.Array               # (H, W) float32 grayscale 0..255
    src_images: jax.Array              # (S, Hp, Wp) padded source stack
    ref_cam: Camera
    src_cams: Cameras                  # batched (S)
    src_valid: jax.Array               # (S,) bool (padding mask)
    src_depths: Optional[jax.Array] = None    # (S, Hp, Wp) geom mode
    prior_normal: Optional[jax.Array] = None  # (H, W, 3) planar prior
    prior_w: Optional[jax.Array] = None       # (H, W)
    prior_mask: Optional[jax.Array] = None    # (H, W) bool
    src_packed: Optional[jax.Array] = None    # (S, Hp*Wp, 4) bilinear pack
    # working depth range as a *traced* (2,) array: per-problem ranges must not
    # bake into the compiled program (a static range would recompile every
    # image; reference ACMMP.cpp:645-646 sets it per problem)
    depth_range: Optional[jax.Array] = None


def prepare_inputs(inputs: "PatchMatchInputs") -> "PatchMatchInputs":
    """Precompute the packed bilinear corner tables for all source views
    (one gather row per NCC sample on the XLA path; see
    sampling.pack_bilinear)."""
    from acmmp_spherical_tpu.ops.sampling import pack_bilinear

    if inputs.src_packed is None:
        wrap = inputs.src_cams.model == SPHERE
        packed = jax.vmap(
            lambda img, wd, ht: pack_bilinear(img, wd, ht, wrap_x=wrap)
        )(inputs.src_images, inputs.src_cams.width, inputs.src_cams.height)
        inputs = inputs._replace(src_packed=packed)
    return inputs


def _depth_range(inputs, params):
    """Traced (dmin, dmax) scalars for the working depth range."""
    if inputs.depth_range is not None:
        return inputs.depth_range[0], inputs.depth_range[1]
    return (jnp.float32(params.depth_min), jnp.float32(params.depth_max))


def _aggregate(cost_vec, geom_vec, weights, weight_norm, geom_weight, params):
    """Weighted multi-view aggregation (ACMMP.cu:1210-1228 / 884-899)."""
    total = cost_vec if geom_vec is None else cost_vec + geom_weight * geom_vec
    agg = jnp.sum(weights * total, axis=0)
    return agg / jnp.maximum(weight_norm, 1e-20)


def _cost_and_geom(inputs, ctx, normal, w, params, geom_on):
    """Exact XLA cost vectors of one plane field: (cv (S, ...), gv | None)."""
    cv = multiview_ncc(
        inputs.src_images, inputs.src_cams, inputs.ref_cam, normal, w, ctx,
        params, src_packed=inputs.src_packed,
    )
    gv = None
    if geom_on:
        gv = geom_consistency_cost(inputs.src_depths, inputs.src_cams,
                                   inputs.ref_cam, normal, w, ctx.xs, ctx.ys,
                                   params)
    return cv, gv


def _batched_cost_vectors(inputs, ctx, params, normals, ws, *,
                          with_geom=True):
    """Photometric + geometric cost vectors of C candidate plane fields.

    normals (C, H, Wg, 3), ws (C, H, Wg) on the evaluation grid (the full
    grid or a checkerboard-packed half-grid).  Returns (cv (C, S, H, Wg),
    gv | None) with padded views forced to the maximum costs.
    ``params.cost_kernel`` picks the evaluation: the XLA reference
    (``multiview_ncc`` + ``geom_consistency_cost`` per field) or the
    per-pixel-tile Pallas kernel (ops/pallas/ncc_tile.py), which evaluates
    the whole batch in one launch.
    """
    geom_on = (with_geom and params.geom_consistency
               and inputs.src_depths is not None)
    if params.cost_kernel == "xla":
        cv, gv = jax.lax.map(
            lambda nw: _cost_and_geom(inputs, ctx, nw[0], nw[1], params,
                                      geom_on),
            (normals, ws),
        )
    else:
        from acmmp_spherical_tpu.ops.pallas.ncc_tile import tile_cost_vectors

        out = tile_cost_vectors(
            inputs.src_images, inputs.src_cams, inputs.ref_cam, normals, ws,
            ctx, params, inputs.src_depths if geom_on else None,
            interpret=params.cost_kernel == "interpret",
        )
        cv, gv = out if geom_on else (out, None)
    valid = inputs.src_valid[None, :, None, None]
    cv = jnp.where(valid, cv, params.cost_max)
    if gv is not None:
        gv = jnp.where(valid, gv, params.geom_max_cost)
    return cv, gv


def _prior_weight(depth, normal, prior_depth, prior_normal, params, dmin, dmax):
    """Planar-prior plausibility (ACMMP.cu:1249-1276, 917-919)."""
    depth_sigma = (dmax - dmin) / params.prior_depth_sigma_div
    two_ds2 = 2.0 * depth_sigma * depth_sigma
    angle_sigma = params.prior_angle_sigma
    two_as2 = 2.0 * angle_sigma * angle_sigma
    dd = depth - prior_depth
    cos_a = jnp.clip(jnp.sum(normal * prior_normal, axis=-1), -1.0, 1.0)
    da = jnp.arccos(cos_a)
    return params.prior_gamma + jnp.exp(-dd * dd / two_ds2) * jnp.exp(-da * da / two_as2)


def _restricted(cost, prior_wt, params):
    return jnp.exp(-cost * cost / params.prior_beta) * prior_wt


# ---------------------------------------------------------------------------
# initialisation (RandomInitialization, ACMMP.cu:673-795)
# ---------------------------------------------------------------------------

def initialize_state(
    inputs: PatchMatchInputs,
    params: PatchMatchParams,
    key: jax.Array,
    *,
    prev_state: Optional[PlaneState] = None,
    seed_normal_world: Optional[jax.Array] = None,  # (H, W, 3) world frame
    seed_depth: Optional[jax.Array] = None,         # (H, W)
    ctx: Optional[RefTapContext] = None,
) -> PlaneState:
    """Build the initial plane field + costs for one PatchMatch pass.

    Modes (matching reference RandomInitialization):

    * fresh photometric: random planes (mode a);
    * ``params.planar_prior`` with ``prev_state``: perturb the prior where
      masked and the previous cost is poor, else keep the previous plane
      (mode b, intended semantics);
    * geom / hierarchy seeding: ``seed_normal_world`` + ``seed_depth`` from the
      previous pass's dmb outputs, rebased into the ref-cam frame (modes c/d).
      For hierarchy-upsample the caller passes the already-upsampled fields.
    """
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W)
    cam = inputs.ref_cam
    if ctx is None:
        ctx = ref_tap_context(inputs.ref_image, cam, params)

    if params.planar_prior:
        if prev_state is None or inputs.prior_mask is None:
            raise ValueError("planar-prior init needs prev_state and prior fields")
        k1, k2, k3 = jax.random.split(key, 3)
        # perturb the prior plane: w +- 3*2% (uniform), normal Euler
        # +- 3*0.02*pi (reference ACMMP.cu:692-700)
        pert = params.prior_init_perturbation
        w_prior = inputs.prior_w
        w_lo = (1.0 - 3.0 * pert) * w_prior
        w_hi = (1.0 + 3.0 * pert) * w_prior
        u = R.uniform(k1, w_prior.shape)
        w_pert = w_lo + u * (w_hi - w_lo)
        n_pert = R.perturbed_normal(
            k2, cam, xs, ys, inputs.prior_normal, 3.0 * pert * jnp.pi
        )
        use_prior = inputs.prior_mask & (prev_state.cost >= 0.1)
        # else-branch: keep the previous plane.  Our state never leaves the
        # optimisation (ref-cam) frame, so no rebase roundtrip is needed (the
        # reference rebases because its buffer was converted in place by
        # GetDepthandNormal -- and its prior branch forgets the frame
        # transform, ACMMP.cu:704-710).
        normal = jnp.where(use_prior[..., None], n_pert, prev_state.normal)
        w = jnp.where(use_prior, w_pert, prev_state.w)
    elif params.geom_consistency or params.hierarchy:
        if seed_normal_world is None or seed_depth is None:
            raise ValueError("geom/hierarchy init needs seed fields")
        # rebase world normals + depths into plane params (ACMMP.cu:780-793)
        normal = G.normal_world_to_cam(cam, seed_normal_world)
        normal = G.normalize(normal)
        w = G.dist_to_origin(cam, xs, ys, seed_depth, normal)
    else:
        dmin, dmax = _depth_range(inputs, params)
        normal, w = R.random_plane_hypothesis(key, cam, xs, ys, dmin, dmax)

    cv, _ = _batched_cost_vectors(inputs, ctx, params, normal[None], w[None],
                                  with_geom=False)
    cost_vec = cv[0]
    cost, selected = topk_cost_and_selection(cost_vec, inputs.src_valid, params)
    # hierarchy commit threshold = the seeded plane's own initial cost (the
    # fork stores a garbage-normal cost / leaves it uninitialised;
    # ACMMP.cu:770-771, SURVEY.md quirks)
    pre_cost = cost
    return PlaneState(normal=normal, w=w, cost=cost, selected=selected,
                      pre_cost=pre_cost)


# ---------------------------------------------------------------------------
# refinement (PlaneHypothesisRefinement, ACMMP.cu:797-936)
# ---------------------------------------------------------------------------

def _refinement_candidates(inputs, params, key, xs, ys, normal, w, depth,
                           prior_normal, prior_mask, prior_depth, dmin, dmax):
    """The 5 refinement candidate plane fields anchored at (normal, w, depth).

    Candidate table (ACMMP.cu:871-874):
    (rand_d, cur_n), (cur_d, rand_n), (rand_d, rand_n), (cur_d, pert_n),
    (pert_d, cur_n).  Returns (cand_normals (5, ..., 3), cand_w (5, ...),
    cand_depth_at (5, ...)).
    """
    cam = inputs.ref_cam
    perturbation = params.refine_perturbation
    k_rd, k_rn, k_pn, k_pd = jax.random.split(key, 4)

    depth_sigma = (dmax - dmin) / params.prior_depth_sigma_div

    if params.planar_prior:
        has_prior = prior_mask
        # prior-guided random sampling (ACMMP.cu:830-836); unmasked pixels
        # fall back to the free range
        lo_p = jnp.maximum(prior_depth - 3.0 * depth_sigma, dmin)
        hi_p = jnp.minimum(prior_depth + 3.0 * depth_sigma, dmax)
        u = R.uniform(k_rd, depth.shape)
        d_rand_prior = R.sample_depth_inv(u, lo_p, hi_p)
        d_rand_free = R.sample_depth_inv(u, dmin, dmax)
        depth_rand = jnp.where(has_prior, d_rand_prior, d_rand_free)
        n_rand_prior = R.perturbed_normal(
            k_rn, cam, xs, ys, prior_normal, params.prior_angle_sigma
        )
        n_rand_free = R.random_normal_toward_viewer(k_rn, cam, xs, ys)
        normal_rand = jnp.where(has_prior[..., None], n_rand_prior, n_rand_free)
    else:
        u = R.uniform(k_rd, depth.shape)
        depth_rand = R.sample_depth_inv(u, dmin, dmax)
        normal_rand = R.random_normal_toward_viewer(k_rn, cam, xs, ys)

    # local inverse-depth window around the current depth (ACMMP.cu:843-863);
    # the 32-try loop always succeeds on try 1 because the window is clamped
    # inside the global range, so one sample is exact.
    lo = jnp.maximum((1.0 - perturbation) * depth, dmin)
    hi = jnp.minimum((1.0 + perturbation) * depth, dmax)
    healed = ~(hi > lo)
    lo = jnp.where(healed, dmin, lo)
    hi = jnp.where(healed, dmax, hi)
    depth_pert = R.sample_depth_inv(R.uniform(k_pd, depth.shape), lo, hi)
    normal_pert = R.perturbed_normal(
        k_pn, cam, xs, ys, normal, perturbation * jnp.pi
    )

    cand_depths = jnp.stack([depth_rand, depth, depth_rand, depth, depth_pert])
    cand_normals = jnp.stack([normal, normal_rand, normal_rand, normal_pert, normal])
    cand_w = jax.vmap(lambda d, n: G.dist_to_origin(cam, xs, ys, d, n))(
        cand_depths, cand_normals
    )

    cand_depth_at = jax.vmap(
        lambda n_i, w_i: G.depth_from_plane(cam, xs, ys, n_i, w_i)
    )(cand_normals, cand_w)
    return cand_normals, cand_w, cand_depth_at


def _refinement(
    inputs, ctx, params, key, xs, ys,
    normal, w, depth, cost, restricted, sel,
    prior_normal, prior_mask, prior_depth, dmin, dmax,
):
    """Sequentially ratchet through the 5 refinement candidates
    (PlaneHypothesisRefinement, ACMMP.cu:797-936), anchored at the
    post-acceptance running hypothesis like the reference."""
    cam = inputs.ref_cam

    cand_normals, cand_w, cand_depth_at = _refinement_candidates(
        inputs, params, key, xs, ys, normal, w, depth,
        prior_normal, prior_mask, prior_depth, dmin, dmax)

    cv5, gv5 = _batched_cost_vectors(inputs, ctx, params, cand_normals,
                                     cand_w)
    cand_costs = jnp.stack([
        _aggregate(cv5[i], None if gv5 is None else gv5[i], sel.weights,
                   sel.weight_norm, params.geom_weight_refine, params)
        for i in range(5)
    ])  # (5, H, W)
    cand_depth_at_pixel = cand_depth_at

    can_refine = sel.weight_norm > 0.0  # reference early-out (ACMMP.cu:813)

    def step(carry, cand):
        n_cur, w_cur, d_cur, c_cur, r_cur = carry
        n_i, w_i, c_i, d_i = cand
        valid = (
            can_refine
            & (d_i >= dmin)
            & (d_i <= dmax)
            & (d_i < G.INVALID_DEPTH)
        )
        if params.planar_prior:
            pw = _prior_weight(
                # NOTE: prior weighting uses the *sampled* candidate depth
                # table value in the fork (depths[i]); the plane-at-pixel
                # depth d_i equals it by construction of cand_w.
                d_i, n_i, prior_depth, prior_normal, params, dmin, dmax
            )
            r_i = _restricted(c_i, pw, params)
            accept_p = valid & prior_mask & (r_i > r_cur)
            accept_s = valid & ~prior_mask & (c_i < c_cur)
            accept = accept_p | accept_s
            r_new = jnp.where(accept_p, r_i, r_cur)
        else:
            accept = valid & (c_i < c_cur)
            r_new = r_cur
        n_new = jnp.where(accept[..., None], n_i, n_cur)
        w_new = jnp.where(accept, w_i, w_cur)
        d_new = jnp.where(accept, d_i, d_cur)
        c_new = jnp.where(accept, c_i, c_cur)
        return (n_new, w_new, d_new, c_new, r_new), None

    (normal, w, depth, cost, restricted), _ = jax.lax.scan(
        step,
        (normal, w, depth, cost, restricted),
        (cand_normals, cand_w, cand_costs, cand_depth_at_pixel),
    )
    return normal, w, depth, cost, restricted


# ---------------------------------------------------------------------------
# one red/black half-step
# ---------------------------------------------------------------------------

def _pack_hw(a, parity, *, channels_last=False):
    """checkerboard_pack for fields with optional trailing channel axis."""
    if channels_last:
        return jnp.moveaxis(
            checkerboard_pack(jnp.moveaxis(a, -1, 0), parity), 0, -1
        )
    return checkerboard_pack(a, parity)


def _halfstep_core(
    inputs, ctx, params, key, iteration, xs, ys,
    cur_normal, cur_w, cur_cost, cur_pre_cost, cur_selected,
    cands: Candidates, priors, prior_normal, prior_w, prior_mask,
):
    """The grid-agnostic propagation + refinement update.

    All spatial fields share one grid shape (the packed half-grid in the fast
    path, the full grid in the fallback).  Returns the updated
    (normal, w, cost, selected) for every position of that grid.
    """
    cam = inputs.ref_cam
    k_votes, k_refine = jax.random.split(key)
    dmin, dmax = _depth_range(inputs, params)

    # 2. multi-view photometric + geometric cost vectors of the 8
    # propagation candidates and of the current plane (step 5), in one batch
    all_n = jnp.concatenate([cands.normal, cur_normal[None]], axis=0)
    all_w = jnp.concatenate([cands.w, cur_w[None]], axis=0)
    cv_all, gv_all = _batched_cost_vectors(inputs, ctx, params, all_n, all_w)
    cost_arrays = cv_all[:8]
    geom_arrays = None if gv_all is None else gv_all[:8]

    # 3. joint view selection
    sel = joint_view_selection(
        cost_arrays, cands.valid, priors, inputs.src_valid,
        params, k_votes, iteration,
    )

    def agg_k(k_idx):
        gv = None if geom_arrays is None else geom_arrays[k_idx]
        return _aggregate(cost_arrays[k_idx], gv, sel.weights, sel.weight_norm,
                          params.geom_weight_prop, params)

    final_costs = jnp.stack([agg_k(k) for k in range(8)])      # (8, ...)
    final_costs = jnp.where(cands.valid, final_costs, jnp.inf)
    # positions with no votes cannot evaluate costs meaningfully
    no_votes = sel.weight_norm <= 0.0

    # 6. propagation winner (argmin of the ranking costs)
    min_idx = jnp.argmin(final_costs, axis=0)
    take = lambda a: jnp.take_along_axis(a, min_idx[None], 0)[0]
    best_cost = take(final_costs)
    best_n = jnp.take_along_axis(cands.normal, min_idx[None, ..., None], 0)[0]
    best_w = take(cands.w)
    best_valid = take(cands.valid.astype(jnp.int32)) > 0
    best_depth = G.depth_from_plane(cam, xs, ys, best_n, best_w)
    in_range = (best_depth >= dmin) & (best_depth <= dmax)

    # 5. current-plane cost under this half-step's view weights
    cv_now, gv_now = cv_all[8], None if gv_all is None else gv_all[8]
    cost_now0 = _aggregate(cv_now, gv_now, sel.weights, sel.weight_norm,
                           params.geom_weight_prop, params)
    cost_now0 = jnp.where(no_votes, cur_cost, cost_now0)

    depth_now0 = G.depth_from_plane(cam, xs, ys, cur_normal, cur_w)

    if params.planar_prior:
        prior_depth = G.depth_from_plane(cam, xs, ys, prior_normal, prior_w)
        pw_cand = jax.vmap(
            lambda n_k, w_k: _prior_weight(
                G.depth_from_plane(cam, xs, ys, n_k, w_k), n_k,
                prior_depth, prior_normal, params, dmin, dmax)
        )(cands.normal, cands.w)                                # (8, ...)
        restricted_cands = jnp.where(
            cands.valid, _restricted(final_costs, pw_cand, params), 0.0
        )
        max_idx = jnp.argmax(restricted_cands, axis=0)
        r_take = lambda a: jnp.take_along_axis(a, max_idx[None], 0)[0]
        rbest = r_take(restricted_cands)
        rbest_n = jnp.take_along_axis(cands.normal, max_idx[None, ..., None], 0)[0]
        rbest_w = r_take(cands.w)
        rbest_cost = r_take(final_costs)
        rbest_valid = r_take(cands.valid.astype(jnp.int32)) > 0
        rbest_depth = G.depth_from_plane(cam, xs, ys, rbest_n, rbest_w)
        r_in_range = (rbest_depth >= dmin) & (rbest_depth <= dmax)

        pw_now = _prior_weight(depth_now0, cur_normal, prior_depth,
                               prior_normal, params, dmin, dmax)
        restricted_now = _restricted(cost_now0, pw_now, params)

        mask = prior_mask
        accept_p = mask & rbest_valid & r_in_range & (rbest > restricted_now) & ~no_votes
        accept_s = ~mask & best_valid & in_range & (best_cost < cost_now0) & ~no_votes

        normal_loc = jnp.where(
            accept_p[..., None], rbest_n,
            jnp.where(accept_s[..., None], best_n, cur_normal),
        )
        w_loc = jnp.where(accept_p, rbest_w, jnp.where(accept_s, best_w, cur_w))
        depth_loc = jnp.where(accept_p, rbest_depth,
                              jnp.where(accept_s, best_depth, depth_now0))
        cost_loc = jnp.where(accept_p, rbest_cost,
                             jnp.where(accept_s, best_cost, cost_now0))
        # restricted ratchet starts at 0 and is set only on prior acceptance
        # (reference ACMMP.cu:1246, 1285)
        restricted_loc = jnp.where(accept_p, rbest, 0.0)
        # selected_views update only in the masked prior branch
        # (ACMMP.cu:1286; the mask==0 branch does not update)
        sel_loc = jnp.where(accept_p[None], sel.temp_selected, cur_selected)
    else:
        prior_depth = None
        accept = best_valid & in_range & (best_cost < cost_now0) & ~no_votes
        normal_loc = jnp.where(accept[..., None], best_n, cur_normal)
        w_loc = jnp.where(accept, best_w, cur_w)
        depth_loc = jnp.where(accept, best_depth, depth_now0)
        cost_loc = jnp.where(accept, best_cost, cost_now0)
        restricted_loc = jnp.zeros_like(cost_loc)
        sel_loc = jnp.where(accept[None], sel.temp_selected, cur_selected)

    # 7. refinement
    normal_f, w_f, _, cost_f, _ = _refinement(
        inputs, ctx, params, k_refine, xs, ys,
        normal_loc, w_loc, depth_loc, cost_loc, restricted_loc, sel,
        prior_normal, prior_mask, prior_depth, dmin, dmax,
    )

    # 8. hierarchy commit guard (ACMMP.cu:1315-1324)
    if params.hierarchy:
        commit = cost_f < cur_pre_cost - params.hierarchy_commit_margin
        normal_f = jnp.where(commit[..., None], normal_f, cur_normal)
        w_f = jnp.where(commit, w_f, cur_w)
        # non-committed positions keep the re-evaluated current cost
        # (ACMMP.cu:1244's unconditional store)
        cost_f = jnp.where(commit, cost_f, cost_now0)

    return normal_f, w_f, cost_f, sel_loc


def checkerboard_halfstep(
    state: PlaneState,
    inputs: PatchMatchInputs,
    ctx: RefTapContext,
    params: PatchMatchParams,
    key: jax.Array,
    iteration,
    parity: int,
) -> PlaneState:
    """Update all pixels with ``(x + y) % 2 == parity``.

    parity 0 == the reference's "black" kernel, 1 == "red"
    (BlackPixelUpdate/RedPixelUpdate, ACMMP.cu:1327-1349).  ``parity`` may be
    a Python int or a traced int32 scalar.

    Fast path: when H and W are even, the active colour is packed into a dense
    (H, W/2) half-grid before the expensive multi-view cost evaluations --
    halving the sampling work exactly like the reference's half-lattice kernel
    launches.  Candidate gathering and the neighbour priors stay on the full
    grid (cheap shifts).
    """
    H, W = state.cost.shape
    cam = inputs.ref_cam
    wrap = cam.model == SPHERE

    # 1. adaptive checkerboard candidates + neighbour priors (full grid)
    cands = gather_candidates(state.normal, state.w, state.cost, wrap_x=wrap)
    near_valid = cands.valid[jnp.asarray(NEAR_REGION_INDICES)]
    priors = view_selection_priors(state.selected, near_valid, params,
                                   wrap_x=wrap)

    has_prior = params.planar_prior and inputs.prior_normal is not None
    packed_ok = H % 2 == 0 and W % 2 == 0
    if packed_ok:
        P = lambda a: checkerboard_pack(a, parity)
        Pc = lambda a: _pack_hw(a, parity, channels_last=True)
        xs_p, ys_p = checkerboard_coords(H, W, parity)
        ctx_p = ctx._replace(
            ref_taps=P(ctx.ref_taps), weights=P(ctx.weights),
            center=P(ctx.center), xs=xs_p, ys=ys_p,
        )
        cands_p = Candidates(normal=Pc(cands.normal), w=P(cands.w),
                             valid=P(cands.valid))
        normal_f, w_f, cost_f, sel_f = _halfstep_core(
            inputs, ctx_p, params, key, iteration, xs_p, ys_p,
            Pc(state.normal), P(state.w), P(state.cost), P(state.pre_cost),
            P(state.selected), cands_p, P(priors),
            Pc(inputs.prior_normal) if has_prior else None,
            P(inputs.prior_w) if has_prior else None,
            P(inputs.prior_mask) if has_prior else None,
        )
        return PlaneState(
            normal=jnp.moveaxis(
                checkerboard_unpack(jnp.moveaxis(normal_f, -1, 0),
                                    jnp.moveaxis(state.normal, -1, 0), parity),
                0, -1),
            w=checkerboard_unpack(w_f, state.w, parity),
            cost=checkerboard_unpack(cost_f, state.cost, parity),
            selected=checkerboard_unpack(sel_f, state.selected, parity),
            pre_cost=state.pre_cost,
        )

    # fallback: odd dimensions -> full-grid compute, parity-masked commit
    xs, ys = grid_coords(H, W)
    normal_f, w_f, cost_f, sel_f = _halfstep_core(
        inputs, ctx, params, key, iteration, xs, ys,
        state.normal, state.w, state.cost, state.pre_cost, state.selected,
        cands, priors,
        inputs.prior_normal if has_prior else None,
        inputs.prior_w if has_prior else None,
        inputs.prior_mask if has_prior else None,
    )
    par = ((xs.astype(jnp.int32) + ys.astype(jnp.int32)) % 2) == parity
    return PlaneState(
        normal=jnp.where(par[..., None], normal_f, state.normal),
        w=jnp.where(par, w_f, state.w),
        cost=jnp.where(par, cost_f, state.cost),
        selected=jnp.where(par[None], sel_f, state.selected),
        pre_cost=state.pre_cost,
    )


# ---------------------------------------------------------------------------
# depth/normal extraction (GetDepthandNormal, ACMMP.cu:1351-1364)
# ---------------------------------------------------------------------------

def extract_depth_and_normal(state: PlaneState, cam: Camera):
    """Convert the optimised plane field to (depth (H, W), world normal
    (H, W, 3))."""
    H, W = state.w.shape
    xs, ys = grid_coords(H, W)
    depth = G.depth_from_plane(cam, xs, ys, state.normal, state.w)
    normal_world = G.normal_cam_to_world(cam, state.normal)
    return depth, normal_world
