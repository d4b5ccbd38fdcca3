"""Planar-prior construction (host side).

Mirrors the reference's host pipeline (ACMMP.cpp:904-1011, main.cpp:113-197):

1. support points: the minimum-cost pixel of every 5x5 cell with cost < 0.1;
2. Delaunay triangulation of the support points (scipy.spatial.Delaunay in
   place of cv::Subdiv2D -- both produce a Delaunay triangulation of the same
   point set);
3. per-triangle plane fit: SVD null-space of the homogeneous 3-point system on
   the ref-camera-frame 3D points, sign-normalised (GetPriorPlaneParams);
4. triangle rasterisation into a label mask.  The reference steps barycentric
   coordinates at 1/max-edge-length, which leaves holes on sliver triangles;
   we rasterise exactly (every pixel centre inside or on the triangle) -- a
   documented improvement;
5. prior depth validation: pixels whose prior-plane depth falls outside the
   working range are unmasked (main.cpp:168-181).
"""

from __future__ import annotations

import numpy as np

from acmmp_spherical_tpu.config import PriorConfig
from acmmp_spherical_tpu.core.camera import Camera


def get_support_points(cost: np.ndarray, cfg: PriorConfig) -> np.ndarray:
    """(N, 2) int (x, y) minimum-cost support points (ACMMP.cpp:904-930)."""
    from acmmp_spherical_tpu.io import native

    cost = np.ascontiguousarray(cost, np.float32)
    if native.available():
        return native.support_points(cost, cfg.cell_size,
                                     cfg.support_cost_threshold)
    H, W = cost.shape
    cs = cfg.cell_size
    pts = []
    for row in range(0, H, cs):
        for col in range(0, W, cs):
            block = cost[row:row + cs, col:col + cs]
            idx = np.argmin(block)
            r, c = np.unravel_index(idx, block.shape)
            if block[r, c] < cfg.support_cost_threshold:
                pts.append((col + c, row + r))
    return np.asarray(pts, np.int32).reshape(-1, 2)


def triangulate(points: np.ndarray) -> np.ndarray:
    """(T, 3, 2) triangle vertices via Delaunay (ACMMP.cpp:932-954)."""
    if len(points) < 3:
        return np.zeros((0, 3, 2), np.int32)
    from scipy.spatial import Delaunay, QhullError

    try:
        tri = Delaunay(points.astype(np.float64))
    except QhullError:
        return np.zeros((0, 3, 2), np.int32)
    return points[tri.simplices]


def _np_pixel_ray(cam: Camera, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Pure-numpy mirror of geometry.pixel_ray (both camera models).

    The prior builder is host code that runs once per image between device
    passes; its per-triangle math stays in numpy so it dispatches no eager
    device operations."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if cam.model == "sphere":
        W = float(np.asarray(cam.width))
        H = float(np.asarray(cam.height))
        p = np.asarray(cam.params, np.float32)
        lon = (x - p[1]) / W * (2.0 * np.pi)
        lat = -(y - p[2]) / H * np.pi
        cl = np.cos(lat)
        return np.stack([cl * np.sin(lon), -np.sin(lat), cl * np.cos(lon)],
                        axis=-1)
    K = np.asarray(cam.K, np.float32)
    u = (x - K[0, 2]) / K[0, 0]
    v = (y - K[1, 2]) / K[1, 1]
    return np.stack([u, v, np.ones_like(u)], axis=-1)


def fit_planes(cam: Camera, depth: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Planes (T, 4) = (nx, ny, nz, w) through each triangle's 3 ref-cam 3D
    points (GetPriorPlaneParams, ACMMP.cpp:956-989) -- batched numpy SVD
    null-spaces, no device dispatches."""
    if len(tris) == 0:
        return np.zeros((0, 4), np.float32)
    xs = tris[..., 0].astype(np.float32)               # (T, 3)
    ys = tris[..., 1].astype(np.float32)
    ds = depth[tris[..., 1], tris[..., 0]].astype(np.float32)
    X = _np_pixel_ray(cam, xs, ys) * ds[..., None]     # (T, 3, 3)
    A = np.concatenate([X, np.ones((*X.shape[:2], 1), np.float32)], axis=-1)
    _, _, vt = np.linalg.svd(A)                        # batched (T, 4, 4)
    n4 = vt[:, -1]                                     # (T, 4) null-spaces
    norm = np.linalg.norm(n4[:, :3], axis=-1)
    norm = np.where(n4[:, 3] < 0, -norm, norm)
    out = np.where(norm[:, None] != 0, n4 / np.where(norm == 0, 1, norm)[:, None],
                   np.array([0, 0, -1, 0], np.float32))
    return out.astype(np.float32)


def fit_plane(cam: Camera, depth: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Single-triangle wrapper kept for API compatibility/tests."""
    return fit_planes(cam, depth, tri[None])[0]


def build_planar_prior(
    cam: Camera,
    depth: np.ndarray,
    cost: np.ndarray,
    depth_min: float,
    depth_max: float,
    cfg: PriorConfig,
):
    """Full prior construction.

    Returns (prior_normal (H, W, 3), prior_w (H, W), mask (H, W) bool,
    triangles (T, 3, 2)) -- triangles returned for the diagnostic overlay.
    """
    H, W = depth.shape
    depth = np.asarray(depth)
    pts = get_support_points(np.asarray(cost), cfg)
    tris = triangulate(pts)

    # in-bounds triangles only, then one batched numpy plane fit
    if len(tris):
        inb = ((tris[..., 0] >= 0) & (tris[..., 0] < W)
               & (tris[..., 1] >= 0) & (tris[..., 1] < H)).all(axis=1)
        kept = tris[inb]
    else:
        kept = tris
    planes = fit_planes(cam, depth, kept)

    mask_idx = rasterize_triangles(np.asarray(kept, np.int32), H, W)

    prior_normal = np.zeros((H, W, 3), np.float32)
    prior_normal[..., 2] = -1.0
    prior_w = np.zeros((H, W), np.float32)
    mask = mask_idx > 0
    if len(planes):
        lab = mask_idx[mask] - 1
        prior_normal[mask] = planes[lab, :3]
        prior_w[mask] = planes[lab, 3]

        # validate prior depths against the working range (main.cpp:168-181)
        # -- ray-plane intersection -w / (n . r) in numpy (host)
        ys, xs = np.nonzero(mask)
        n = prior_normal[ys, xs]
        w = prior_w[ys, xs]
        r = _np_pixel_ray(cam, xs.astype(np.float32), ys.astype(np.float32))
        denom = np.sum(n * r, axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(np.abs(denom) < 1e-6, -1.0, -w / denom)
        ok = (d >= depth_min) & (d <= depth_max)
        mask[ys[~ok], xs[~ok]] = False

    return prior_normal, prior_w, mask, np.asarray(kept).reshape(-1, 3, 2)


def rasterize_triangles(tris: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h, w) int32 label mask: ``t + 1`` on the pixels of triangle t (later
    triangles win), 0 elsewhere.  Native when built, numpy otherwise; both
    apply the same barycentric test."""
    from acmmp_spherical_tpu.io import native

    if native.available():
        return native.rasterize_triangles(tris, h, w)
    mask = np.zeros((h, w), np.int32)
    for t, v in enumerate(np.asarray(tris, np.float32).reshape(-1, 3, 2)):
        (x0, y0), (x1, y1), (x2, y2) = v
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if area == 0:
            continue
        lox, hix = max(0, int(np.floor(v[:, 0].min()))), min(w - 1, int(np.ceil(v[:, 0].max())))
        loy, hiy = max(0, int(np.floor(v[:, 1].min()))), min(h - 1, int(np.ceil(v[:, 1].max())))
        if lox > hix or loy > hiy:
            continue
        ys, xs = np.mgrid[loy:hiy + 1, lox:hix + 1].astype(np.float32)
        inv = np.float32(1.0) / area
        l0 = ((x1 - xs) * (y2 - ys) - (x2 - xs) * (y1 - ys)) * inv
        l1 = ((x2 - xs) * (y0 - ys) - (x0 - xs) * (y2 - ys)) * inv
        l2 = np.float32(1.0) - l0 - l1
        inside = (l0 >= -1e-6) & (l1 >= -1e-6) & (l2 >= -1e-6)
        mask[loy:hiy + 1, lox:hix + 1][inside] = t + 1
    return mask


def draw_triangulation(image_gray: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Diagnostic overlay like the reference's triangulation.png
    (main.cpp:122-137): RGB copy of the image with the triangle edges drawn
    in red as one-pixel lines."""
    img = np.clip(image_gray, 0, 255).astype(np.uint8)
    rgb = np.stack([img] * 3, axis=-1)
    tri = np.asarray(triangles, np.float64).reshape(-1, 3, 2)
    if len(tri) == 0:
        return rgb
    a = tri[:, [0, 0, 1]].reshape(-1, 2)
    b = tri[:, [1, 2, 2]].reshape(-1, 2)
    n = np.maximum(np.abs(b - a).max(axis=1), 1).astype(np.int64) + 1
    edge = np.repeat(np.arange(len(a)), n)
    step = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    frac = step / np.repeat(n - 1, n).clip(min=1)
    pts = np.rint(a[edge] + (b[edge] - a[edge]) * frac[:, None]).astype(np.int64)
    h, w = img.shape
    ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    rgb[pts[ok, 1], pts[ok, 0]] = (255, 0, 0)
    return rgb
