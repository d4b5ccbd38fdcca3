"""Analytic synthetic scenes for testing and benchmarking.

The reference has zero tests (SURVEY.md section 4); our kernel/integration tests
need scenes with *exact* ground truth and *exact* photo-consistency.  We get
both by making the scene analytic:

* geometry: the interior of an axis-aligned cube room (6 planes) -- the ray
  exit distance has a closed form (slab method) for any camera pose and model;
* appearance: a smooth multi-frequency 3D texture evaluated at the ray hit
  point, so every camera samples exactly the same surface signal with no
  interpolation error.

This yields rendered images, ground-truth depth (in each camera's depth
convention) and ground-truth world normals for pinhole and spherical cameras
alike.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from acmmp_spherical_tpu.core.camera import Camera, PINHOLE, SPHERE, make_camera
from acmmp_spherical_tpu.core import geometry as G


@dataclasses.dataclass(frozen=True)
class CubeRoom:
    """Interior of the cube ``[-half, half]^3`` with a procedural 3D texture."""

    half: float = 4.0
    # texture: sum of sinusoids A*sin(w . X + phi); rows: (A, wx, wy, wz, phi)
    waves: tuple = (
        (55.0, 1.3, 0.7, 0.2, 0.0),
        (35.0, 0.4, 2.3, 1.1, 1.2),
        (25.0, 3.1, 1.7, 2.9, 2.1),
        (15.0, 6.3, 4.1, 5.7, 0.7),
        (8.0, 11.7, 9.3, 12.1, 1.9),
    )
    base: float = 128.0

    def texture(self, X: np.ndarray) -> np.ndarray:
        """Intensity in ~[0, 255] at world points X (..., 3)."""
        val = np.full(X.shape[:-1], self.base)
        for A, wx, wy, wz, phi in self.waves:
            val = val + A * np.sin(X[..., 0] * wx + X[..., 1] * wy + X[..., 2] * wz + phi)
        return np.clip(val, 0.0, 255.0)

    def ray_exit(self, origin: np.ndarray, direction: np.ndarray):
        """Slab-method exit distance and inward face normal for rays starting
        inside the cube.  Returns (t, normal_world)."""
        d = np.where(np.abs(direction) < 1e-12, 1e-12, direction)
        t_hi = (self.half - origin) / d
        t_lo = (-self.half - origin) / d
        t_face = np.maximum(t_hi, t_lo)          # exit t per axis
        t = np.min(t_face, axis=-1)
        axis = np.argmin(t_face, axis=-1)
        sign = np.take_along_axis(np.sign(d), axis[..., None], axis=-1)[..., 0]
        normal = np.zeros(direction.shape)
        np.put_along_axis(normal, axis[..., None], -sign[..., None], axis=-1)
        return t, normal


@dataclasses.dataclass(frozen=True)
class OccludedRoom(CubeRoom):
    """CubeRoom with an interior axis-aligned box occluder.

    The box silhouette creates true depth discontinuities (fore/background
    steps of several units) -- the adversarial case for windowed/slab
    sampling, whose round-1 disagreements vs the exact path concentrated at
    depth edges (PERF.md).  Texture is the same world-space field, so
    photo-consistency stays perfect and any depth error is the sampler's.
    """

    box_center: tuple = (0.8, -0.4, 0.6)
    box_half: tuple = (1.0, 1.2, 0.8)

    def ray_exit(self, origin: np.ndarray, direction: np.ndarray):
        t_room, n_room = CubeRoom.ray_exit(self, origin, direction)
        d = np.where(np.abs(direction) < 1e-12, 1e-12, direction)
        c = np.asarray(self.box_center)
        h = np.asarray(self.box_half)
        t0 = (c - h - origin) / d
        t1 = (c + h - origin) / d
        t_near = np.minimum(t0, t1)
        t_far = np.maximum(t0, t1)
        t_enter = np.max(t_near, axis=-1)
        t_exit = np.min(t_far, axis=-1)
        hit = (t_enter < t_exit) & (t_enter > 1e-6) & (t_enter < t_room)
        axis = np.argmax(t_near, axis=-1)
        sign = np.take_along_axis(np.sign(d), axis[..., None], axis=-1)[..., 0]
        n_box = np.zeros(direction.shape)
        np.put_along_axis(n_box, axis[..., None], -sign[..., None], axis=-1)
        t = np.where(hit, t_enter, t_room)
        normal = np.where(hit[..., None], n_box, n_room)
        return t, normal


def _pixel_ray_np(cam: Camera, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Pure-numpy twin of geometry.pixel_ray (rendering is host work and
    dispatches no eager device operations)."""
    if cam.model == SPHERE:
        params = np.asarray(cam.params)
        W, H = np.asarray(cam.wh)
        lon = (xs - params[1]) / W * (2.0 * np.pi)
        lat = -(ys - params[2]) / H * np.pi
        cl = np.cos(lat)
        return np.stack([cl * np.sin(lon), -np.sin(lat), cl * np.cos(lon)], -1)
    K = np.asarray(cam.K)
    u = (xs - K[0, 2]) / K[0, 0]
    v = (ys - K[1, 2]) / K[1, 1]
    return np.stack([u, v, np.ones_like(u)], -1)


def render_view(cam: Camera, scene: CubeRoom, width: int, height: int):
    """Render (image, depth, normal_world) for a camera inside the scene.

    ``depth`` follows the camera's depth convention (z for pinhole, radial for
    sphere).  ``image`` is float32 in 0..255 (the loader convention).
    """
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    rays_cam = _pixel_ray_np(cam, xs, ys)  # (H, W, 3)
    R = np.asarray(cam.R)
    C = np.asarray(-R.T @ np.asarray(cam.t))
    rays_world = rays_cam @ R  # R^T applied to each ray
    t, normal = scene.ray_exit(C[None, None, :], rays_world)
    # X = C + t * ray_world; depth == t because X_cam = depth * ray_cam.
    X = C[None, None, :] + t[..., None] * rays_world
    image = scene.texture(X).astype(np.float32)
    return image, t.astype(np.float32), normal.astype(np.float32)


def make_ring_of_cameras(
    n: int,
    *,
    model: str = PINHOLE,
    width: int = 96,
    height: int = 72,
    focal: float = 80.0,
    radius: float = 0.35,
    half: float = 4.0,
    look_jitter: float = 0.0,
) -> list[Camera]:
    """Cameras near the room center on a small circle, all looking roughly +z.

    Small baselines so every camera sees mostly the same wall area (good view
    overlap like a real MVS capture).  Depth range is set generously around
    the true scene depths.
    """
    cams = []
    dmin, dmax = 0.3 * half, 2.5 * half
    for i in range(n):
        ang = 2.0 * np.pi * i / max(n, 1)
        C = np.array([radius * np.cos(ang), radius * np.sin(ang), -0.5 * half])
        # look direction: +z with optional small jitter
        fwd = np.array([look_jitter * np.sin(ang), -look_jitter * np.cos(ang), 1.0])
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        # rows of R are the camera axes expressed in world coords (world->cam)
        R = np.stack([right, up2, fwd])
        t = -R @ C
        if model == SPHERE:
            cams.append(
                make_camera(R, t, model=SPHERE,
                            sphere_params=[1.0, width / 2, height / 2],
                            width=width, height=height,
                            depth_min=dmin, depth_max=dmax)
            )
        else:
            K = np.array([[focal, 0.0, width / 2], [0.0, focal, height / 2],
                          [0.0, 0.0, 1.0]])
            cams.append(
                make_camera(R, t, model=PINHOLE, K=K, width=width, height=height,
                            depth_min=dmin, depth_max=dmax)
            )
    return cams


def render_scene(
    cams: Sequence[Camera], scene: CubeRoom, width: int, height: int
):
    """Render all views. Returns (images (V,H,W), depths (V,H,W),
    normals (V,H,W,3) world-frame)."""
    images, depths, normals = [], [], []
    for cam in cams:
        img, dep, nrm = render_view(cam, scene, width, height)
        images.append(img)
        depths.append(dep)
        normals.append(nrm)
    return np.stack(images), np.stack(depths), np.stack(normals)


def write_synthetic_scene_to_disk(root, cams, images, *, depth_pad=1.0):
    """Materialise a synthetic scene in the on-disk layout (images/, cams/,
    pair.txt) so end-to-end pipeline tests can run off the filesystem.
    Images are written losslessly as 8-bit PNG."""
    from acmmp_spherical_tpu.io.image import write_png
    from acmmp_spherical_tpu.io.scene import ScenePaths, write_camera_file, write_pair_file
    from acmmp_spherical_tpu.core.camera import SPHERE as S

    sp = ScenePaths(root)
    sp.images_dir.mkdir(parents=True, exist_ok=True)
    sp.cams_dir.mkdir(parents=True, exist_ok=True)
    n = len(cams)
    for i, cam in enumerate(cams):
        write_png(sp.images_dir / f"{i:08d}.png",
                  np.clip(np.rint(images[i]), 0, 255).astype(np.uint8))
        dmin, dmax = np.asarray(cam.depth_range)
        kwargs = dict(depth_min=float(dmin), depth_max=float(dmax),
                      depth_interval=float((dmax - dmin) / 191), num_planes=192)
        if cam.model == S:
            write_camera_file(sp.camera_file(i), S, np.asarray(cam.R),
                              np.asarray(cam.t),
                              sphere_params=np.asarray(cam.params)[:3], **kwargs)
        else:
            write_camera_file(sp.camera_file(i), "pinhole", np.asarray(cam.R),
                              np.asarray(cam.t), K=np.asarray(cam.K), **kwargs)
    neighbors = [[(j, 100.0) for j in range(n) if j != i] for i in range(n)]
    write_pair_file(sp.pair_file, neighbors)
    return sp


def render_scene_hostile(
    cams: Sequence[Camera],
    scene: CubeRoom,
    width: int,
    height: int,
    *,
    seed: int = 0,
    specular_ks: float = 30.0,
    specular_power: float = 8.0,
    gain_range: tuple = (0.85, 1.15),
    bias_range: tuple = (-10.0, 10.0),
    noise_sigma: float = 2.0,
    jpeg_quality: int = 75,
):
    """Hostile variant of :func:`render_scene` (VERDICT r2 item 6).

    The clean renders are near-ideal for NCC (perfectly Lambertian, no noise,
    no radiometric differences -- the reference was validated on real
    benchmark scenes, README.md:17).  This stresses every robustness
    mechanism the cost model claims:

    * a **specular lobe** (Blinn-Phong toward a fixed world light) -- a
      VIEW-DEPENDENT shading term that genuinely violates photo-consistency;
    * per-view **gain/bias** (exposure differences; NCC is invariant to
      affine intensity maps, the bilateral weights are not);
    * additive Gaussian **sensor noise**;
    * a **JPEG round-trip** at consumer quality (block artifacts; needs
      Pillow).

    Returns (images, depths, normals) like render_scene; depths/normals stay
    exact GT.
    """
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    light = np.array([0.3, -0.8, 0.52])
    light = light / np.linalg.norm(light)
    images, depths, normals = [], [], []
    for cam in cams:
        img, dep, nrm = render_view(cam, scene, width, height)
        R = np.asarray(cam.R)
        C = np.asarray(-R.T @ np.asarray(cam.t))
        ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
        rays_world = _pixel_ray_np(cam, xs, ys) @ R
        rays_world = rays_world / np.linalg.norm(rays_world, axis=-1,
                                                 keepdims=True)
        halfv = light[None, None] - rays_world          # toward viewer = -ray
        halfv = halfv / np.maximum(
            np.linalg.norm(halfv, axis=-1, keepdims=True), 1e-9)
        spec = np.maximum(np.sum(halfv * nrm, axis=-1), 0.0) ** specular_power
        img = img + specular_ks * spec.astype(np.float32)
        img = rng.uniform(*gain_range) * img + rng.uniform(*bias_range)
        img = img + rng.normal(0.0, noise_sigma, img.shape).astype(np.float32)
        img = np.clip(img, 0.0, 255.0)
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(
            buf, format="JPEG", quality=int(jpeg_quality))
        buf.seek(0)
        img = np.asarray(Image.open(buf).convert("L"), np.float32)
        images.append(img)
        depths.append(dep)
        normals.append(nrm)
    return np.stack(images), np.stack(depths), np.stack(normals)
