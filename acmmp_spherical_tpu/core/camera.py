"""Camera models.

Mirrors the reference ``Camera`` struct (reference main.h:40-54): a world-to-
camera rotation ``R`` (row-major), translation ``t`` (``X_cam = R @ X + t``),
pinhole intrinsics ``K`` or spherical (equirectangular) params ``[f, cx, cy]``,
image size and depth range.

Design notes
------------
* Cameras are a struct-of-arrays pytree (:class:`Cameras`) so a whole view set
  moves to the device as a handful of small arrays; a single view
  (:class:`Camera`) is the same pytree unbatched.
* The camera *model* (pinhole vs. sphere) is static pytree metadata: jit
  specialises on it, so the per-model trig never pays for the other branch.
  A scene mixing both models in one problem is not supported (the reference
  supports it in principle but never exercises it).
* Width/height live both as static ints (for array shapes) and in the float
  ``wh`` field (for projection math under vmap).

Depth convention (deviation from the reference, on purpose): the reference fork
mixes two conventions for pinhole cameras -- unit-ray range in the plane math
(ACMMP.cu:119-134, 187-193) but z-depth in unprojection/projection
(ACMMP.cu:565-644) -- which makes "depth" internally inconsistent per pixel.
We use one convention per model, consistent across *all* routines:

* PINHOLE: depth == z (the original upstream ACMMP convention),
* SPHERE:  depth == radial distance ``||X_cam||`` (the fork's convention).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

PINHOLE = "pinhole"
SPHERE = "sphere"  # equirectangular; COLMAP custom model id 11


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """A single camera. All fields are arrays so this pytree can live on device.

    ``K`` is the 3x3 pinhole intrinsic matrix (identity for sphere cameras);
    ``params`` is ``[f, cx, cy, 0]`` (sphere; zeros for pinhole);
    ``wh`` is ``[width, height]`` as float32;
    ``depth_range`` is ``[depth_min, depth_max]`` from the cam file.
    """

    R: jax.Array
    t: jax.Array
    K: jax.Array
    params: jax.Array
    wh: jax.Array
    depth_range: jax.Array
    model: str = dataclasses.field(default=PINHOLE, metadata=dict(static=True))

    @property
    def width(self) -> jax.Array:
        return self.wh[..., 0]

    @property
    def height(self) -> jax.Array:
        return self.wh[..., 1]


# A batch of cameras is the same pytree with a leading view axis on every leaf.
Cameras = Camera


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    *,
    model: str = PINHOLE,
    K: np.ndarray | None = None,
    sphere_params: Sequence[float] | None = None,
    width: int = 0,
    height: int = 0,
    depth_min: float = 0.0,
    depth_max: float = 1.0,
    dtype=np.float32,
) -> Camera:
    params = np.zeros(4, dtype)
    if model == SPHERE:
        assert sphere_params is not None and len(sphere_params) >= 3
        params[:3] = np.asarray(sphere_params[:3], dtype)
        K = np.eye(3)
    else:
        assert K is not None
    return Camera(
        R=jnp.asarray(R, dtype).reshape(3, 3),
        t=jnp.asarray(t, dtype).reshape(3),
        K=jnp.asarray(K, dtype).reshape(3, 3),
        params=jnp.asarray(params, dtype),
        wh=jnp.asarray([width, height], dtype),
        depth_range=jnp.asarray([depth_min, depth_max], dtype),
        model=model,
    )


def stack_cameras(cams: Sequence[Camera]) -> Cameras:
    """Stack single cameras into a view-batched pytree (leading view axis)."""
    models = {c.model for c in cams}
    if len(models) != 1:
        raise ValueError(f"cannot batch mixed camera models: {models}")
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)


def camera_index(cams: Cameras, i) -> Camera:
    """Select view ``i`` from a batched Cameras pytree (jit-friendly)."""
    return jax.tree.map(lambda a: a[i], cams)


def num_cameras(cams: Cameras) -> int:
    return cams.t.shape[0]


def camera_center(cam: Camera) -> jax.Array:
    """World-space camera center ``C = -R^T t`` (reference ACMMP.cu:590-594)."""
    return -jnp.einsum("...ji,...j->...i", cam.R, cam.t, precision=jax.lax.Precision.HIGHEST)


def scale_camera(cam: Camera, scale_x: float, scale_y: float,
                 new_width: int, new_height: int) -> Camera:
    """Rescale intrinsics with the image (reference ACMMP.cpp:630-642).

    Pinhole: fx,cx *= sx; fy,cy *= sy.  Sphere: cx *= sx; cy *= sy.
    """
    if cam.model == SPHERE:
        params = cam.params * jnp.asarray([1.0, scale_x, scale_y, 1.0], cam.params.dtype)
        K = cam.K
    else:
        s = jnp.asarray(
            [[scale_x, 1.0, scale_x], [1.0, scale_y, scale_y], [1.0, 1.0, 1.0]],
            cam.K.dtype,
        )
        K = cam.K * s
        params = cam.params
    return dataclasses.replace(
        cam, K=K, params=params,
        wh=jnp.asarray([new_width, new_height], cam.wh.dtype),
    )
