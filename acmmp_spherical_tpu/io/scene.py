"""Scene layout, camera-file and pair-list parsing.

A scene folder follows the reference's on-disk contract so the two engines are
drop-in interchangeable (SURVEY.md L3 interface):

.. code-block:: text

    <dense>/images/%08d.jpg          input images (.png / .pgm also read)
    <dense>/cams/%08d_cam.txt        text camera files
    <dense>/pair.txt                 view-selection lists
    <dense>/ACMMP/2333_%08d/         per-view results: depths.dmb,
                                     depths_geom.dmb, normals.dmb, costs.dmb
    <dense>/ACMMP/ACMMP_model.ply    fused cloud

Camera file format (reference ReadCamera, ACMMP.cpp:146-209)::

    extrinsic
    R00 R01 R02 t0
    R10 R11 R12 t1
    R20 R21 R22 t2
    0 0 0 1

    intrinsic
    SPHERE            |  K00 K01 K02
    f cx cy           |  K10 K11 K12
                      |  K20 K21 K22

    depth_min depth_interval n_planes depth_max

(The reference fork's C++ pinhole reader takes fields 0/1 as dmin/dmax --
inconsistent with its own converter's writer, which emits the line above for
all models; ``read_camera_file`` accepts both conventions.  See the
docstrings below.)
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Sequence

import numpy as np

from acmmp_spherical_tpu.core.camera import Camera, PINHOLE, SPHERE, make_camera
from acmmp_spherical_tpu.io.image import read_image, resize_bilinear, to_gray, to_rgb
from acmmp_spherical_tpu.utils.log import get_logger

log = get_logger(__name__)

RESULT_DIR_FMT = "2333_{:08d}"  # reference main.cpp:79
OUTPUT_SUBDIR = "ACMMP"
IMAGE_EXTS = (".jpg", ".png", ".pgm")   # .jpg is the reference's layout


@dataclasses.dataclass
class Problem:
    """One view cluster: a reference image and its selected source views
    (reference main.h:58-64)."""

    ref_image_id: int
    src_image_ids: list[int]
    max_image_size: int = 3200
    num_downscale: int = 0
    cur_image_size: int = 3200


# ---------------------------------------------------------------------------
# camera text files
# ---------------------------------------------------------------------------

def read_camera_file(path: str | os.PathLike) -> Camera:
    """Parse a cam.txt (reference ReadCamera, ACMMP.cpp:146-209).

    Width/height are not stored in the file; they are filled in from the image
    by the loader (reference ACMMP.cpp:585-586).  For the sphere model the
    depth line is ``dmin dint nplanes dmax``; for pinhole ``dmin dmax d d``.
    """
    tokens = Path(path).read_text().split()
    it = iter(tokens)

    def next_f():
        return float(next(it))

    tok = next(it)
    if tok != "extrinsic":
        raise ValueError(f"{path}: expected 'extrinsic', got {tok!r}")
    E = np.array([next_f() for _ in range(16)]).reshape(4, 4)
    R, t = E[:3, :3], E[:3, 3]

    tok = next(it)
    if tok != "intrinsic":
        raise ValueError(f"{path}: expected 'intrinsic', got {tok!r}")
    tok = next(it)
    if tok == "SPHERE":
        f, cx, cy = next_f(), next_f(), next_f()
        dmin, _dint, _nplanes, dmax = next_f(), next_f(), next_f(), next_f()
        return make_camera(R, t, model=SPHERE, sphere_params=[f, cx, cy],
                           depth_min=dmin, depth_max=dmax)
    K = np.array([float(tok)] + [next_f() for _ in range(8)]).reshape(3, 3)
    vals = []
    for _ in range(4):
        try:
            vals.append(next_f())
        except StopIteration:
            break
    # The pinhole depth line exists in two conventions:
    #   converter format   dmin dint nplanes dmax   (colmap2mvsnet_acm.py:388
    #                      writes this for ALL models)
    #   C++ reader format  dmin dmax d d            (ACMMP.cpp:205 reads
    #                      fields 0/1 as the range)
    # The reference fork is internally INCONSISTENT here: feeding its own
    # converter output to its own reader sets depth_max = depth_interval for
    # pinhole scenes -- an evident bug we knowingly fix by disambiguating.
    # The converter identity dint*(nplanes-1) == dmax-dmin detects its
    # format; a "dmax" below dmin can only be an interval.
    dmin = vals[0] if vals else 0.0
    dmax = vals[1] if len(vals) > 1 else 1.0
    if len(vals) == 4:
        a, b, c, d = vals
        span_id = (c >= 2 and abs(c - round(c)) < 1e-6
                   and abs(b * (round(c) - 1) - (d - a)) <= 0.02 * max(d - a, 1e-9))
        if b <= a or span_id:
            if b > a:
                # only the converter identity fired: a legitimate C++-format
                # file whose dummy 4th field happens to satisfy it would be
                # silently rewritten -- make format detection auditable
                log.warning(
                    "%s: pinhole depth line %r matched the converter format "
                    "dmin dint nplanes dmax (dint*(nplanes-1) ~= dmax-dmin); "
                    "using depth range (%g, %g). If this file is in the C++ "
                    "'dmin dmax d d' convention, the intended range was "
                    "(%g, %g).", path, vals, a, d, a, b)
            dmin, dmax = a, d
    return make_camera(R, t, model=PINHOLE, K=K, depth_min=dmin, depth_max=dmax)


def write_camera_file(path, camera_model: str, R, t, *, K=None, sphere_params=None,
                      depth_min=0.0, depth_max=1.0, depth_interval=0.0,
                      num_planes=192) -> None:
    """Write a cam.txt in the converter's format (colmap2mvsnet_acm.py:365-388)."""
    E = np.eye(4)
    E[:3, :3] = np.asarray(R).reshape(3, 3)
    E[:3, 3] = np.asarray(t).reshape(3)
    lines = ["extrinsic"]
    for r in range(4):
        lines.append(" ".join(repr(float(v)) for v in E[r]))
    lines.append("")
    lines.append("intrinsic")
    if camera_model == SPHERE:
        f, cx, cy = sphere_params[:3]
        lines.append("SPHERE")
        lines.append(f"{f} {cx} {cy}")
    else:
        K = np.asarray(K).reshape(3, 3)
        for r in range(3):
            lines.append(" ".join(repr(float(v)) for v in K[r]))
    lines.append("")
    # one depth-line format for all models, matching the reference
    # converter's writer exactly (colmap2mvsnet_acm.py:388); see
    # read_camera_file for the fork's pinhole reader mismatch
    lines.append(f"{depth_min} {depth_interval} {num_planes} {depth_max}")
    Path(path).write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# pair.txt
# ---------------------------------------------------------------------------

def read_pair_file(path) -> list[Problem]:
    """Parse pair.txt into Problems; non-positive scores are dropped
    (reference GenerateSampleList, main.cpp:4-33)."""
    tokens = Path(path).read_text().split()
    it = iter(tokens)
    num_images = int(next(it))
    problems = []
    for _ in range(num_images):
        ref_id = int(next(it))
        num_src = int(next(it))
        src_ids = []
        for _ in range(num_src):
            sid, score = int(next(it)), float(next(it))
            if score > 0.0:
                src_ids.append(sid)
        problems.append(Problem(ref_image_id=ref_id, src_image_ids=src_ids))
    return problems


def write_pair_file(path, neighbors: Sequence[Sequence[tuple[int, float]]]) -> None:
    """``neighbors[i]`` is a ranked list of (src_id, score) for image i
    (colmap2mvsnet_acm.py:390-397)."""
    with open(path, "w") as f:
        f.write(f"{len(neighbors)}\n")
        for i, nbrs in enumerate(neighbors):
            f.write(f"{i}\n{len(nbrs)} ")
            for j, s in nbrs:
                f.write(f"{j} {int(s)} ")
            f.write("\n")


# ---------------------------------------------------------------------------
# scene paths and loading
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenePaths:
    root: Path

    def __init__(self, root):
        self.root = Path(root)

    @property
    def images_dir(self) -> Path:
        return self.root / "images"

    @property
    def cams_dir(self) -> Path:
        return self.root / "cams"

    @property
    def pair_file(self) -> Path:
        return self.root / "pair.txt"

    @property
    def output_dir(self) -> Path:
        return self.root / OUTPUT_SUBDIR

    def image_file(self, image_id: int) -> Path:
        """The view's image: the first of ``IMAGE_EXTS`` that exists, else
        the reference's ``%08d.jpg``."""
        for ext in IMAGE_EXTS:
            path = self.images_dir / f"{image_id:08d}{ext}"
            if path.exists():
                return path
        return self.images_dir / f"{image_id:08d}.jpg"

    def camera_file(self, image_id: int) -> Path:
        return self.cams_dir / f"{image_id:08d}_cam.txt"

    def result_dir(self, image_id: int) -> Path:
        return self.output_dir / RESULT_DIR_FMT.format(image_id)

    def depth_file(self, image_id: int, geom: bool) -> Path:
        name = "depths_geom.dmb" if geom else "depths.dmb"
        return self.result_dir(image_id) / name

    def normal_file(self, image_id: int) -> Path:
        return self.result_dir(image_id) / "normals.dmb"

    def cost_file(self, image_id: int) -> Path:
        return self.result_dir(image_id) / "costs.dmb"

    def ply_file(self) -> Path:
        return self.output_dir / "ACMMP_model.ply"

    def manifest_file(self) -> Path:
        return self.output_dir / "manifest.json"


def load_image_gray(path) -> np.ndarray:
    """Grayscale float32 image in 0..255 (reference ACMMP.cpp:578-580)."""
    if not Path(path).exists():
        raise FileNotFoundError(path)
    return to_gray(read_image(path))


def load_image_color(path) -> np.ndarray:
    """RGB uint8 image (fusion colors)."""
    if not Path(path).exists():
        raise FileNotFoundError(path)
    return to_rgb(read_image(path))


def rescale_to_max_size(image: np.ndarray, max_size: int) -> tuple[np.ndarray, float, float]:
    """Downscale so both sides are <= max_size, preserving aspect
    (reference ACMMP.cpp:605-643).  Returns (image, scale_x, scale_y);
    identity if already small enough."""
    h, w = image.shape[:2]
    if w <= max_size and h <= max_size:
        return image, 1.0, 1.0
    factor = min(max_size / w, max_size / h)
    new_w, new_h = round(w * factor), round(h * factor)
    scaled = resize_bilinear(image, new_h, new_w)
    return scaled, new_w / w, new_h / h


# ---------------------------------------------------------------------------
# resume manifest (SURVEY.md 5.4: make the implicit .dmb checkpointing
# explicit so restarts can skip completed passes)
# ---------------------------------------------------------------------------

def mark_pass_complete(paths: ScenePaths, pass_name: str, image_id: int) -> None:
    mf = paths.manifest_file()
    data = {}
    if mf.exists():
        data = json.loads(mf.read_text())
    data.setdefault(pass_name, [])
    if image_id not in data[pass_name]:
        data[pass_name].append(image_id)
    mf.parent.mkdir(parents=True, exist_ok=True)
    mf.write_text(json.dumps(data))


def is_pass_complete(paths: ScenePaths, pass_name: str, image_id: int) -> bool:
    mf = paths.manifest_file()
    if not mf.exists():
        return False
    data = json.loads(mf.read_text())
    return image_id in data.get(pass_name, [])


def clear_manifest(paths: ScenePaths) -> None:
    mf = paths.manifest_file()
    if mf.exists():
        mf.unlink()
