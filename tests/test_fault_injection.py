"""Failure-handling and multi-host protocol tests (SURVEY.md 5.3 / 5.8).

The reference aborts the whole run on any per-image failure and exchanges
inter-pass data purely through files (ACMMP.cpp:653-678); our pipeline adds
retry-then-skip per problem (pipeline/multiscale.py) and a cross-host barrier
between passes.  These tests inject faults into ``process_problem`` and
simulate a 2-host run with concurrent threads whose patched
``sync_global_devices`` is a real ``threading.Barrier`` -- the same
file-exchange + barrier protocol the CLI's ``--distributed`` mode runs, minus
the network transport.
"""

import dataclasses
import threading

import numpy as np
import pytest

import acmmp_spherical_tpu.pipeline.multiscale as ms
from acmmp_spherical_tpu.config import PipelineConfig
from acmmp_spherical_tpu.core.camera import PINHOLE
from acmmp_spherical_tpu.io import read_ply
from acmmp_spherical_tpu.io.scene import ScenePaths
from acmmp_spherical_tpu.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene, write_synthetic_scene_to_disk,
)

W, H, N_VIEWS = 48, 36, 4


def _make_scene(root):
    scene = CubeRoom()
    cams = make_ring_of_cameras(N_VIEWS, model=PINHOLE, width=W, height=H,
                                focal=42.0)
    images, depths, normals = render_scene(cams, scene, W, H)
    return write_synthetic_scene_to_disk(root / "dense", cams, images)


def _small_cfg(**kw):
    return dataclasses.replace(
        PipelineConfig(), geom_iterations=1, batch_problems="off", **kw
    )


@pytest.mark.slow
def test_transient_failure_retried(tmp_path, monkeypatch):
    """One transient device failure costs one pass re-run, not the view
    (pipeline/multiscale.py per-problem retry)."""
    _make_scene(tmp_path)
    root = tmp_path / "dense"

    real = ms.process_problem
    fails = {"n": 0}

    def flaky(sp, problems, idx, cfg, **kw):
        if problems[idx].ref_image_id == 1 and fails["n"] == 0:
            fails["n"] += 1
            raise RuntimeError("injected transient device failure")
        return real(sp, problems, idx, cfg, **kw)

    monkeypatch.setattr(ms, "process_problem", flaky)
    result = ms.run_pipeline(root, _small_cfg())
    n_points = result.n_points
    assert result.skipped == []
    assert fails["n"] == 1  # the fault fired
    assert n_points > 500
    sp = ScenePaths(root)
    for i in range(N_VIEWS):  # the flaky view recovered: full outputs exist
        assert sp.depth_file(i, geom=True).exists()
        assert sp.normal_file(i).exists()


@pytest.mark.slow
def test_persistent_failure_skips_view(tmp_path, monkeypatch):
    """A view that fails every attempt is skipped and reported; the pipeline
    completes and fusion tolerates the missing inputs (reference behaviour:
    abort)."""
    _make_scene(tmp_path)
    root = tmp_path / "dense"

    real = ms.process_problem

    def broken(sp, problems, idx, cfg, **kw):
        if problems[idx].ref_image_id == 2:
            raise RuntimeError("injected persistent failure")
        return real(sp, problems, idx, cfg, **kw)

    monkeypatch.setattr(ms, "process_problem", broken)
    result = ms.run_pipeline(root, _small_cfg())
    assert ("photometric_s0", 2) in result.skipped
    n_points = result.n_points
    assert n_points > 300  # the other views still fuse
    sp = ScenePaths(root)
    assert not sp.depth_file(2, geom=True).exists()
    for i in (0, 1, 3):
        assert sp.depth_file(i, geom=True).exists()


@pytest.mark.slow
def test_two_host_run_exchanges_via_files(tmp_path, monkeypatch):
    """Two concurrent 'hosts' (threads), round-robin problem shards, a real
    barrier standing in for sync_global_devices: geometric passes on each host
    consume the OTHER host's photometric .dmb outputs, and only host 0 fuses.

    This exercises exactly the protocol of run_pipeline's multi-host mode
    (host sharding, inter-pass barrier, file-layer exchange); only the
    barrier transport differs from a real jax.distributed run.
    """
    import jax

    _make_scene(tmp_path)
    root = tmp_path / "dense"

    barrier = threading.Barrier(2, timeout=600)
    local = threading.local()

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: local.proc)

    from jax.experimental import multihost_utils

    barrier_names = []

    def fake_sync(name=""):
        barrier_names.append((local.proc, name))
        barrier.wait()

    monkeypatch.setattr(multihost_utils, "sync_global_devices", fake_sync)

    # record which host ran which problem
    real = ms.process_problem
    ran = []
    lock = threading.Lock()

    def traced(sp, problems, idx, cfg, **kw):
        with lock:
            ran.append((local.proc, problems[idx].ref_image_id, kw.get("geom")))
        return real(sp, problems, idx, cfg, **kw)

    monkeypatch.setattr(ms, "process_problem", traced)

    results = {}

    def host(proc):
        local.proc = proc
        try:
            results[proc] = ms.run_pipeline(root, _small_cfg()).n_points
        except Exception as e:  # surface thread failures in the main thread
            results[proc] = e

    t0 = threading.Thread(target=host, args=(0,))
    t1 = threading.Thread(target=host, args=(1,))
    t0.start(); t1.start(); t0.join(); t1.join()

    for proc in (0, 1):
        assert not isinstance(results[proc], Exception), results[proc]

    # host sharding: round-robin by problem index, disjoint and complete
    by_host = {p: {img for pr, img, _ in ran if pr == p} for p in (0, 1)}
    assert by_host[0] & by_host[1] == set()
    assert by_host[0] | by_host[1] == set(range(N_VIEWS))

    # geometric passes ran strictly after BOTH hosts' photometric pass
    # (barrier semantics): every geom entry appears after every photo entry
    first_geom = min(i for i, (_, _, g) in enumerate(ran) if g)
    last_photo = max(i for i, (_, _, g) in enumerate(ran) if not g)
    assert first_geom > last_photo

    # only host 0 fused; the cloud covers all views' geometry
    assert results[0] > 500
    assert results[1] == 0
    sp = ScenePaths(root)
    pts, _, _ = read_ply(sp.ply_file())
    assert len(pts) == results[0]
    # every barrier name was hit by both hosts the same number of times
    from collections import Counter

    c = Counter(name for _, name in barrier_names)
    per_host = Counter((p, name) for p, name in barrier_names)
    for name, cnt in c.items():
        assert per_host[(0, name)] == per_host[(1, name)], name
