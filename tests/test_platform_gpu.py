"""What the GPU bring-up guarantees on any host: no TPU code path, no silent
fallback, a compile cache inside the checkout, the native library built from
source, and the smoke script refusing the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "acmmp_spherical_tpu"


def test_no_package_file_targets_a_tpu():
    bad = re.compile(r"pallas\.tpu|pallas import tpu|pltpu|"
                     r"""default_backend\(\)\s*[!=]=\s*["']tpu["']|"""
                     r"""["']tpu["']\s*[!=]=""")
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in sorted(PACKAGE.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if bad.search(line)]
    assert hits == []


def test_compile_cache_inside_checkout(monkeypatch):
    import jax

    from acmmp_spherical_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = Path(compile_cache.enable_compile_cache())
        assert path == REPO / ".jax_cache" and path.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    import jax

    from acmmp_spherical_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_native_library_builds_from_source(tmp_path):
    import ctypes

    from acmmp_spherical_tpu.io import native

    target = tmp_path / "libacmmp_native.so"
    try:
        native.build(target)
    except FileNotFoundError:
        pytest.skip("no C++ compiler on this host")
    lib = ctypes.CDLL(str(target))
    assert hasattr(lib, "resize_bilinear_f32")
    assert "native/libacmmp_native.so" in (REPO / ".gitignore").read_text()
    assert native._LIB_PATH == REPO / "native" / "libacmmp_native.so"


def test_chip_smoke_refuses_the_cpu(capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.check_device()
    assert exc.value.code == 2
    assert "needs a GPU" in capsys.readouterr().err


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into an empty directory the script exits non-zero and prints
    no result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_cli_platform_choices():
    from acmmp_spherical_tpu.pipeline.cli import main

    with pytest.raises(SystemExit):
        main(["reconstruct", "x", "--platform", "tpu"])


def test_cli_platform_mismatch_raises():
    """``--platform gpu`` in a process already on the CPU raises instead of
    running on the CPU."""
    import jax

    from acmmp_spherical_tpu.pipeline.cli import _set_platform

    jax.devices()                     # the backend is up (conftest: CPU)
    before = jax.config.jax_platforms
    try:
        with pytest.raises(RuntimeError, match="runs on 'cpu'"):
            _set_platform("gpu")
    finally:
        jax.config.update("jax_platforms", before)


def test_reconstruct_exits_nonzero_when_a_view_was_skipped(monkeypatch):
    from acmmp_spherical_tpu.pipeline import cli, multiscale
    from acmmp_spherical_tpu.utils import compile_cache
    from acmmp_spherical_tpu.utils.log import Timings

    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "")

    def fake(root, cfg):
        return multiscale.PipelineResult(
            n_points=1000, skipped=[("geom0_s0", 3)], timings=Timings())

    monkeypatch.setattr(multiscale, "run_pipeline", fake)
    assert cli.main(["reconstruct", "scene", "--platform", "cpu"]) == 1
    monkeypatch.setattr(multiscale, "run_pipeline",
                        lambda root, cfg: multiscale.PipelineResult(
                            n_points=1000, skipped=[], timings=Timings()))
    assert cli.main(["reconstruct", "scene", "--platform", "cpu"]) == 0
