"""Runtime setup and the GPU smoke script's pure parts, on the CPU.

- utils.platform: the persistent compile cache lands where
  JAX_COMPILATION_CACHE_DIR says, or at the fixed in-checkout path that
  .gitignore lists;
- backends.base.default_dtype: binary64 is accepted on any device;
- chip_smoke.py: its result line, norms, host CG oracle, CLI driver and
  its refusal to run without a GPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from abft_sparse_cg.utils import platform  # noqa: E402


@pytest.fixture
def cache_config():
    """Restore JAX's cache setting after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_env_is_left_to_jax(monkeypatch, cache_config,
                                           tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    assert platform.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_cache_dir_default_is_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = platform.configure_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert os.path.isdir(got)
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_cache_dir_lands_there_for_the_cli(tmp_path):
    """A CLI run with JAX_COMPILATION_CACHE_DIR set writes its compiled
    solve into that directory."""
    from abft_sparse_cg.utils.matgen import (spd_tridiagonal,
                                             write_mm_triangle)

    mtx = str(tmp_path / "m.mtx")
    write_mm_triangle(mtx, *spd_tridiagonal(64))
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "cg-csr"), "-f", mtx,
         "-b", "2", "-t", "jnp", "-m", "secded", "--quiet"],
        capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert cache.is_dir() and any(cache.iterdir())


@pytest.mark.parametrize("platform_name", ["gpu", "cpu"])
def test_f64_accepted_on_any_device(monkeypatch, platform_name):
    import jax.numpy as jnp

    from abft_sparse_cg.backends import base

    class Dev:
        platform = platform_name

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert base.default_dtype("f64") == jnp.float64
    assert base.default_dtype("f32") == jnp.float32
    want = jnp.float64 if platform_name == "cpu" else jnp.float32
    assert base.default_dtype("auto") == want


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_rel_inf():
    a = np.array([1.0, 2.0, -4.0])
    assert chip_smoke.rel_inf(a, a) == 0.0
    assert chip_smoke.rel_inf(a + [0, 0, 4e-6], a) == pytest.approx(1e-6)


def test_host_cg_matches_jnp_f64_solve():
    """The host f64 oracle takes the reference's iteration: the jnp
    target's f64 solve follows it iteration for iteration."""
    from abft_sparse_cg.backends import create
    from abft_sparse_cg.formats import assemble, build_protected
    from abft_sparse_cg.utils.matgen import spd_laplacian_2d

    rows, cols, vals, n = spd_laplacian_2d(24)
    a = assemble(cols, rows, vals, n, 1)
    b = np.random.default_rng(0).random(n)
    x, itr, trace = chip_smoke.host_cg(chip_smoke.csr_of(a), b, 500, 1e-10)
    assert trace[-1] <= 1e-10 and len(trace) == itr
    assert chip_smoke.true_rr(a, x, b) <= 1e-9
    res = create("jnp", "none").solve(build_protected("csr", a, "none"), b,
                                      500, 1e-10, verbose=False,
                                      dtype="f64")
    assert res.iterations == itr
    np.testing.assert_allclose(res.rr_trace[:itr], trace, rtol=1e-9)


def test_run_cli_captures_exit_and_output(tmp_path):
    from abft_sparse_cg.utils.matgen import (spd_tridiagonal,
                                             write_mm_triangle)

    mtx = str(tmp_path / "m.mtx")
    write_mm_triangle(mtx, *spd_tridiagonal(64))
    code, out = chip_smoke.run_cli(["-f", mtx, "-b", "2", "-t", "jnp",
                                    "-m", "sed", "-x", "--seed", "1",
                                    "--quiet"])
    assert code == 1 and "[ECC] error detected" in out
    code, out = chip_smoke.run_cli(["-f", mtx, "-b", "2", "-t", "pallas",
                                    "-m", "secded", "--quiet"])
    assert code == 0 and chip_smoke.iterations_of(out) > 0
    assert "spmv route = xla-live" in out


def test_chip_smoke_refuses_without_gpu():
    """On a machine with no GPU the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_without_the_program(tmp_path):
    """Alone in a directory, the script cannot import the solver and
    exits non-zero without a result line."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
