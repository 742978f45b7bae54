"""Pipelined CG (Ghysels-Vanroose) vs the standard solver."""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.utils.matgen import spd_laplacian_2d, spd_tridiagonal

RNG = np.random.default_rng(404)


def protected(mode="none", n=96, blocks=3, fmt="csr"):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    return build_protected(fmt, a, mode)


def dense_of(m, a):
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    return d


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec8", "secded"])
def test_pipelined_matches_standard(fmt, mode):
    m = protected(mode, fmt=fmt)
    b = RNG.random(m.N)
    backend = create("jnp", mode)
    std = backend.solve(m, b, 500, 1e-12, verbose=False, dtype="f64")
    pip = backend.solve(m, b, 500, 1e-12, verbose=False, dtype="f64",
                        solver="pipelined")
    assert not std.failed and not pip.failed
    # Same Krylov process in exact arithmetic: identical counts (allow
    # one extra iteration for recurrence rounding near the threshold).
    assert abs(pip.iterations - std.iterations) <= 1
    np.testing.assert_allclose(pip.x, std.x, rtol=1e-8, atol=1e-12)
    # Residual trajectories match to rounding over the shared prefix.
    k = min(std.iterations, pip.iterations) - 1
    np.testing.assert_allclose(pip.rr_trace[:k], std.rr_trace[:k],
                               rtol=1e-6)


def test_pipelined_solves_laplacian():
    lap = spd_laplacian_2d(14)
    a = assemble(lap[1], lap[0], lap[2], lap[3], 2)
    m = build_protected("csr", a, "secded")
    b = RNG.random(m.N)
    res = create("jnp", "secded").solve(m, b, 2000, 1e-16, verbose=False,
                                        dtype="f64", solver="pipelined")
    assert not res.failed
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    np.testing.assert_allclose(d @ res.x, b, atol=1e-6)


def test_pipelined_corrects_injected_fault():
    """Trigger -> classify -> recurrence restart -> exact recovery."""
    m = protected("secded")
    b = RNG.random(m.N)
    backend = create("jnp", "secded")
    clean = backend.solve(m, b, 500, 1e-10, verbose=False, dtype="f64",
                          solver="pipelined")
    assert not clean.failed and clean.corrected_count == 0
    for seed in range(4):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        res = backend.solve(m2, b, 500, 1e-10, verbose=False, dtype="f64",
                            solver="pipelined")
        assert not res.failed, seed
        assert res.corrected_count == 1, seed
        # The fault is repaired before any update consumes it, so the
        # solve equals the clean one exactly.
        np.testing.assert_allclose(res.x, clean.x, rtol=1e-12)
        assert res.iterations == clean.iterations


def test_pipelined_sed_detects_and_halts():
    m = protected("sed")
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(1),
                         echo=lambda s: None)
    res = create("jnp", "sed").solve(m2, b, 500, 1e-10, verbose=False,
                                     dtype="f64", solver="pipelined")
    assert res.failed and res.errcode == 1
    assert any("error detected at index" in s for s in res.messages)


def test_pipelined_breakdown_guard():
    from abft_sparse_cg.ops.spmv import ERR_BREAKDOWN

    n = 32
    idx = np.arange(n)
    a = assemble(idx, idx, -np.ones(n), n, 1)  # A = -I
    m = build_protected("csr", a, "none")
    b = RNG.random(n)
    res = create("jnp", "none").solve(m, b, 100, 1e-10, verbose=False,
                                      dtype="f64", solver="pipelined")
    assert res.failed and res.errcode == ERR_BREAKDOWN


def test_pipelined_sharded_matches():
    """Single reduction point under GSPMD: one fused psum per iteration."""
    m = protected("secded", n=64, blocks=4)
    b = RNG.random(m.N)
    backend = create("jnp", "secded")
    single = backend.solve(m, b, 300, 1e-10, verbose=False, dtype="f64",
                           solver="pipelined")
    shard = backend.solve(m, b, 300, 1e-10, verbose=False, dtype="f64",
                          solver="pipelined", devices=8)
    assert not shard.failed
    assert shard.iterations == single.iterations
    np.testing.assert_allclose(shard.x, single.x, rtol=1e-12)


def test_pipelined_rejects_preconditioner():
    m = protected("none", n=32, blocks=1)
    b = RNG.random(m.N)
    with pytest.raises(ValueError):
        create("jnp", "none").solve(m, b, 100, 1e-8, verbose=False,
                                    dtype="f64", solver="pipelined",
                                    precond="jacobi")
