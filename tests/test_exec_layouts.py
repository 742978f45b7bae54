"""ELL vs DIA execution layouts: same semantics, different kernels."""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import spmv_dense_oracle
from abft_sparse_cg.utils.matgen import spd_laplacian_2d, spd_tridiagonal

RNG = np.random.default_rng(777)


def random_spd_assembled(n=80, density=0.05, blocks=2):
    """Unstructured SPD: random sparsity -> many diagonals -> ELL chosen."""
    rng = np.random.default_rng(42)
    m = int(n * n * density)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    keep = rows > cols
    rows, cols = rows[keep], cols[keep]
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)
    rows, cols = pairs[:, 0], pairs[:, 1]
    vals = -rng.random(len(rows))
    # Diagonal dominance -> SPD.
    drows = np.arange(n)
    dvals = np.full(n, float(len(rows)) * 2.0 / n + 4.0)
    rows = np.concatenate([drows, rows])
    cols = np.concatenate([drows, cols])
    vals = np.concatenate([dvals, vals])
    return assemble(cols, rows, vals, n, blocks)


def test_auto_selection():
    tri = spd_tridiagonal(64)
    a = assemble(tri[1], tri[0], tri[2], tri[3], 2)
    assert build_protected("csr", a, "none").exec_kind == "dia"

    lap = spd_laplacian_2d(16)
    a2 = assemble(lap[1], lap[0], lap[2], lap[3], 2)
    assert build_protected("csr", a2, "none").exec_kind == "dia"

    a3 = random_spd_assembled()
    assert build_protected("csr", a3, "none").exec_kind == "ell"


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "constraints", "sed", "sec7", "sec8", "secded"])
def test_dia_vs_ell_spmv_identical(fmt, mode):
    lap = spd_laplacian_2d(12)
    a = assemble(lap[1], lap[0], lap[2], lap[3], 2)
    m_dia = build_protected(fmt, a, mode, force_exec="dia")
    m_ell = build_protected(fmt, a, mode, force_exec="ell")
    assert m_dia.exec_kind == "dia" and m_ell.exec_kind == "ell"
    x = RNG.standard_normal(a.N)
    backend = create("jnp", mode)
    w_dia, e1, _ = backend.spmv_once(m_dia, x, dtype="f64")
    w_ell, e2, _ = backend.spmv_once(m_ell, x, dtype="f64")
    assert e1 == e2 == 0
    np.testing.assert_allclose(w_dia, w_ell, rtol=1e-13)
    np.testing.assert_allclose(w_dia, spmv_dense_oracle(m_dia, x), rtol=1e-12)


@pytest.mark.parametrize("mode", ["sed", "sec8", "secded"])
def test_dia_abft_events_match_ell(mode):
    """Same injected fault -> same detection/correction on both layouts."""
    lap = spd_laplacian_2d(10)
    a = assemble(lap[1], lap[0], lap[2], lap[3], 2)
    backend = create("jnp", mode)
    b = RNG.random(a.N)
    for seed in range(4):
        events = {}
        for kind in ("dia", "ell"):
            m = build_protected("csr", a, mode, force_exec=kind)
            m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                                 echo=lambda s: None)
            res = backend.solve(m2, b, 300, 1e-8, verbose=False, dtype="f64")
            events[kind] = (res.errcode, res.err_index, res.messages,
                            res.corrected_count > 0)
        assert events["dia"] == events["ell"], f"seed {seed}: {events}"


def test_ell_unstructured_solver():
    a = random_spd_assembled()
    m = build_protected("csr", a, "secded")
    b = RNG.random(a.N)
    res = create("jnp", "secded").solve(m, b, 2000, 1e-14, verbose=False,
                                        dtype="f64")
    assert not res.failed
    dense = np.zeros((a.N, a.N))
    dense[a.rows, a.cols] = a.values
    np.testing.assert_allclose(dense @ res.x, b, atol=1e-5)
