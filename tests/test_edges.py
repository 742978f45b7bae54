"""Edge cases: degenerate sizes, paddings, and boundary inputs."""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.ops.spmv import spmv_dense_oracle
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(777)


def test_single_row_matrix():
    a = assemble(np.array([0]), np.array([0]), np.array([2.0]), 1, 1)
    for mode in ("none", "secded"):
        m = build_protected("csr", a, mode)
        res = create("jnp", mode).solve(m, np.array([3.0]), 50, 1e-12,
                                        verbose=False, dtype="f64")
        assert not res.failed
        np.testing.assert_allclose(res.x, [1.5], rtol=1e-12)


def test_tiny_matrix_all_modes_all_layouts():
    rows, cols, vals, n = spd_tridiagonal(5)
    a = assemble(cols, rows, vals, n, 1)
    b = RNG.random(n)
    for mode in ("none", "constraints", "sed", "sec7", "sec8", "secded"):
        for force in (None, "ell"):
            m = build_protected("csr", a, mode, force_exec=force)
            res = create("jnp", mode).solve(m, b, 100, 1e-14, verbose=False,
                                            dtype="f64")
            assert not res.failed, (mode, force)
            w, e, _ = create("jnp", mode).spmv_once(m, b, dtype="f64")
            assert e == 0
            np.testing.assert_allclose(w, spmv_dense_oracle(m, b),
                                       rtol=1e-12)


def test_unknown_mode_and_format_raise():
    rows, cols, vals, n = spd_tridiagonal(8)
    a = assemble(cols, rows, vals, n, 1)
    with pytest.raises(ValueError):
        build_protected("csr", a, "bogus")
    with pytest.raises(ValueError):
        build_protected("bsr", a, "none")
    # force_exec=dia on an un-bandable matrix raises.
    ridx = np.array([0, 5, 7, 1, 6, 2, 3, 4])
    m = int(ridx.max()) + 1
    rr = np.concatenate([np.arange(m), np.array([7, 6])])
    cc = np.concatenate([np.arange(m), np.array([0, 2])])
    vv = np.concatenate([np.full(m, 4.0), np.array([-1.0, -1.0])])
    a2 = assemble(cc, rr, vv, m, 1)
    a2 = assemble(cc, rr, vv, m, 12)  # many blocks: many diagonals
    with pytest.raises(ValueError):
        build_protected("csr", a2, "none", force_exec="dia",
                        reorder="none")


def test_ecc_mode_size_limit():
    """N > 2^24 must be rejected for ECC modes (col-word high byte)."""
    from abft_sparse_cg.formats.loader import AssembledMatrix

    n = (1 << 24) + 8
    # One diagonal entry only — huge N, tiny nnz (no dense allocation).
    a = AssembledMatrix(
        rows=np.array([0], dtype=np.int64),
        cols=np.array([0], dtype=np.int64),
        values=np.array([1.0]),
        N=n, nnz=1, block_size=n, num_blocks=1,
    )
    with pytest.raises(ValueError):
        build_protected("csr", a, "secded")
    # ...but mode none is fine with big N (no ECC byte needed).
    m = build_protected("csr", a, "none")
    assert m.N == n


def test_b_zero_converges_immediately():
    rows, cols, vals, n = spd_tridiagonal(16)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded")
    res = create("jnp", "secded").solve(m, np.zeros(n), 100, 1e-12,
                                        verbose=False, dtype="f64")
    assert not res.failed
    assert res.iterations == 0
    np.testing.assert_array_equal(res.x, np.zeros(n))
