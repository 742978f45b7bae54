"""FLAT exec layout: the memory-safe path for bordered matrices (a few
dense rows would explode the ELL padding to K*R; the reference's CSR
storage is proportional to nnz and handles them fine — so must we)."""

import numpy as np
import pytest

from abft_sparse_cg.backends import available, create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import spmv_dense_oracle
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(606)


def bordered(n=512, dense_rows=(3, 200), blocks=1):
    """Tridiagonal + a few dense rows (boundary-condition style)."""
    rows, cols, vals, n = spd_tridiagonal(n)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(5)
    for r in dense_rows:
        targets = np.setdiff1d(rng.choice(n, size=n // 2, replace=False),
                               [r - 1, r, r + 1])
        for c in targets:
            hi, lo = max(r, int(c)), min(r, int(c))
            rows.append(hi)
            cols.append(lo)
            vals.append(-0.01)
    rows = np.array(rows)
    cols = np.array(cols)
    vals = np.array(vals, dtype=float)
    # restore diagonal dominance
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = deg.astype(float)[rows[diag]] + 4.0
    return assemble(cols, rows, vals, n, blocks)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_bordered_matrix_selects_split_with_dense_tail(fmt):
    """Round 4: this bordered shape (2 dense rows carrying ~half of
    nnz) now earns the bordered SPLIT with the span-window dense-tail
    plan (formats.split._MAX_TAIL_FRAC_DENSE) — it used to fall to the
    whole-matrix flat layout.  The flat layout itself stays reachable
    (and is what the rest of this file exercises) via split="none"."""
    a = bordered()
    m = build_protected(fmt, a, "secded")
    assert m.exec_kind == "split"
    assert m.tail.dense_plan is not None

    mf = build_protected(fmt, a, "secded", split="none")
    assert mf.exec_kind == "flat"
    # Memory proportional to nnz, not K*R.
    assert mf.exec_size < 2 * a.nnz + 16


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "constraints", "sed", "sec7",
                                  "sec8", "secded"])
def test_flat_spmv_and_solve(fmt, mode):
    a = bordered()
    m = build_protected(fmt, a, mode, split="none")
    assert m.exec_kind == "flat"
    x = RNG.standard_normal(a.N)
    backend = create("jnp", mode)
    w, errcode, _ = backend.spmv_once(m, x, dtype="f64")
    assert errcode == 0
    np.testing.assert_allclose(w, spmv_dense_oracle(m, x), rtol=1e-11,
                               atol=1e-12)
    b = RNG.random(a.N)
    res = backend.solve(m, b, 3000, 1e-16, verbose=False, dtype="f64")
    assert not res.failed
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    np.testing.assert_allclose(d @ res.x, b, atol=1e-6)


@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_flat_fault_events(mode):
    a = bordered()
    m = build_protected("csr", a, mode, split="none")
    b = RNG.random(a.N)
    backend = create("jnp", mode)
    clean = backend.solve(m, b, 2000, 1e-10, verbose=False, dtype="f64")
    assert not clean.failed
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        res = backend.solve(m2, b, 2000, 1e-10, verbose=False, dtype="f64")
        if mode == "sed":
            assert res.failed and res.errcode == 1
            assert any("error detected at index" in s for s in res.messages)
        else:
            assert not res.failed and res.corrected_count == 1
            np.testing.assert_allclose(res.x, clean.x, rtol=1e-12)
        if ("cpu", mode) in available():
            rc = create("cpu", mode).solve(m2, b, 2000, 1e-10,
                                           verbose=False)
            assert rc.errcode == res.errcode
            assert rc.messages == res.messages


def test_flat_constraints_catch_corruption():
    a = bordered()
    m = build_protected("csr", a, "constraints", split="none")
    assert m.exec_kind == "flat"
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][10] |= np.uint32(1 << 23)  # out of range
    m2 = m.with_planes(planes)
    b = RNG.random(a.N)
    res = create("jnp", "constraints").solve(m2, b, 200, 1e-8,
                                             verbose=False, dtype="f64")
    assert res.failed
    assert any("column size constraint violated" in s for s in res.messages)


def test_flat_scrubbed_roundtrip():
    a = bordered()
    m = build_protected("csr", a, "sec8", split="none")
    b = RNG.random(a.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(9),
                         echo=lambda s: None)
    res = create("jnp", "sec8").solve(m2, b, 2000, 1e-10, verbose=False,
                                      dtype="f64")
    assert not res.failed and res.corrected_count == 1
    for n in m.layout.word_names:
        assert (res.scrubbed.planes[n] == m.planes[n]).all()


@pytest.mark.parametrize("mode", ["none", "secded"])
def test_flat_sharded_matches_single(mode):
    """Entry-sharded flat planes over the 8-device mesh: same solution
    and (mode secded) the same fault events as the single-device solve."""
    a = bordered()
    m = build_protected("csr", a, mode, split="none")
    assert m.exec_kind == "flat"
    b = RNG.random(a.N)
    backend = create("jnp", mode)
    single = backend.solve(m, b, 2000, 1e-10, verbose=False, dtype="f64")
    shard = backend.solve(m, b, 2000, 1e-10, verbose=False, dtype="f64",
                          devices=8)
    assert not shard.failed
    assert abs(shard.iterations - single.iterations) <= 1  # psum order
    np.testing.assert_allclose(shard.x, single.x, rtol=1e-4, atol=1e-7)
    if mode == "secded":
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(7),
                             echo=lambda s: None)
        s1 = backend.solve(m2, b, 2000, 1e-10, verbose=False, dtype="f64")
        s8 = backend.solve(m2, b, 2000, 1e-10, verbose=False, dtype="f64",
                           devices=8)
        assert s8.errcode == s1.errcode == 0
        assert s8.corrected_count == s1.corrected_count == 1
        assert s8.messages == s1.messages
