"""Bordered-matrix outlier split: banded main + flat tail composite."""

import numpy as np
import pytest

from abft_sparse_cg.backends import available, create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import spmv_dense_oracle
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(909)


def bordered(n=2048, dense_rows=(17, 900), spread=300, blocks=1):
    """Tridiagonal core + a few dense rows — the split's target shape."""
    rows, cols, vals, n = spd_tridiagonal(n)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(3)
    for r in dense_rows:
        targets = np.setdiff1d(rng.choice(n, size=spread, replace=False),
                               [r - 1, r, r + 1])
        for c in targets:
            hi, lo = max(r, int(c)), min(r, int(c))
            rows.append(hi)
            cols.append(lo)
            vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, dtype=float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = deg.astype(float)[rows[diag]] + 4.0
    return assemble(cols, rows, vals, n, blocks)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_bordered_selects_split(fmt):
    a = bordered()
    m = build_protected(fmt, a, "secded")
    assert m.exec_kind == "split"
    assert m.main.exec_kind in ("dia", "ell")
    assert m.tail.exec_kind == "flat"
    assert m.main.nnz + m.tail.nnz == a.nnz
    # opt-out falls back to the flat layout
    m2 = build_protected(fmt, a, "secded", split="none")
    assert m2.exec_kind == "flat"


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "sec8", "secded"])
def test_split_spmv_and_solve(fmt, mode):
    a = bordered()
    m = build_protected(fmt, a, mode)
    assert m.exec_kind == "split"
    x = RNG.standard_normal(a.N)
    backend = create("jnp", mode)
    w, errcode, _ = backend.spmv_once(m, x, dtype="f64")
    assert errcode == 0
    np.testing.assert_allclose(w, spmv_dense_oracle(m.main, x)
                               + spmv_dense_oracle(m.tail, x),
                               rtol=1e-11, atol=1e-12)
    b = RNG.random(a.N)
    res = backend.solve(m, b, 3000, 1e-16, verbose=False, dtype="f64")
    assert not res.failed
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    np.testing.assert_allclose(d @ res.x, b, atol=1e-6)


@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_split_fault_events_match_flat(mode):
    """Same injection seed -> identical banners and events whether the
    matrix was built split or flat (global canonical indexing)."""
    a = bordered()
    b = RNG.random(a.N)
    results = {}
    for split in ("auto", "none"):
        m = build_protected("csr", a, mode, split=split)
        for seed in range(4):
            banners = []
            m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                                 echo=banners.append)
            res = create("jnp", mode).solve(m2, b, 2000, 1e-10,
                                            verbose=False, dtype="f64")
            key = (split, seed)
            results[key] = (banners, res.errcode, res.err_index,
                            res.corrected_count, res.messages)
    for seed in range(4):
        assert results[("auto", seed)] == results[("none", seed)], seed


@pytest.mark.parametrize("blocks", [1, 3])
def test_split_tail_dense_fast_path(blocks):
    """The bordered tail's gather-free fast path: dense arrays present
    (block replication multiplies T but spans stay block-confined),
    tail INDEX fault classifies + heals (sel/td re-derived on scrub),
    solution bit-identical to the clean solve."""
    import jax.numpy as jnp

    from abft_sparse_cg.ops.spmv import make_matrix_device

    a = bordered(blocks=blocks)
    m = build_protected("csr", a, "secded")
    assert m.exec_kind == "split"
    assert m.tail.dense_plan is not None
    rows, starts, S = m.tail.dense_plan
    assert len(rows) == 2 * blocks
    md_main, md_tail = make_matrix_device(m, jnp.float32)
    assert md_tail.dense_td is not None
    assert md_tail.dense_td.shape == (len(rows), S)
    assert md_main.dense_td is None

    b = RNG.random(a.N)
    backend = create("jnp", "secded")
    clean = backend.solve(m, b, 2000, 1e-10, verbose=False, dtype="f64")
    # index-region faults into the tail until one actually lands there
    hit = 0
    for seed in range(30):
        m2 = inject_bitflips(m, "INDEX", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        if np.array_equal(m2.tail.planes["col"], m.tail.planes["col"]):
            continue  # fault landed in the main part
        hit += 1
        res = backend.solve(m2, b, 2000, 1e-10, verbose=False,
                            dtype="f64")
        assert not res.failed and res.corrected_count == 1, seed
        np.testing.assert_array_equal(res.x, clean.x, err_msg=str(seed))
        if hit >= 3:
            break
    assert hit >= 1


def test_split_native_backend_agreement():
    """The native backend consumes the composite's GLOBAL planes."""
    if ("cpu", "secded") not in available():
        pytest.skip("native backend unavailable")
    a = bordered()
    m = build_protected("csr", a, "secded")
    assert m.exec_kind == "split"
    b = RNG.random(a.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(2),
                         echo=lambda s: None)
    rj = create("jnp", "secded").solve(m2, b, 2000, 1e-10, verbose=False,
                                       dtype="f64")
    rc = create("cpu", "secded").solve(m2, b, 2000, 1e-10, verbose=False)
    assert rj.errcode == rc.errcode == 0
    assert rj.messages == rc.messages
    assert rj.corrected_count == rc.corrected_count == 1
    # Different summation orders, both converged to rr <= 1e-10: the
    # solutions agree to the convergence-implied slack, not to ulps.
    np.testing.assert_allclose(rj.x, rc.x, rtol=1e-4, atol=1e-7)


def test_split_scrubbed_roundtrip():
    a = bordered()
    m = build_protected("csr", a, "sec8")
    b = RNG.random(a.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(11),
                         echo=lambda s: None)
    res = create("jnp", "sec8").solve(m2, b, 2000, 1e-10, verbose=False,
                                      dtype="f64")
    assert not res.failed and res.corrected_count == 1
    assert res.scrubbed.exec_kind == "split"
    for n in m.layout.word_names:
        assert (res.scrubbed.planes[n] == m.planes[n]).all()
    res2 = create("jnp", "sec8").solve(res.scrubbed, b, 2000, 1e-10,
                                       verbose=False, dtype="f64")
    assert not res2.failed and res2.corrected_count == 0


def test_split_jacobi_preconditioner():
    a = bordered()
    m = build_protected("csr", a, "none")
    b = RNG.random(a.N)
    res = create("jnp", "none").solve(m, b, 3000, 1e-16, verbose=False,
                                      dtype="f64", precond="jacobi")
    assert not res.failed
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    np.testing.assert_allclose(d @ res.x, b, atol=1e-6)


def test_split_pipelined_solver():
    """The composite impl drives the pipelined solver too (fast/classify
    compose through the md tuple)."""
    a = bordered()
    m = build_protected("csr", a, "secded")
    b = RNG.random(a.N)
    backend = create("jnp", "secded")
    std = backend.solve(m, b, 3000, 1e-12, verbose=False, dtype="f64")
    pip = backend.solve(m, b, 3000, 1e-12, verbose=False, dtype="f64",
                        solver="pipelined")
    assert not pip.failed
    assert abs(pip.iterations - std.iterations) <= 1
    np.testing.assert_allclose(pip.x, std.x, rtol=1e-5, atol=1e-9)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(4),
                         echo=lambda s: None)
    res = backend.solve(m2, b, 3000, 1e-12, verbose=False, dtype="f64",
                        solver="pipelined")
    assert not res.failed and res.corrected_count == 1


def _tail_like(entries, n=1024):
    """Build a tail-shaped flat ProtectedMatrix from explicit (row, col)
    entries WITHOUT the loader's symmetrization (coverage tests)."""
    from abft_sparse_cg.formats.loader import AssembledMatrix

    rows = np.array([r for r, _ in entries], dtype=np.int64)
    cols = np.array([c for _, c in entries], dtype=np.int64)
    order = np.lexsort((cols, rows))
    a = AssembledMatrix(
        cols=cols[order].astype(np.uint32),
        rows=rows[order].astype(np.uint32),
        values=np.ones(len(entries), dtype=np.float64),
        N=n, nnz=len(entries), block_size=n, num_blocks=1,
    )
    m = build_protected("csr", a, "secded", reorder="none", split="none")
    assert m.exec_kind == "flat"
    return m


def test_dense_tail_plan_requires_window_coverage():
    """dense_tail_plan verifies on the host that every tail entry lands
    inside its outlier's span window; a structurally non-symmetric
    assembly (an entry whose mirror is missing) would otherwise be
    silently dropped by the device-side densify with no detection
    signal."""
    from abft_sparse_cg.ops.spmv import dense_tail_plan

    out = 3
    sym = [(out, c) for c in range(10)] + [(c, out) for c in range(10)
                                           if c != out]
    plan = dense_tail_plan(_tail_like(sym), [out])
    assert plan is not None

    # Mirror-less far entry: gather source is the outlier, but its
    # output row (900) is outside the outlier's span window.
    plan = dense_tail_plan(_tail_like(sym + [(900, out)]), [out])
    assert plan is None

    # The symmetric counterpart widens the span instead: covered again.
    plan = dense_tail_plan(_tail_like(sym + [(900, out), (out, 900)]),
                           [out])
    assert plan is not None
