"""SpMV + CG solver correctness against NumPy oracles, all modes/formats."""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import (
    ERR_DOUBLE,
    ERR_SED,
    spmv_dense_oracle,
)
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(2024)


def tri_assembled(n=64, blocks=2):
    rows, cols, vals, n = spd_tridiagonal(n)
    return assemble(cols, rows, vals, n, blocks)


def dense_of(a):
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    return d


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "constraints", "sed", "sec7", "sec8", "secded"])
def test_spmv_matches_oracle(fmt, mode):
    a = tri_assembled()
    m = build_protected(fmt, a, mode)
    x = RNG.standard_normal(m.N)
    backend = create("jnp", mode)
    w, errcode, msgs = backend.spmv_once(m, x, dtype="f64")
    want = spmv_dense_oracle(m, x)
    assert errcode == 0 and not msgs
    np.testing.assert_allclose(w, want, rtol=1e-12)
    # Also against the dense assembled matrix.
    np.testing.assert_allclose(w, dense_of(a) @ x, rtol=1e-12)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_cg_solves_vs_direct(fmt):
    a = tri_assembled(n=48, blocks=3)
    m = build_protected(fmt, a, "none")
    b = RNG.random(m.N)
    backend = create("jnp", "none")
    res = backend.solve(m, b, max_itrs=1000, conv_threshold=1e-18,
                        verbose=False, dtype="f64")
    assert not res.failed
    x_direct = np.linalg.solve(dense_of(a), b)
    # conv is on rr = ||r||^2, so ||r|| <= 1e-9 and x error ~ ||A^-1|| * 1e-9.
    np.testing.assert_allclose(res.x, x_direct, rtol=1e-7, atol=1e-9)
    assert res.rr <= 1e-18
    assert res.iterations > 1


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["sec7", "sec8", "secded"])
def test_correction_modes_survive_injection(fmt, mode):
    """run_tests class 3: solve converges despite a flipped bit, and the
    answer matches the uncorrupted solve exactly."""
    a = tri_assembled(n=48, blocks=2)
    m = build_protected(fmt, a, mode)
    b = RNG.random(m.N)
    backend = create("jnp", mode)

    clean = backend.solve(m, b, 1000, 1e-10, verbose=False, dtype="f64")
    assert not clean.failed and clean.corrected_count == 0

    for seed in range(5):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        res = backend.solve(m2, b, 1000, 1e-10, verbose=False, dtype="f64")
        assert not res.failed
        assert res.corrected_count > 0
        assert any(m.startswith("[ECC] corrected") for m in res.messages)
        np.testing.assert_allclose(res.x, clean.x, rtol=1e-12)
        # Residual trajectory identical to the clean solve (correction is
        # exact, so the iterates never see the fault).
        np.testing.assert_allclose(res.rr_trace, clean.rr_trace,
                                   rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_sed_detects_and_halts(fmt):
    """run_tests class 2: sed + 1 flip -> 'error detected at index'."""
    a = tri_assembled(n=48, blocks=2)
    m = build_protected(fmt, a, "sed")
    b = RNG.random(m.N)
    backend = create("jnp", "sed")
    banners = []
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(3), echo=banners.append)
    res = backend.solve(m2, b, 1000, 1e-10, verbose=False, dtype="f64")
    assert res.failed and res.errcode == ERR_SED
    assert any("error detected at index" in s for s in res.messages)
    # Detected index equals injected index.
    inj_index = int(banners[0].split()[-2])
    assert res.err_index == inj_index


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_secded_detects_double(fmt):
    """run_tests class 4: secded + 2 flips -> 'double-bit error detected'."""
    a = tri_assembled(n=48, blocks=2)
    m = build_protected(fmt, a, "secded")
    b = RNG.random(m.N)
    backend = create("jnp", "secded")
    # Find a seed where the two flips do not cancel.
    for seed in range(20):
        rng = np.random.default_rng(seed)
        m2 = inject_bitflips(m, "ANY", 2, rng, echo=lambda s: None)
        if any((m2.planes[n] != m.planes[n]).any() for n in m.layout.word_names):
            break
    res = backend.solve(m2, b, 1000, 1e-10, verbose=False, dtype="f64")
    assert res.failed and res.errcode == ERR_DOUBLE
    assert "[ECC] double-bit error detected" in res.messages


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_constraints_clean_pass(fmt):
    a = tri_assembled(n=32, blocks=2)
    m = build_protected(fmt, a, "constraints")
    b = RNG.random(m.N)
    backend = create("jnp", "constraints")
    res = backend.solve(m, b, 500, 1e-8, verbose=False, dtype="f64")
    assert not res.failed


def test_constraints_catch_index_corruption():
    a = tri_assembled(n=32, blocks=2)
    m = build_protected("csr", a, "constraints")
    b = RNG.random(m.N)
    backend = create("jnp", "constraints")
    # Corrupt a column index to be out of range (set a high bit).
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][10] ^= np.uint32(1 << 20)  # 32*2+... large but < 2^24
    m2 = m.with_planes(planes)
    res = backend.solve(m2, b, 500, 1e-8, verbose=False, dtype="f64")
    assert res.failed
    assert any("constraint violated" in s or "order violated" in s
               for s in res.messages)


def test_f32_compute_converges():
    """f32 compute (the default on a GPU) reaches the reference's
    default threshold."""
    a = tri_assembled(n=512, blocks=4)
    m = build_protected("csr", a, "secded")
    b = RNG.random(m.N)
    backend = create("jnp", "secded")
    res = backend.solve(m, b, 1000, 0.001, verbose=False, dtype="f32")
    assert not res.failed
    assert res.rr <= 0.001
    # Solution quality: ||Ax-b|| small relative to ||b||.
    w, _, _ = backend.spmv_once(m, res.x.astype(np.float64), dtype="f64")
    rel = np.linalg.norm(w - b) / np.linalg.norm(b)
    # Converged to rr <= 1e-3 means ||r|| <= sqrt(1e-3); allow 2x slack for
    # the f32 recursive-residual vs true-residual gap.
    assert rel < 2 * np.sqrt(1e-3) / np.linalg.norm(b)


@pytest.mark.parametrize("mode", ["none", "secded"])
def test_cg_breakdown_fails_loudly(mode):
    """An indefinite matrix must raise ERR_BREAKDOWN, not NaN-as-converged
    (the reference divides by pw unguarded, cg.cpp:102).  Covers both the
    simple loop (none) and the lazy detect-fast loop (secded)."""
    from abft_sparse_cg.ops.spmv import ERR_BREAKDOWN

    n = 32
    idx = np.arange(n)
    a = assemble(idx, idx, -np.ones(n), n, 1)   # A = -I: p.A.p < 0
    m = build_protected("csr", a, mode)
    b = RNG.random(n)
    res = create("jnp", mode).solve(m, b, 100, 1e-10, verbose=False,
                                    dtype="f64")
    assert res.failed and res.errcode == ERR_BREAKDOWN
    assert any("breakdown" in s for s in res.messages)
    assert res.iterations == 0  # the bad update was discarded


def test_constraints_messages_are_format_specific():
    """The reference's two executables print different violation strings
    (CSR/CPUContext.cpp:190 vs COO/CPUContext.cpp:163)."""
    a = tri_assembled(n=32, blocks=1)
    b = RNG.random(a.N)
    out = {}
    for fmt in ("csr", "coo"):
        m = build_protected(fmt, a, "constraints")
        planes = {k: v.copy() for k, v in m.planes.items()}
        planes["col"][5] |= np.uint32(1 << 23)  # col -> out of range
        m2 = m.with_planes(planes)
        res = create("jnp", "constraints").solve(m2, b, 100, 1e-8,
                                                 verbose=False, dtype="f64")
        assert res.failed
        out[fmt] = res.messages[-1]
    assert "column size constraint violated at index" in out["csr"]
    assert "column size constraint violated for index" in out["coo"]


def test_constraints_lazy_schedule_machinery():
    """Constraints now has the detect-fast/check-rarely shape: the fast
    path scans only the index-word checksums; classify runs the
    structural checks once and, when nothing is violated, adopts the
    changed planes (checksum refresh) exactly like the reference, which
    would consume a non-violating index change silently."""
    import jax.numpy as jnp

    from abft_sparse_cg.ops.spmv import make_matrix_device

    from abft_sparse_cg.ops.spmv import make_spmv

    a = tri_assembled(n=64, blocks=2)
    m = build_protected("csr", a, "constraints")
    impl = make_spmv(m, jnp.float64, "constraints")
    assert impl.fast is not None and impl.classify is not None

    md = make_matrix_device(m, jnp.float64)
    x = jnp.asarray(np.zeros(m.R))

    # Clean: no trigger.
    _, trig = impl.fast(md, x)
    assert not bool(trig)

    # A VALUE flip never triggers (the reference never validates values
    # in constraints mode).
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["value_lo"][7] ^= np.uint32(1)
    mdv = make_matrix_device(m.with_planes(planes), jnp.float64)
    _, trig = impl.fast(mdv, x)
    assert not bool(trig)

    # An index change violating no constraint: trigger -> classify finds
    # nothing -> checksums refresh -> the resumed loop stays fast.
    # (ELL layout: the DIA invariant pins the exact diagonal slot, so
    # every index change is a violation there.)
    m = build_protected("csr", a, "constraints", force_exec="ell")
    impl = make_spmv(m, jnp.float64, "constraints")
    cols = np.asarray(m.planes["col"])
    rp = np.asarray(m.row_ptr)
    tgt = None
    for r in range(m.N):
        lo, hi = rp[r], rp[r + 1]
        cs = cols[lo:hi]
        for i in range(hi - lo):
            c = cs[i]
            nxt = cs[i + 1] if i + 1 < hi - lo else m.N
            prv = cs[i - 1] if i > 0 else -1
            if prv < c + 1 < nxt and c + 1 < m.N:
                tgt = lo + i
                break
        if tgt is not None:
            break
    assert tgt is not None
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][tgt] += np.uint32(1)
    mdb = make_matrix_device(m.with_planes(planes), jnp.float64)
    _, trig = impl.fast(mdb, x)
    assert bool(trig)
    st, md2 = impl.classify(mdb)
    assert int(st.errcode) == 0
    _, trig = impl.fast(md2, x)
    assert not bool(trig)

    # A violating change: trigger -> classify fail-stops with the same
    # code/slot the full oracle reports.
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][10] |= np.uint32(1 << 23)
    mdc = make_matrix_device(m.with_planes(planes), jnp.float64)
    _, trig = impl.fast(mdc, x)
    assert bool(trig)
    st, _ = impl.classify(mdc)
    _, st_full = impl.full(mdc, x)
    assert int(st.errcode) == int(st_full.errcode) != 0
    assert int(st.err_slot) == int(st_full.err_slot)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_constraints_lazy_pallas_kernels(fmt):
    """The pallas kernels read only the index words' checksums for
    constraints; interpret-mode parity with the jnp schedule."""
    import jax.numpy as jnp

    from abft_sparse_cg.ops.spmv import make_matrix_device
    from abft_sparse_cg.ops.spmv_pallas import _signals, make_pallas_spmv

    a = tri_assembled(n=512, blocks=2)
    for force in ("dia", "ell"):
        m = build_protected(fmt, a, "constraints", force_exec=force)
        _, _, sw = _signals(m, "constraints", detect=True)
        names = [m.layout.word_names[i] for i in sw]
        assert "value_lo" not in names and "value_hi" not in names
        impl = make_pallas_spmv(m, jnp.float32, "constraints",
                                interpret=True)
        assert impl.fast is not None and impl.classify is not None
        md = make_matrix_device(m, jnp.float32)
        x = jnp.asarray(RNG.standard_normal(m.R), jnp.float32)
        w, trig = impl.fast(md, x)
        assert not bool(trig)
        from abft_sparse_cg.ops.spmv import spmv_dense_oracle
        np.testing.assert_allclose(
            np.asarray(w)[: m.N],
            spmv_dense_oracle(m, np.asarray(x, np.float64)[: m.N]),
            rtol=2e-5, atol=1e-5)
        # index corruption triggers the kernel's checksum scan
        planes = {k: v.copy() for k, v in m.planes.items()}
        planes["col"][10] |= np.uint32(1 << 23)
        md2 = make_matrix_device(m.with_planes(planes), jnp.float32)
        _, trig = impl.fast(md2, x)
        assert bool(trig)
        st, _ = impl.classify(md2)
        assert int(st.errcode) != 0


def test_prepare_timed_solve():
    """The interleaved-timing API (bench.py's ratio protocol): the
    prepared batch() must execute the same compiled solve and report a
    sane per-solve time; iterations must match a direct solve()."""
    a = tri_assembled(n=256, blocks=2)
    m = build_protected("csr", a, "secded")
    b = RNG.standard_normal(m.N)
    be = create("jnp", "secded")
    batch, iters = be.prepare_timed_solve(m, b, 100, 1e-3, dtype="f64",
                                          reps=2)
    ref = be.solve(m, b, 100, 1e-3, verbose=False, dtype="f64")
    assert iters == ref.iterations
    t = batch()
    assert 0.0 < t < 60.0
    # exact-iteration variant (conv < 0 runs exactly max_itrs)
    batch8, got = be.prepare_timed_solve(m, b, 8, -1.0, dtype="f64",
                                         reps=2)
    assert got == 8
    assert 0.0 < batch8() < 60.0
