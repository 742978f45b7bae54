"""Checkpoint/resume and scrub subsystems."""

import numpy as np

import jax.numpy as jnp

from abft_sparse_cg.backends import create
from abft_sparse_cg.backends.jnp_backend import _device_arrays
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import make_spmv
from abft_sparse_cg.scrub import scrub
from abft_sparse_cg.solver.checkpoint import (
    CheckpointedSolve,
    load_state,
    save_state,
)
from abft_sparse_cg.solver.cg import init_state
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(11)


def protected(mode="secded", n=96, blocks=3):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    return build_protected("csr", a, mode)


def bvec(m, dtype=jnp.float64):
    b = np.zeros(m.R)
    b[: m.N] = RNG.random(m.N)
    return jnp.asarray(b, dtype)


def test_checkpoint_roundtrip(tmp_path):
    m = protected()
    b = bvec(m)
    s = init_state(b, 100)
    path = str(tmp_path / "ck.npz")
    save_state(path, s)
    s2 = load_state(path, dtype=b.dtype)
    for f in ("itr", "x", "r", "p", "rr", "trace"):
        np.testing.assert_array_equal(np.asarray(getattr(s, f)),
                                      np.asarray(getattr(s2, f)))


def test_segmented_solve_matches_straight(tmp_path):
    m = protected()
    b = bvec(m)
    md = _device_arrays(m, jnp.float64)
    impl = make_spmv(m, jnp.float64)

    runner = CheckpointedSolve(impl, conv_threshold=1e-12, every=3,
                               path=str(tmp_path / "ck.npz"))
    seg = runner.run(md, b, max_itrs=500)

    ref = create("jnp", "secded").solve(
        m, np.asarray(b)[: m.N], 500, 1e-12, verbose=False, dtype="f64")
    assert int(seg.iterations) == ref.iterations
    np.testing.assert_allclose(np.asarray(seg.x)[: m.N], ref.x, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(seg.rr_trace)[: ref.iterations],
        ref.rr_trace[: ref.iterations], rtol=1e-10)


def test_resume_from_partial(tmp_path):
    m = protected()
    b = bvec(m)
    md = _device_arrays(m, jnp.float64)
    impl = make_spmv(m, jnp.float64)
    path = str(tmp_path / "ck.npz")

    # Run only 4 iterations, "crash", then resume to completion.
    r1 = CheckpointedSolve(impl, 1e-12, every=2, path=path).run(
        md, b, max_itrs=4)
    assert int(r1.iterations) == 4
    r2 = CheckpointedSolve(impl, 1e-12, every=50, path=path).run(
        md, b, max_itrs=500, resume=True)

    ref = create("jnp", "secded").solve(
        m, np.asarray(b)[: m.N], 500, 1e-12, verbose=False, dtype="f64")
    assert int(r2.iterations) == ref.iterations
    np.testing.assert_allclose(np.asarray(r2.x)[: m.N], ref.x, rtol=1e-12)


def test_scrub_repairs_injected_fault():
    m = protected("sec8")
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(3),
                         echo=lambda s: None)
    repaired, report = scrub(m2)
    assert report.corrected == 1
    assert report.uncorrectable == 0
    assert any(s.startswith("[ECC] corrected") for s in report.messages)
    for n in m.layout.word_names:
        assert (repaired.planes[n] == m.planes[n]).all()
    # Scrubbed matrix solves clean, no further corrections.
    b = RNG.random(m.N)
    res = create("jnp", "sec8").solve(repaired, b, 300, 1e-8,
                                      verbose=False, dtype="f64")
    assert not res.failed and res.corrected_count == 0


def test_scrub_reports_sed_and_double():
    msed = protected("sed")
    m2 = inject_bitflips(msed, "ANY", 1, np.random.default_rng(5),
                         echo=lambda s: None)
    _, rep = scrub(m2)
    assert rep.uncorrectable == 1
    assert any("error detected at index" in s for s in rep.messages)


def test_segmented_solve_with_fault_matches_straight(tmp_path):
    """Lazy classify/scrub works across segment boundaries too."""
    m = protected("secded")
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(9),
                         echo=lambda s: None)
    b = bvec(m2)
    md = _device_arrays(m2, jnp.float64)
    impl = make_spmv(m2, jnp.float64)

    seg = CheckpointedSolve(impl, 1e-12, every=2,
                            path=str(tmp_path / "ck.npz")).run(
        md, b, max_itrs=500)
    ref = create("jnp", "secded").solve(
        m2, np.asarray(b)[: m2.N], 500, 1e-12, verbose=False, dtype="f64")
    assert not ref.failed
    assert int(seg.stats.errcode) == 0
    assert int(seg.iterations) == ref.iterations
    np.testing.assert_allclose(np.asarray(seg.x)[: m2.N], ref.x, rtol=1e-12)
    # The scrubbed MatrixDevice is carried across segments, so the fault
    # classifies exactly once — corrected_count is exact, not inflated.
    assert int(seg.stats.corrected_count) == 1
    # And the returned device planes are the repaired data.
    from abft_sparse_cg.scrub import scrubbed_from_device

    repaired = scrubbed_from_device(m2, seg.md)
    for n in m.layout.word_names:
        assert (repaired.planes[n] == m.planes[n]).all()


def test_solve_returns_scrubbed_matrix():
    """HostResult.scrubbed: post-solve API for the repaired planes
    (reference's in-place write-back, CSR/CPUContext.cpp:275-277)."""
    m = protected("secded")
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(21),
                         echo=lambda s: None)
    b = RNG.random(m.N)
    res = create("jnp", "secded").solve(m2, b, 300, 1e-10, verbose=False,
                                        dtype="f64")
    assert not res.failed and res.corrected_count == 1
    assert res.scrubbed is not None
    for n in m.layout.word_names:
        assert (res.scrubbed.planes[n] == m.planes[n]).all()
    # Fully self-consistent: solves clean with no further events.
    res2 = create("jnp", "secded").solve(res.scrubbed, b, 300, 1e-10,
                                         verbose=False, dtype="f64")
    assert not res2.failed and res2.corrected_count == 0
    assert res2.scrubbed is None  # nothing was corrected
