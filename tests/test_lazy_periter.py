"""Solver-level lazy --check-interval schedule of the pallas target:
the Triton kernel in interpret mode on one device, the plain live
version under a GSPMD mesh.

Unchecked iterations run the detection-free product
(ops.spmv_pallas.make_pallas_product), checks every CI-th iteration,
snapshot rollback on trigger (solver.cg.make_lazy_ci_continue).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import make_matrix_device
from abft_sparse_cg.ops.spmv_pallas import (
    make_pallas_product,
    make_pallas_spmv,
)
from abft_sparse_cg.solver.cg import make_cg_solver, make_lazy_ci_solver
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(17)


def _mat(mode="secded", force=None, n=512, blocks=2, fmt="csr"):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    return build_protected(fmt, a, mode, force_exec=force)


def _solvers(m, mode, ci, max_itrs=200, conv=1e-6):
    impl = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    product = make_pallas_product(m, jnp.float32, mode, interpret=True)
    assert product is not None
    lazy = jax.jit(make_lazy_ci_solver(impl, product, ci, max_itrs, conv))
    live = jax.jit(make_cg_solver(impl, max_itrs, conv))

    def run(solver, mat, b):
        md = make_matrix_device(mat, jnp.float32)
        bpad = np.zeros(mat.R)
        bpad[: mat.N] = mat.to_exec_order(b)
        return solver(md, jnp.asarray(bpad, jnp.float32))

    return lambda mat, b: run(lazy, mat, b), lambda mat, b: run(live, mat, b)


@pytest.mark.parametrize("config,mode,ci,fmt", [
    ("dia", "secded", 4, "csr"), ("dia", "sec8", 3, "csr"),
    ("ell", "secded", 4, "csr"), ("dia", "constraints", 5, "csr"),
    ("dia", "secded", 4, "coo"), ("ell", "secded", 4, "coo"),
])
def test_lazy_periter_clean_matches_live(config, mode, ci, fmt):
    """Clean lazy solves are bit-exact vs the live schedule: the product
    kernel computes the identical arithmetic, only detection differs.
    Covers both codeword layouts (CSR 96-bit: 3 words; COO 128-bit: 4)."""
    m = _mat(mode, force=None if config == "dia" else "ell",
             n=1024 if config == "ell" else 512, fmt=fmt)
    assert m.exec_kind == config
    run_lazy, run_live = _solvers(m, mode, ci)
    b = RNG.random(m.N)
    r0, r1 = run_live(m, b), run_lazy(m, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r0.x))


@pytest.mark.parametrize("config", ["dia", "ell"])
def test_lazy_periter_rollback_corrects(config):
    """An injected fault triggers at the next check (or the exit pass),
    classify corrects it, and the rolled-back re-execution delivers the
    clean solution bit-for-bit."""
    m = _mat("secded", force=None if config == "dia" else "ell",
             n=1024 if config == "ell" else 512)
    run_lazy, _ = _solvers(m, "secded", 4)
    b = RNG.random(m.N)
    clean = run_lazy(m, b)
    for seed in (3, 5, 9):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        r = run_lazy(m2, b)
        assert int(r.stats.errcode) == 0, seed
        assert int(r.stats.corrected_count) == 1, seed
        assert int(r.iterations) == int(clean.iterations), seed
        np.testing.assert_array_equal(np.asarray(r.x),
                                      np.asarray(clean.x))


def test_lazy_periter_wideband():
    """A wide band through the ELL kernel and its product variant:
    lazy clean == live bit-exact, fault rolled back."""
    from abft_sparse_cg.utils.matgen import spd_wideband

    rows, cols, vals, n = spd_wideband(4096, 2200)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded", reorder="none",
                        force_exec="ell")
    assert m.exec_kind == "ell" and m.band > 1920
    run_lazy, run_live = _solvers(m, "secded", 4)
    b = RNG.random(m.N)
    r0, r1 = run_live(m, b), run_lazy(m, b)
    assert int(r1.stats.errcode) == 0
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r0.x))
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(8),
                         echo=lambda s: None)
    rf = run_lazy(m2, b)
    assert int(rf.stats.errcode) == 0
    assert int(rf.stats.corrected_count) == 1
    np.testing.assert_array_equal(np.asarray(rf.x), np.asarray(r1.x))


def test_lazy_periter_split_composite():
    """Split composites: the product keeps the tail's live jnp signals
    (early detection is fine); clean lazy == live bit-exact and faults
    in either part are rolled back and corrected."""
    rows, cols, vals, n = spd_tridiagonal(2000)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(3)
    for r in (100, 999):
        for c in rng.choice(n, size=200, replace=False):
            hi, lo = max(r, int(c)), min(r, int(c))
            if hi != lo:
                rows.append(hi)
                cols.append(lo)
                vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, dtype=float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = deg.astype(float)[rows[diag]] + 4.0
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded")
    assert m.exec_kind == "split"
    run_lazy, run_live = _solvers(m, "secded", 4)
    b = RNG.random(m.N)
    r0, r1 = run_live(m, b), run_lazy(m, b)
    assert int(r1.stats.errcode) == 0
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r0.x))
    for seed in (4, 12):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        rf = run_lazy(m2, b)
        assert int(rf.stats.errcode) == 0, seed
        assert int(rf.stats.corrected_count) == 1, seed
        np.testing.assert_array_equal(np.asarray(rf.x), np.asarray(r1.x))


def test_lazy_periter_sed_failstop_rolls_back():
    """Uncorrectable detection (sed) fail-stops and reports the
    rolled-back verified state, not the contaminated tail."""
    m = _mat("sed")
    run_lazy, _ = _solvers(m, "sed", 4)
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(6),
                         echo=lambda s: None)
    r = run_lazy(m2, b)
    assert int(r.stats.errcode) == 1  # ERR_SED
    # Pre-solve fault: nothing was ever verified, so the rolled-back
    # state is the entry state.
    assert int(r.iterations) == 0


def test_lazy_periter_checkpointed_solve(tmp_path):
    """make_lazy_ci_continue has the make_cg_continue contract, so it
    plugs straight into CheckpointedSolve: segment boundaries land
    mid-CI-window, each segment's entry state is verified (the previous
    segment's exit pass), and a fault injected before a later segment
    is rolled back within it."""
    from abft_sparse_cg.solver.cg import make_lazy_ci_continue
    from abft_sparse_cg.solver.checkpoint import CheckpointedSolve

    m = _mat("secded")
    impl = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    product = make_pallas_product(m, jnp.float32, "secded",
                                  interpret=True)
    cont = make_lazy_ci_continue(impl, product, 4, 1e-6)
    md = make_matrix_device(m, jnp.float32)
    b = np.zeros(m.R)
    b[: m.N] = RNG.random(m.N)
    b = jnp.asarray(b, jnp.float32)

    runner = CheckpointedSolve(impl, conv_threshold=1e-6, every=3,
                               path=str(tmp_path / "ck.npz"),
                               continue_fn=cont)
    seg = runner.run(md, b, max_itrs=200)
    # Reference: the live schedule on the SAME kernels (the jnp impl
    # sums in a different order — not bit-comparable in f32).
    ref = jax.jit(make_cg_solver(impl, 200, 1e-6))(md, b)
    assert int(seg.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(seg.x), np.asarray(ref.x))

    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(5),
                         echo=lambda s: None)
    md2 = make_matrix_device(m2, jnp.float32)
    seg2 = CheckpointedSolve(impl, conv_threshold=1e-6, every=3,
                             path=str(tmp_path / "ck2.npz"),
                             continue_fn=cont).run(md2, b, max_itrs=200)
    assert int(seg2.stats.errcode) == 0
    assert int(seg2.stats.corrected_count) == 1
    np.testing.assert_array_equal(np.asarray(seg2.x), np.asarray(seg.x))


def test_lazy_periter_gspmd_backend():
    """--check-interval > 1 with --devices N rides the lazy schedule on
    the GSPMD program of the plain live version."""
    import os

    rows, cols, vals, n = spd_tridiagonal(8192)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded")
    b = RNG.random(m.N)
    ref = create("jnp", "secded").solve(m, b, 200, 1e-6, verbose=False,
                                        dtype="f32")
    os.environ["ABFT_CHECK_INTERVAL"] = "4"
    try:
        res = create("pallas", "secded").solve(m, b, 200, 1e-6,
                                               verbose=False, dtype="f32",
                                               devices=8)
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(4),
                             echo=lambda s: None)
        rf = create("pallas", "secded").solve(m2, b, 200, 1e-6,
                                              verbose=False, dtype="f32",
                                              devices=8)
    finally:
        os.environ.pop("ABFT_CHECK_INTERVAL", None)
    assert res.route == "xla-live (gspmd)"
    assert not res.failed
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(res.x, ref.x, rtol=2e-5, atol=1e-7)
    assert not rf.failed and rf.corrected_count == 1
    np.testing.assert_array_equal(rf.x, res.x)


def test_lazy_ci_pipelined_warns_and_runs_live(monkeypatch, capsys):
    """--check-interval > 1 with the pipelined solver has no lazy
    variant (its recurrences carry extra vectors a rollback would have
    to re-seed): the pallas backend warns on stderr and runs the live
    schedule, matching the CI=1 pipelined solve exactly."""
    m = _mat("secded", n=256, blocks=2)
    b = RNG.random(m.N)
    live = create("pallas", "secded").solve(
        m, b, 200, 1e-6, verbose=False, dtype="f32", solver="pipelined")
    monkeypatch.setenv("ABFT_CHECK_INTERVAL", "4")
    res = create("pallas", "secded").solve(
        m, b, 200, 1e-6, verbose=False, dtype="f32", solver="pipelined")
    err = capsys.readouterr().err
    assert "no pipelined-solver variant" in err
    assert not res.failed and res.iterations == live.iterations
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(live.x))


def test_check_interval_env_validation():
    """A non-integer ABFT_CHECK_INTERVAL is a clean ValueError, not an
    obscure int() traceback buried in solver construction."""
    import os

    from abft_sparse_cg.backends.pallas_backend import _check_interval

    os.environ["ABFT_CHECK_INTERVAL"] = "fast"
    try:
        with pytest.raises(ValueError, match="ABFT_CHECK_INTERVAL"):
            _check_interval()
    finally:
        os.environ.pop("ABFT_CHECK_INTERVAL", None)
    assert _check_interval() == 1
    assert _check_interval("pipelined") == 1


def test_check_interval_auto_policy(monkeypatch):
    """`--check-interval auto` resolves to the live schedule (1) until
    the ledger picks another interval; the pipelined solver has no
    lazy variant at all."""
    from abft_sparse_cg.backends.pallas_backend import _check_interval

    monkeypatch.setenv("ABFT_CHECK_INTERVAL", "auto")
    assert _check_interval() == 1
    assert _check_interval("pipelined") == 1
    monkeypatch.setenv("ABFT_CHECK_INTERVAL", "8")
    assert _check_interval() == 8
    assert _check_interval("pipelined") == 1
