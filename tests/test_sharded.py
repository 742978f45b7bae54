"""Multi-device tests on the 8-device virtual CPU mesh (conftest)."""

import numpy as np
import pytest

import jax

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.parallel.sharded import default_mesh, solve_sharded
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(99)


def protected(fmt="csr", mode="secded", n=64, blocks=4):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    return build_protected(fmt, a, mode)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "secded"])
def test_sharded_matches_single_device(fmt, mode):
    import jax.numpy as jnp

    m = protected(fmt, mode)
    b = RNG.random(m.N)
    mesh = default_mesh(8)
    res = solve_sharded(m, b, 500, 1e-10, mesh=mesh, dtype=jnp.float64)

    ref = create("jnp", mode).solve(m, b, 500, 1e-10, verbose=False, dtype="f64")
    assert int(res.stats.errcode) == 0
    assert int(res.iterations) == ref.iterations
    np.testing.assert_allclose(np.asarray(res.x)[: m.N], ref.x, rtol=1e-12)
    np.testing.assert_allclose(float(res.rr), ref.rr, rtol=1e-10)


def test_sharded_correction_and_detection():
    import jax.numpy as jnp

    mesh = default_mesh(8)
    # Correction under sec8 with an injected flip.
    m = protected("csr", "sec8")
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(5), echo=lambda s: None)
    res = solve_sharded(m2, b, 500, 1e-10, mesh=mesh, dtype=jnp.float64)
    assert int(res.stats.errcode) == 0
    assert int(res.stats.corrected_count) > 0

    # Detection under sed halts the sharded loop too.
    msed = protected("csr", "sed")
    m3 = inject_bitflips(msed, "ANY", 1, np.random.default_rng(6), echo=lambda s: None)
    res = solve_sharded(m3, b, 500, 1e-10, mesh=mesh, dtype=jnp.float64)
    assert int(res.stats.errcode) == 1  # ERR_SED
    assert int(res.stats.err_slot) >= 0


def test_sharded_uneven_rows_padding():
    """N not divisible by 8*ndev: padding keeps results exact."""
    import jax.numpy as jnp

    rows, cols, vals, n = spd_tridiagonal(37)
    a = assemble(cols, rows, vals, n, 3)  # N = 111
    m = build_protected("csr", a, "none")
    b = RNG.random(m.N)
    res = solve_sharded(m, b, 500, 1e-12, mesh=default_mesh(8), dtype=jnp.float64)
    ref = create("jnp", "none").solve(m, b, 500, 1e-12, verbose=False, dtype="f64")
    np.testing.assert_allclose(np.asarray(res.x)[: m.N], ref.x, rtol=1e-12)


@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_devices_ell_fault_events_match_single(mode):
    """ELL layout on the 8-device mesh: injected faults produce the same
    canonical events as the single-device solve — exercises the sharded
    gather (all-gather of p) and the err_slot mapping under mesh padding
    (N=148 rows pad to 192 on 8 devices)."""
    rows, cols, vals, n = spd_tridiagonal(37)
    a = assemble(cols, rows, vals, n, 4)  # N = 148
    m = build_protected("csr", a, mode, force_exec="ell")
    assert m.exec_kind == "ell"
    b = RNG.random(m.N)
    backend = create("jnp", mode)
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        single = backend.solve(m2, b, 300, 1e-10, verbose=False, dtype="f64")
        shard = backend.solve(m2, b, 300, 1e-10, verbose=False, dtype="f64",
                              devices=8)
        assert shard.errcode == single.errcode, f"seed {seed}"
        assert shard.err_index == single.err_index, f"seed {seed}"
        assert shard.corrected_count == single.corrected_count
        assert shard.messages == single.messages, f"seed {seed}"
        if not single.failed:
            np.testing.assert_allclose(shard.x, single.x, rtol=1e-12)


def test_devices_flag_permuted_matrix():
    """RCM-permuted matrix through the sharded backend path."""
    from abft_sparse_cg.utils.matgen import shuffle_labels

    tri = shuffle_labels(*spd_tridiagonal(64), seed=5)
    a = assemble(tri[1], tri[0], tri[2], tri[3], 4)
    m = build_protected("csr", a, "secded")
    assert m.perm is not None
    b = RNG.random(m.N)
    backend = create("jnp", "secded")
    single = backend.solve(m, b, 300, 1e-10, verbose=False, dtype="f64")
    shard = backend.solve(m, b, 300, 1e-10, verbose=False, dtype="f64",
                          devices=8)
    assert not shard.failed
    assert shard.iterations == single.iterations
    np.testing.assert_allclose(shard.x, single.x, rtol=1e-12)


def test_devices_flag_cli():
    """`--devices 8` drives the GSPMD path black-box through the CLI."""
    import subprocess
    import sys

    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mtx = os.path.join(repo, "matrices", "shallow_water1",
                       "shallow_water1.mtx")
    if not os.path.exists(mtx):
        pytest.skip("bundled matrix not generated")
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "bin", "cg-csr"), "-b", "2",
         "-m", "secded", "--devices", "8", "--seed", "11", "--quiet"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "time taken" in proc.stdout


def _bordered(n=2048, dense_rows=(17, 900), spread=300):
    """Tridiagonal core + dense rows — selects the bordered split."""
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
    return assemble(cols, rows, vals, n, 1)


@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_sharded_split_fault_events_match_single(mode):
    """Bordered composite on the 8-device mesh: main part row-sharded,
    flat tail entry-sharded; injected faults (which can land in either
    part) produce the single-device canonical events."""
    a = _bordered()
    m = build_protected("csr", a, mode)
    assert m.exec_kind == "split"
    b = RNG.random(m.N)
    backend = create("jnp", mode)
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        single = backend.solve(m2, b, 2000, 1e-10, verbose=False,
                               dtype="f64")
        shard = backend.solve(m2, b, 2000, 1e-10, verbose=False,
                              dtype="f64", devices=8)
        assert shard.errcode == single.errcode, f"seed {seed}"
        assert shard.err_index == single.err_index, f"seed {seed}"
        assert shard.corrected_count == single.corrected_count
        assert shard.messages == single.messages, f"seed {seed}"
        if not single.failed:
            # Shard-local partial sums reduce in a different order; both
            # solves converged to rr <= 1e-10, so solutions agree to the
            # convergence-implied slack, not to ulps.
            np.testing.assert_allclose(shard.x, single.x, rtol=1e-4,
                                       atol=1e-7)


def test_sharded_split_scrub_retrieval():
    """A corrected sharded composite solve yields repaired planes."""
    a = _bordered()
    m = build_protected("csr", a, "sec8")
    assert m.exec_kind == "split"
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(11),
                         echo=lambda s: None)
    res = create("jnp", "sec8").solve(m2, b, 2000, 1e-10, verbose=False,
                                      dtype="f64", devices=8)
    assert not res.failed and res.corrected_count == 1
    for n in m.layout.word_names:
        assert (res.scrubbed.planes[n] == m.planes[n]).all()


def test_devices_flag_rejected_for_native_target():
    m = protected("csr", "none", n=32, blocks=1)
    b = RNG.random(m.N)
    try:
        backend = create("cpu", "none")
    except Exception:
        pytest.skip("native backend unavailable")
    with pytest.raises(ValueError):
        backend.solve(m, b, 100, 1e-8, verbose=False, devices=8)


# ---- the pallas target on a mesh: GSPMD over the plain live version ----
#
# A Triton custom call has no SPMD partitioning rule, so `--devices N`
# on the pallas target runs the live version (detection re-read every
# iteration) as one GSPMD program; these cases check it against the
# single-device jnp solve on the virtual mesh.


def _kernel_mat(force=None, shuffle=False, mode="secded", n=8192):
    from abft_sparse_cg.utils.matgen import shuffle_labels

    tri = spd_tridiagonal(n)
    if shuffle:
        tri = shuffle_labels(*tri, seed=3)
    a = assemble(tri[1], tri[0], tri[2], tri[3], 1)
    return build_protected("csr", a, mode, force_exec=force)


def _gspmd_solvers(m, mode, max_itrs=200, conv=1e-6, dtype=None):
    import jax.numpy as jnp

    from abft_sparse_cg.ops.spmv import make_matrix_device, make_spmv
    from abft_sparse_cg.ops.spmv_pallas import make_pallas_spmv
    from abft_sparse_cg.parallel.sharded import _device_put_sharded
    from abft_sparse_cg.solver.cg import make_cg_solver

    dt = dtype or jnp.float32
    mesh = default_mesh(8)
    impl = make_pallas_spmv(m, dt, mode, platform="gspmd")
    sm = jax.jit(make_cg_solver(impl, max_itrs, conv))
    ref = jax.jit(make_cg_solver(make_spmv(m, dt, mode), max_itrs, conv))

    def run_sm(mat, b):
        md, bdev, _ = _device_put_sharded(mat, b, mesh, dt)
        return sm(md, bdev, None)

    def run_ref(mat, b):
        md = make_matrix_device(mat, dt)
        bpad = np.zeros(mat.R)
        bpad[: mat.N] = mat.to_exec_order(b)
        return ref(md, jnp.asarray(bpad, dt), None)

    return run_sm, run_ref


@pytest.mark.parametrize("config,mode", [
    ("dia", "secded"), ("ell", "secded"), ("ell-perm", "secded"),
    ("dia", "none"), ("dia", "constraints"), ("ell", "sec7"),
])
def test_gspmd_live_matches_single_device(config, mode):
    """The sharded live program reproduces the single-device solve (same
    iterations, same solution) for both layouts, permuted gather
    indices, and every signal schedule."""
    force = None if config == "dia" else "ell"
    m = _kernel_mat(force=force, shuffle=(config == "ell-perm"), mode=mode)
    assert m.exec_kind == ("dia" if config == "dia" else "ell")
    run_sm, run_ref = _gspmd_solvers(m, mode)
    b = RNG.random(m.N)
    r0, r1 = run_ref(m, b), run_sm(m, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("config", ["dia", "ell", "ell-perm"])
def test_gspmd_live_corrects_fault(config):
    """An injected single-bit fault triggers the reduced live signal;
    the GSPMD classify corrects it on the sharded planes and the resumed
    solve matches the clean one bit-for-bit."""
    force = None if config == "dia" else "ell"
    m = _kernel_mat(force=force, shuffle=(config == "ell-perm"))
    run_sm, _ = _gspmd_solvers(m, "secded")
    b = RNG.random(m.N)
    clean = run_sm(m, b)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(4),
                         echo=lambda s: None)
    r = run_sm(m2, b)
    assert int(r.stats.errcode) == 0
    assert int(r.stats.corrected_count) == 1
    assert int(r.iterations) == int(clean.iterations)
    np.testing.assert_array_equal(np.asarray(r.x), np.asarray(clean.x))


def test_gspmd_live_wideband():
    """Band > 1920: the sharded gather reaches across shards and the
    solve matches single-device."""
    from abft_sparse_cg.utils.matgen import spd_wideband

    rows, cols, vals, n = spd_wideband(24576, 2500)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded", reorder="none",
                        force_exec="ell")
    assert m.exec_kind == "ell" and m.band > 1920
    run_sm, run_ref = _gspmd_solvers(m, "secded")
    bv = RNG.random(m.N)
    r0, r1 = run_ref(m, bv), run_sm(m, bv)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=2e-5, atol=1e-7)


def test_gspmd_live_split_composite():
    """Bordered composite on the mesh: the banded main part row-sharded,
    the flat tail entry-sharded; fault correction works across both
    parts and matches single-device."""
    a = _bordered(n=8000)
    m = build_protected("csr", a, "secded", row_align=128 * 8)
    assert m.exec_kind == "split" and m.R == 8192
    run_sm, run_ref = _gspmd_solvers(m, "secded")
    b = RNG.random(m.N)
    r0, r1 = run_ref(m, b), run_sm(m, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    # f32 + the entry-sharded tail's different summation order: a couple
    # of small-magnitude elements land ~1e-3 relative apart at conv=1e-6.
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=2e-3, atol=5e-6)
    # A fault in either part is detected by the reduced signals and
    # corrected by the (sharded) GSPMD classify.
    for seed in (4, 11):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        rf = run_sm(m2, b)
        assert int(rf.stats.errcode) == 0, seed
        assert int(rf.stats.corrected_count) == 1, seed
        np.testing.assert_array_equal(np.asarray(rf.x), np.asarray(r1.x))


def test_gspmd_live_sed_failstop():
    m = _kernel_mat(mode="sed")
    run_sm, _ = _gspmd_solvers(m, "sed")
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(6),
                         echo=lambda s: None)
    r = run_sm(m2, b)
    assert int(r.stats.errcode) == 1  # ERR_SED: detect-only fail-stop
    assert int(r.iterations) == 0


def test_gspmd_live_has_no_envelope():
    """The mesh route takes binary64 and 512-row shards alike."""
    import jax.numpy as jnp

    m = _kernel_mat(n=4096)               # 512 rows per device
    run_sm, run_ref = _gspmd_solvers(m, "secded", dtype=jnp.float64,
                                     conv=1e-12)
    b = RNG.random(m.N)
    r0, r1 = run_ref(m, b), run_sm(m, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-10, atol=1e-13)


def test_row_align_build():
    """row_align pads R to the mesh granularity with zero codewords and
    never flips the layout choice (heuristics judge the structural R)."""
    rows, cols, vals, n = spd_tridiagonal(4000)
    a = assemble(cols, rows, vals, n, 1)
    m0 = build_protected("csr", a, "secded")
    m = build_protected("csr", a, "secded", row_align=8192)
    assert m0.R == 4096 and m.R == 8192
    assert m.exec_kind == m0.exec_kind
    assert m.K == m0.K and m.nnz == m0.nnz
    # Padding rows are empty and checksum to zero.
    assert int(m.ell_len[m.N:].sum()) == 0
    assert not m.ell_cksum[:, m0.R // 8:].any()
    with pytest.raises(ValueError):
        build_protected("csr", a, "secded", row_align=1000)


def test_row_align_gspmd_live():
    """An N whose natural R is not a multiple of 8 devices' alignment
    builds with the CLI's row_align and the sharded live solve matches
    the single-device one."""
    rows, cols, vals, n = spd_tridiagonal(4000)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded", row_align=128 * 8)
    assert m.R % (128 * 8) == 0
    run_sm, run_ref = _gspmd_solvers(m, "secded")
    b = RNG.random(m.N)
    r0, r1 = run_ref(m, b), run_sm(m, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=2e-5, atol=1e-7)


def test_row_align_split_composite():
    """row_align propagates through the bordered split so GSPMD split
    sharding (R % 8*ndev) keeps working at any N."""
    rows, cols, vals, n = spd_tridiagonal(500)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(3)
    for c in rng.choice(n, size=120, replace=False):
        if int(c) != 100:
            rows.append(max(100, int(c)))
            cols.append(min(100, int(c)))
            vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, dtype=float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = deg.astype(float)[rows[diag]] + 4.0
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded", row_align=8 * 8 * 16)
    if m.exec_kind != "split":
        pytest.skip("matrix did not split")
    assert m.R % (8 * 8) == 0 and m.main.R == m.tail.R == m.R
    b = RNG.random(m.N)
    res = create("jnp", "secded").solve(m, b, 300, 1e-10, verbose=False,
                                        dtype="f64", devices=8)
    single = create("jnp", "secded").solve(m, b, 300, 1e-10, verbose=False,
                                           dtype="f64")
    assert not res.failed
    # Entry-sharded tail sums in a different order than single-device;
    # both land within the converged residual's accuracy of each other.
    np.testing.assert_allclose(res.x, single.x, rtol=1e-5, atol=1e-9)


def test_gspmd_backend_routing():
    """`--devices 8` on the pallas target rides the GSPMD live program
    and names that route in the result."""
    m = _kernel_mat()
    b = RNG.random(m.N)
    res = create("pallas", "secded").solve(m, b, 200, 1e-6, verbose=False,
                                           dtype="f32", devices=8)
    ref = create("jnp", "secded").solve(m, b, 200, 1e-6, verbose=False,
                                        dtype="f32")
    assert res.route == "xla-live (gspmd)"
    assert not res.failed
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(res.x, ref.x, rtol=2e-5, atol=1e-7)
