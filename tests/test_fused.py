"""The pallas target's solve: the CG while-loop over the per-iteration
Triton SpMV kernels (ops.spmv_pallas), interpret mode.

Each iteration runs one kernel that reads the value plane, x and the
fold plane and returns (w, live trigger, p.w); these tests check the
whole solve's semantics — identical iterates, traces and ABFT events to
the jnp solver — through the Pallas interpreter (the compiled kernels
run on the GPU in chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import ERR_BREAKDOWN, make_matrix_device, make_spmv
from abft_sparse_cg.ops.spmv_pallas import (make_pallas_product,
                                            make_pallas_spmv, route_for)
from abft_sparse_cg.solver.cg import (make_cg_continue, make_cg_solver,
                                      make_lazy_ci_continue,
                                      make_lazy_ci_solver)
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(77)


def dia_matrix(mode, n=1024, blocks=1):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    m = build_protected("csr", a, mode)
    assert m.exec_kind == "dia"
    return m


def ell_matrix(mode, n=1024, blocks=1, shuffle=False):
    from abft_sparse_cg.utils.matgen import shuffle_labels

    tri = spd_tridiagonal(n)
    if shuffle:
        tri = shuffle_labels(*tri, seed=11)
    a = assemble(tri[1], tri[0], tri[2], tri[3], blocks)
    m = build_protected("csr", a, mode, force_exec="ell")
    assert m.exec_kind == "ell"
    assert (m.perm is not None) == shuffle
    return m


def split_matrix(mode, n=2048, blocks=1):
    """Bordered: tridiagonal core + 2 dense rows -> split exec layout."""
    rows, cols, vals, n = spd_tridiagonal(n)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(3)
    for r in (17, 900):
        targets = np.setdiff1d(rng.choice(n, size=300, replace=False),
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
    m = build_protected("csr", assemble(cols, rows, vals, n, blocks),
                        mode)
    assert m.exec_kind == "split"
    assert m.tail.dense_plan is not None
    return m


def make(layout, mode, n=1024):
    if layout == "dia":
        return dia_matrix(mode, n)
    if layout == "split":
        return split_matrix(mode)
    return ell_matrix(mode, n, shuffle=(layout == "rcm-ell"))


def kernel_spmv(m, mode, **kw):
    return make_pallas_spmv(m, jnp.float32, mode, interpret=True, **kw)


def solvers(m, mode, max_itrs=300, conv=1e-8, **kw):
    """(device matrix, jnp reference solve, pallas-target solve)."""
    md = make_matrix_device(m, jnp.float32)
    ref = jax.jit(make_cg_solver(make_spmv(m, jnp.float32, mode),
                                 max_itrs, conv))
    fus = jax.jit(make_cg_solver(kernel_spmv(m, mode, **kw), max_itrs,
                                 conv))
    return md, ref, fus


def jacobi(m):
    d = m.diagonal()
    mpad = np.zeros(m.R)
    mpad[: m.N] = m.to_exec_order(
        np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 1.0))
    return jnp.asarray(mpad, jnp.float32)


def bvec(m):
    b = np.zeros(m.R)
    b[: m.N] = RNG.random(m.N)
    return jnp.asarray(b, jnp.float32)


@pytest.mark.parametrize("mode", ["sec7", "secded"])
def test_fused_coo_format(mode):
    """COO (128-bit codewords, 4 word planes) through the ELL kernel:
    clean match to jnp + a mid-stream injected fault corrected."""
    rows, cols, vals, n = spd_tridiagonal(1024)
    m = build_protected("coo", assemble(cols, rows, vals, n, 1), mode,
                        force_exec="ell")
    assert m.exec_kind == "ell" and m.fmt == "coo"
    assert route_for(m, "gpu") == "triton-ell"
    md, ref, fus = solvers(m, mode)
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(6),
                         echo=lambda s: None)
    md2 = make_matrix_device(m2, jnp.float32)
    r2 = fus(md2, b)
    assert int(r2.stats.errcode) == 0
    assert int(r2.stats.corrected_count) == 1
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["dia", "ell", "rcm-ell", "split"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "sec8", "secded"])
def test_fused_matches_jnp_clean(mode, layout):
    m = make(layout, mode)
    md, ref, fus = solvers(m, mode)
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)
    k = int(r0.iterations)
    t0 = np.asarray(r0.rr_trace)[:k]
    t1 = np.asarray(r1.rr_trace)[:k]
    if layout == "split":
        # split sums the tail in a different order (the composite adds
        # the parts' products), so once rr falls ~5 orders below rr0 the f32
        # rounding noise dominates the trace (verified: a single
        # iteration's x matches to 4e-8; trajectories rejoin and the
        # converged x is equal above).  Compare above the noise floor.
        above = t0 > float(t0[0]) * 1e-5
        np.testing.assert_allclose(t1[above], t0[above], rtol=1e-3)
    else:
        np.testing.assert_allclose(t1, t0, rtol=1e-4)
    assert np.isnan(np.asarray(r1.rr_trace)[k:]).all()


@pytest.mark.parametrize("layout", ["dia", "ell", "split"])
@pytest.mark.parametrize("mode", ["sec7", "sec8", "secded"])
def test_fused_corrects_fault_and_resumes(mode, layout):
    """The kernel's live trigger exits the fast loop; classify repairs;
    the resumed kernel reproduces the clean solve exactly."""
    m = make(layout, mode)
    md, ref, fus = solvers(m, mode)
    b = bvec(m)
    clean = fus(md, b)  # same implementation -> bit-identical oracle
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        md2 = make_matrix_device(m2, jnp.float32)
        r = fus(md2, b)
        assert int(r.stats.errcode) == 0, seed
        assert int(r.stats.corrected_count) == 1, seed
        assert int(r.iterations) == int(clean.iterations)
        np.testing.assert_array_equal(np.asarray(r.x),
                                      np.asarray(clean.x))


def test_fused_sed_detects_and_halts():
    m = dia_matrix("sed")
    md, ref, fus = solvers(m, "sed")
    b = bvec(m)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(3),
                         echo=lambda s: None)
    md2 = make_matrix_device(m2, jnp.float32)
    r0, r1 = ref(md2, b), fus(md2, b)
    assert int(r1.stats.errcode) == int(r0.stats.errcode) == 1
    assert int(r1.iterations) == int(r0.iterations) == 0


def test_fused_breakdown_guard():
    """Indefinite matrix -> ERR_BREAKDOWN, not NaN-as-convergence."""
    m = dia_matrix("none")
    planes = {k: v.copy() for k, v in m.planes.items()}
    # Negate the whole diagonal via the value planes: -A is negative
    # definite, p.A.p < 0 on the first iteration.
    from abft_sparse_cg.ecc.values import planes_to_f64_np
    vals = planes_to_f64_np(planes["value_lo"], planes["value_hi"])
    neg = (-vals).view(np.uint64)
    planes["value_lo"] = (neg & 0xFFFFFFFF).astype(np.uint32)
    planes["value_hi"] = (neg >> 32).astype(np.uint32)
    m2 = m.with_planes(planes)
    md = make_matrix_device(m2, jnp.float32)
    fus = jax.jit(make_cg_solver(kernel_spmv(m2, "none"), 100, 1e-8))
    r = fus(md, bvec(m))
    assert int(r.stats.errcode) == ERR_BREAKDOWN
    assert int(r.iterations) == 0


def test_fused_no_trace():
    """trace_rr=False: a one-slot nan trace, same iterates."""
    m = dia_matrix("secded")
    md = make_matrix_device(m, jnp.float32)
    b = bvec(m)
    fus = jax.jit(make_cg_solver(kernel_spmv(m, "secded"), 300, 1e-8,
                                 trace_rr=False))
    r = fus(md, b)
    _, ref, _ = solvers(m, "secded")
    r0 = ref(md, b)
    assert int(r.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)
    assert np.asarray(r.rr_trace).shape == (1,)


def test_fused_envelope():
    """The kernel has no size or dtype envelope: a row count that no
    block size divides and binary64 both stay on the kernel route and
    match the jnp solve (DIA, on the plain live route, alongside)."""
    rows, cols, vals, n = spd_tridiagonal(100)
    a = assemble(cols, rows, vals, n, 1)
    for exec_ in (None, "ell"):
        m = build_protected("csr", a, "secded", force_exec=exec_)
        assert m.R % 1024 != 0
        assert route_for(m, "gpu") == ("triton-ell" if exec_ else
                                       "xla-live")
        for dt in (jnp.float32, jnp.float64):
            md = make_matrix_device(m, dt)
            b = jnp.asarray(np.linspace(1, 2, m.R) * (np.arange(m.R) < n),
                            dt)
            ref = make_cg_solver(make_spmv(m, dt, "secded"), 300, 1e-8)
            fus = make_cg_solver(make_pallas_spmv(m, dt, "secded",
                                                  interpret=True), 300,
                                 1e-8)
            r0, r1 = jax.jit(ref)(md, b), jax.jit(fus)(md, b)
            assert int(r1.stats.errcode) == 0
            assert int(r1.iterations) == int(r0.iterations)
            np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layout", ["dia", "ell"])
@pytest.mark.parametrize("mode", ["none", "secded"])
def test_fused_jacobi_matches_jnp(mode, layout):
    """Jacobi-preconditioned CG over the kernels matches the jnp
    solver's Jacobi path."""
    m = make(layout, mode)
    md, ref, fus = solvers(m, mode)
    b = bvec(m)
    minv = jacobi(m)
    r0, r1 = ref(md, b, minv), fus(md, b, minv)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)
    k = int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.rr_trace)[:k],
                               np.asarray(r0.rr_trace)[:k], rtol=1e-4)


def test_fused_checkpointed_solve(tmp_path):
    """CheckpointedSolve over the kernels: segment, snapshot, resume,
    same answer as the one-shot solve — incl. a scrub carried across
    segments (classify exactly once)."""
    from abft_sparse_cg.solver.checkpoint import CheckpointedSolve

    m = dia_matrix("secded")
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(5),
                         echo=lambda s: None)
    md = make_matrix_device(m2, jnp.float32)
    b = bvec(m)
    cont = make_cg_continue(kernel_spmv(m, "secded"), 1e-8)
    runner = CheckpointedSolve(None, 1e-8, every=3,
                               path=str(tmp_path / "ck.npz"),
                               continue_fn=cont)
    res = runner.run(md, b, max_itrs=300)
    _, _, fus = solvers(m, "secded")
    ref = fus(make_matrix_device(m, jnp.float32), b)
    assert int(res.stats.errcode) == 0
    assert int(res.stats.corrected_count) == 1
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    # resume path: second run with resume=True starts from the saved
    # (converged) state and returns immediately
    res2 = runner.run(res.md, b, max_itrs=300, resume=True)
    assert int(res2.iterations) == int(res.iterations)


def test_fused_respects_upto():
    """continue_(.., upto) stops exactly at the segment boundary and a
    second call finishes the solve (checkpoint contract)."""
    from abft_sparse_cg.solver.cg import init_state

    m = dia_matrix("secded")
    md = make_matrix_device(m, jnp.float32)
    b = bvec(m)
    cont = jax.jit(make_cg_continue(kernel_spmv(m, "secded"), 1e-8))
    s0 = init_state(b, 300)
    s1, md1 = cont(md, s0, jnp.int32(4))
    assert int(s1.itr) == 4
    s2, _ = cont(md1, s1, jnp.int32(300))
    _, ref, _ = solvers(m, "secded")
    r0 = ref(md, b)
    assert int(s2.itr) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(s2.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layout", ["dia", "ell", "split"])
def test_fused_constraints_lazy(layout):
    """Constraints through the kernels: the index-word checksum scan is
    the in-kernel trigger; classify runs the structural checks once.
    Clean solves match jnp; a violation fail-stops with the full
    oracle's code; a non-violating index change is adopted (checksum
    refresh) and the solve completes."""
    m = make(layout, "constraints")
    md, ref, fus = solvers(m, "constraints")
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)

    # Out-of-range column -> fail-stop, same code as the jnp schedule.
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][10] |= np.uint32(1 << 23)
    m2 = m.with_planes(planes)
    md2 = make_matrix_device(m2, jnp.float32)
    r2, r3 = ref(md2, b), fus(md2, b)
    assert int(r3.stats.errcode) == int(r2.stats.errcode) != 0
    assert int(r3.stats.err_slot) == int(r2.stats.err_slot)
    assert int(r3.iterations) == 0


def test_fused_constraints_adopts_benign_change():
    """An index change that violates no constraint (the reference would
    consume it silently): the kernel triggers once, classify refreshes
    the baseline, and the solve runs to convergence on the changed
    matrix."""
    m = ell_matrix("constraints")
    cols = np.asarray(m.planes["col"])
    rp = np.asarray(m.row_ptr)
    tgt = None
    for r in range(m.N):
        lo, hi = rp[r], rp[r + 1]
        cs = cols[lo:hi]
        for i in range(hi - lo):
            nxt = cs[i + 1] if i + 1 < hi - lo else m.N
            prv = cs[i - 1] if i > 0 else -1
            if prv < cs[i] + 1 < nxt and cs[i] + 1 < m.N:
                tgt = lo + i
                break
        if tgt is not None:
            break
    assert tgt is not None
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][tgt] += np.uint32(1)
    m2 = m.with_planes(planes)
    md2 = make_matrix_device(m2, jnp.float32)
    _, _, fus = solvers(m2, "constraints", max_itrs=40)
    r = fus(md2, bvec(m))
    assert int(r.stats.errcode) == 0
    assert int(r.iterations) > 0


def wideband_matrix(mode, n=4096, b=2500, k=3, seed=2, fmt="csr"):
    """Uniformly wide band (utils.matgen.spd_wideband).  At test scale
    RCM could reband it, so the build pins the natural order; band >
    1920 makes x reads span a window of many row blocks."""
    from abft_sparse_cg.utils.matgen import spd_wideband

    rows, cols, vals, n = spd_wideband(n, b, k, seed)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected(fmt, a, mode, reorder="none", force_exec="ell")
    assert m.exec_kind == "ell"
    assert m.band > 1920, m.band
    return m


def test_fused_rolled_wideband_coo():
    """Wideband through the ELL kernel with the COO layout (128-bit
    codewords, 4 word planes): same iterates as jnp, fault corrected."""
    m = wideband_matrix("secded", fmt="coo")
    assert m.fmt == "coo"
    md, ref, fus = solvers(m, "secded")
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(4),
                         echo=lambda s: None)
    r2 = fus(make_matrix_device(m2, jnp.float32), b)
    assert int(r2.stats.errcode) == 0
    assert int(r2.stats.corrected_count) == 1
    np.testing.assert_array_equal(np.asarray(r2.x), np.asarray(r1.x))


@pytest.mark.parametrize("mode", ["none", "secded"])
def test_fused_rolled_wideband_matches_jnp(mode):
    """Band > 1920: the ELL kernel's indexed loads reach x across many
    row blocks — same iterates as jnp."""
    m = wideband_matrix(mode)
    assert route_for(m, "gpu") == "triton-ell"
    md, ref, fus = solvers(m, mode)
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)


def test_fused_rolled_very_wide_band():
    """Band ~ 7000 over 8192 rows and small row blocks: every block
    reads x from most of the others."""
    m = wideband_matrix("none", n=8192, b=7000, k=2, seed=5)
    assert m.band > 4 * 1024
    md, ref, fus = solvers(m, "none", max_itrs=60, block_rows=1024)
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# Lazy detection schedule (check_interval > 1): the detection stream
# runs every CI-th iteration, snapshot-rollback on trigger
# --------------------------------------------------------------------------

def lazy_solver(m, mode, ci, max_itrs=300, conv=1e-8):
    product = make_pallas_product(m, jnp.float32, mode, interpret=True)
    return jax.jit(make_lazy_ci_solver(kernel_spmv(m, mode), product, ci,
                                       max_itrs, conv))


@pytest.mark.parametrize("layout", ["dia", "ell", "split"])
def test_lazy_clean_solve_matches_live(layout):
    """CI=4 on a clean solve: identical iterates to the live schedule
    (the signals never affect the arithmetic)."""
    m = make(layout, "secded")
    md, _, fus = solvers(m, "secded")
    b = bvec(m)
    r1 = fus(md, b)
    r4 = lazy_solver(m, "secded", 4)(md, b)
    assert int(r4.stats.errcode) == 0
    assert int(r4.iterations) == int(r1.iterations)
    np.testing.assert_array_equal(np.asarray(r4.x), np.asarray(r1.x))


@pytest.mark.parametrize("layout,ci", [("dia", 4), ("ell", 3),
                                       ("split", 4), ("dia", 7)])
def test_lazy_corrects_fault_via_rollback(layout, ci):
    """An injected fault triggers at the first checked iteration; the
    solve rolls back to the verified snapshot, scrubs, and lands on the
    clean solve bit-for-bit."""
    m = make(layout, "secded")
    md, _, fus = solvers(m, "secded")
    b = bvec(m)
    clean = lazy_solver(m, "secded", ci)(md, b)
    np.testing.assert_array_equal(np.asarray(clean.x),
                                  np.asarray(fus(md, b).x))
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(8),
                         echo=lambda s: None)
    r = lazy_solver(m2, "secded", ci)(make_matrix_device(m2, jnp.float32),
                                      b)
    assert int(r.stats.errcode) == 0
    assert int(r.stats.corrected_count) == 1
    assert int(r.iterations) == int(clean.iterations)
    np.testing.assert_array_equal(np.asarray(r.x), np.asarray(clean.x))
    # Rolled-back iterations re-execute and overwrite their rr-trace
    # slots: the final trace matches the clean solve's exactly.
    k = int(clean.iterations)
    np.testing.assert_array_equal(np.asarray(r.rr_trace)[:k],
                                  np.asarray(clean.rr_trace)[:k])


def test_lazy_jacobi_corrects():
    """Lazy schedule with the Jacobi preconditioner: clean bit-exact vs
    live, rollback correction bit-exact."""
    m = make("dia", "secded")
    md, _, live = solvers(m, "secded")
    b = bvec(m)
    minv = jacobi(m)
    lz = lazy_solver(m, "secded", 4)
    r0, r1 = live(md, b, minv), lz(md, b, minv)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r0.x))
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(8),
                         echo=lambda s: None)
    r2 = lz(make_matrix_device(m2, jnp.float32), b, minv)
    assert int(r2.stats.errcode) == 0
    assert int(r2.stats.corrected_count) == 1
    np.testing.assert_array_equal(np.asarray(r2.x), np.asarray(r0.x))


def test_lazy_checkpointed_solve(tmp_path):
    """A lazy continue_fn under CheckpointedSolve: segments verify at
    their boundaries (exit pass), the mid-solve scrub still happens
    exactly once, same answer as the one-shot live solve."""
    from abft_sparse_cg.solver.checkpoint import CheckpointedSolve

    m = dia_matrix("secded")
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(5),
                         echo=lambda s: None)
    md = make_matrix_device(m2, jnp.float32)
    b = bvec(m)
    cont = make_lazy_ci_continue(
        kernel_spmv(m, "secded"),
        make_pallas_product(m, jnp.float32, "secded", interpret=True), 4,
        1e-8)
    runner = CheckpointedSolve(None, 1e-8, every=3,
                               path=str(tmp_path / "ck.npz"),
                               continue_fn=cont)
    res = runner.run(md, b, max_itrs=300)
    _, _, fus = solvers(m, "secded")
    ref = fus(make_matrix_device(m, jnp.float32), b)
    assert int(res.stats.errcode) == 0
    assert int(res.stats.corrected_count) == 1
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_lazy_sed_failstop_rolls_back():
    """Detect-only mode under the lazy schedule: the uncorrectable
    fault fail-stops with the state rolled back to the last verified
    snapshot (here: the initial state, iteration count 0)."""
    m = make("dia", "sed")
    b = bvec(m)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(5),
                         echo=lambda s: None)
    r = lazy_solver(m2, "sed", 4)(make_matrix_device(m2, jnp.float32), b)
    assert int(r.stats.errcode) != 0
    assert int(r.iterations) == 0


def test_lazy_secded_double_bit_failstop():
    m = make("dia", "secded")
    b = bvec(m)
    m2 = inject_bitflips(m, "VALUE", 2, np.random.default_rng(12),
                         echo=lambda s: None)
    r = lazy_solver(m2, "secded", 4)(make_matrix_device(m2, jnp.float32),
                                     b)
    assert int(r.stats.errcode) != 0
    assert int(r.iterations) == 0


def test_lazy_constraints_adopts_and_failstops():
    """Constraints under the lazy schedule: clean matches live, a
    benign index change is adopted (classify refreshes the baseline;
    the retry from snapshot completes), a violation fail-stops."""
    m = make("ell", "constraints")
    md, _, fus = solvers(m, "constraints")
    b = bvec(m)
    clean = fus(md, b)
    lz = lazy_solver(m, "constraints", 4)
    r = lz(md, b)
    assert int(r.stats.errcode) == 0
    assert int(r.iterations) == int(clean.iterations)
    np.testing.assert_array_equal(np.asarray(r.x), np.asarray(clean.x))
    # Benign in-order column bump: adopted, solve completes.
    cols = np.asarray(m.planes["col"])
    rp = np.asarray(m.row_ptr)
    tgt = None
    for row in range(m.N):
        lo, hi = rp[row], rp[row + 1]
        cs = cols[lo:hi]
        for i in range(hi - lo):
            nxt = cs[i + 1] if i + 1 < hi - lo else m.N
            prv = cs[i - 1] if i > 0 else -1
            if prv < cs[i] + 1 < nxt and cs[i] + 1 < m.N:
                tgt = lo + i
                break
        if tgt is not None:
            break
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][tgt] += np.uint32(1)
    m2 = m.with_planes(planes)
    r2 = lazy_solver(m2, "constraints", 4)(
        make_matrix_device(m2, jnp.float32), b)
    assert int(r2.stats.errcode) == 0
    assert int(r2.iterations) > 0
    # Out-of-range column: fail-stop with the structural oracle's code.
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][10] |= np.uint32(1 << 23)
    m3 = m.with_planes(planes)
    r3 = lazy_solver(m3, "constraints", 4)(
        make_matrix_device(m3, jnp.float32), b)
    assert int(r3.stats.errcode) != 0
    assert int(r3.iterations) == 0


def test_fused_rolled_split_main():
    """Bordered matrix whose banded core is ALSO wide-band: the ELL
    kernel on the main part + the plain-XLA span-window tail, matching
    jnp and correcting a fault."""
    rng = np.random.default_rng(3)
    n = 4096
    rows, cols = [np.arange(n)], [np.arange(n)]
    for _ in range(3):
        d = rng.integers(1, 2500, n)
        i = np.arange(n)
        keep = i + d < n
        rows.append((i + d)[keep])
        cols.append(i[keep])
    for br in (5, 60):    # two dense border rows
        c = rng.choice(n, 400, replace=False)
        rows.append(np.full(400, br))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, 200.0, -1.0)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded", reorder="none")
    assert m.exec_kind == "split" and m.main.band > 1920
    assert route_for(m.main, "gpu") == "triton-ell"
    md, ref, fus = solvers(m, "secded")
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(9),
                         echo=lambda s: None)
    r2 = fus(make_matrix_device(m2, jnp.float32), b)
    assert int(r2.stats.errcode) == 0
    assert int(r2.stats.corrected_count) == 1
    np.testing.assert_array_equal(np.asarray(r2.x), np.asarray(r1.x))


def test_fused_rolled_corrects_fault():
    m = wideband_matrix("secded")
    md, _, fus = solvers(m, "secded")
    b = bvec(m)
    clean = fus(md, b)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(4),
                         echo=lambda s: None)
    md2 = make_matrix_device(m2, jnp.float32)
    r = fus(md2, b)
    assert int(r.stats.errcode) == 0
    assert int(r.stats.corrected_count) == 1
    assert int(r.iterations) == int(clean.iterations)
    np.testing.assert_array_equal(np.asarray(r.x), np.asarray(clean.x))


# --------------------------------------------------------------------------
# Multi-program grids: small row blocks that do not divide R, so the
# last program is masked
# --------------------------------------------------------------------------

_RAGGED_N = 1100      # R = 1152: 4.5 blocks of 256 rows
_RAGGED_BLOCK = 256


def solvers_streaming(m, mode, max_itrs=300, conv=1e-8):
    assert m.R % _RAGGED_BLOCK != 0
    return solvers(m, mode, max_itrs, conv, block_rows=_RAGGED_BLOCK)


@pytest.mark.parametrize("layout", ["dia", "ell", "rcm-ell"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "sec8", "secded"])
def test_streaming_matches_jnp_clean(mode, layout):
    m = make(layout, mode, _RAGGED_N)
    md, ref, fus = solvers_streaming(m, mode)
    b = bvec(m)
    r0, r1 = ref(md, b), fus(md, b)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)
    k = int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.rr_trace)[:k],
                               np.asarray(r0.rr_trace)[:k], rtol=1e-4)
    assert np.isnan(np.asarray(r1.rr_trace)[k:]).all()


@pytest.mark.parametrize("layout", ["dia", "ell"])
@pytest.mark.parametrize("mode", ["sec8", "secded"])
def test_streaming_corrects_fault_and_resumes(mode, layout):
    m = make(layout, mode, _RAGGED_N)
    md, _, fus = solvers_streaming(m, mode)
    b = bvec(m)
    clean = fus(md, b)
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        md2 = make_matrix_device(m2, jnp.float32)
        r = fus(md2, b)
        assert int(r.stats.errcode) == 0, seed
        assert int(r.stats.corrected_count) == 1, seed
        assert int(r.iterations) == int(clean.iterations)
        np.testing.assert_array_equal(np.asarray(r.x),
                                      np.asarray(clean.x))


@pytest.mark.parametrize("layout", ["dia", "ell"])
def test_streaming_lazy_schedule(layout):
    """check_interval > 1 over a masked multi-program grid: clean solve
    bit-exact vs live, fault corrected via rollback."""
    m = make(layout, "secded", _RAGGED_N)
    md, _, fus = solvers_streaming(m, "secded")
    product = make_pallas_product(m, jnp.float32, "secded",
                                  interpret=True, block_rows=_RAGGED_BLOCK)
    lazy = jax.jit(make_lazy_ci_solver(
        kernel_spmv(m, "secded", block_rows=_RAGGED_BLOCK), product, 4,
        300, 1e-8))
    b = bvec(m)
    clean = fus(md, b)
    r4 = lazy(md, b)
    assert int(r4.stats.errcode) == 0
    assert int(r4.iterations) == int(clean.iterations)
    np.testing.assert_array_equal(np.asarray(r4.x), np.asarray(clean.x))
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(8),
                         echo=lambda s: None)
    r = lazy(make_matrix_device(m2, jnp.float32), b)
    assert int(r.stats.errcode) == 0
    assert int(r.stats.corrected_count) == 1
    assert int(r.iterations) == int(clean.iterations)
    np.testing.assert_array_equal(np.asarray(r.x), np.asarray(clean.x))


def test_streaming_sed_detects_and_halts():
    m = ell_matrix("sed", _RAGGED_N)
    md, ref, fus = solvers_streaming(m, "sed")
    b = bvec(m)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(3),
                         echo=lambda s: None)
    md2 = make_matrix_device(m2, jnp.float32)
    r0, r1 = ref(md2, b), fus(md2, b)
    assert int(r1.stats.errcode) == int(r0.stats.errcode) == 1
    assert int(r1.iterations) == int(r0.iterations) == 0


def test_streaming_breakdown_guard():
    """A discarded (broken-down) iteration leaves x/r/p intact."""
    m = ell_matrix("none", _RAGGED_N)
    planes = {k: v.copy() for k, v in m.planes.items()}
    from abft_sparse_cg.ecc.values import planes_to_f64_np
    vals = planes_to_f64_np(planes["value_lo"], planes["value_hi"])
    neg = (-vals).view(np.uint64)
    planes["value_lo"] = (neg & 0xFFFFFFFF).astype(np.uint32)
    planes["value_hi"] = (neg >> 32).astype(np.uint32)
    m2 = m.with_planes(planes)
    md = make_matrix_device(m2, jnp.float32)
    fus = jax.jit(make_cg_solver(
        kernel_spmv(m2, "none", block_rows=_RAGGED_BLOCK), 100, 1e-8))
    r = fus(md, bvec(m))
    assert int(r.stats.errcode) == ERR_BREAKDOWN
    assert int(r.iterations) == 0


@pytest.mark.parametrize("mode", ["none", "secded"])
def test_streaming_jacobi_matches_jnp(mode):
    m = ell_matrix(mode, _RAGGED_N)
    md, ref, fus = solvers_streaming(m, mode)
    b = bvec(m)
    minv = jacobi(m)
    r0, r1 = ref(md, b, minv), fus(md, b, minv)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-6, atol=1e-7)


def test_kernel_grid_at_bench_scale_lowers_for_cuda():
    """At the -b 100 size (8,192,000 rows) the ELL kernel is one
    pallas_call over 8,000 row-block programs, and it lowers to the
    Triton custom call for CUDA — traced from shapes alone, nothing is
    allocated."""
    import types

    from abft_sparse_cg.ops import spmv_pallas
    from abft_sparse_cg.ops.spmv import MatrixDevice

    m = ell_matrix("secded")
    R, K = 8192 * 1000, 3
    big = types.SimpleNamespace(exec_kind="ell", R=R, N=R, K=K,
                                layout=m.layout, perm=None,
                                ell_gather_word=m.ell_gather_word,
                                fmt="csr", mode="secded")
    fast_pw = spmv_pallas._make_kernel(big, "secded", False, True)
    u32 = jnp.uint32
    words = tuple(jax.ShapeDtypeStruct((K, R), u32)
                  for _ in m.layout.word_names)
    md = MatrixDevice(
        words=words, ell_len=jax.ShapeDtypeStruct((R,), jnp.int32),
        cksum=None, values=jax.ShapeDtypeStruct((K, R), jnp.float32),
        fold=jax.ShapeDtypeStruct((K, R), u32),
        fold_ck=jax.ShapeDtypeStruct((1, R // 8), u32))
    x = jax.ShapeDtypeStruct((R,), jnp.float32)
    text = jax.jit(fast_pw).trace(md, x).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "tensor<8000xi32>" in text       # one trigger flag per program
