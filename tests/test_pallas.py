"""The pallas target's Triton kernel vs the jnp oracle (interpreter
mode on CPU), their CUDA lowering, and the target's routing table."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import make_matrix_device, make_spmv
from abft_sparse_cg.ops.spmv_pallas import (ROUTES, make_pallas_product,
                                            make_pallas_spmv, route_for,
                                            route_name)
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(5)


def protected(mode, fmt="csr", n=200, blocks=2):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    return build_protected(fmt, a, mode)


def device_matrix(m):
    return make_matrix_device(m, jnp.float32)


def assert_within_sum_bound(m, md, x, *products):
    """Each product against the exact sum of the same f32 operands: a
    row's error stays within the dot-product bound gamma_K * sum|v x|,
    which every summation order meets.  The ELL kernel adds its slots in
    order, XLA's reduction in an order of its own, so where a row's
    terms cancel the two differ by more than an elementwise rtol of the
    result."""
    from abft_sparse_cg.ecc import ECC_COL_MASK
    from abft_sparse_cg.ecc.codec import ECC_MODES
    from abft_sparse_cg.ops.spmv import exec_gather_host

    if m.perm is not None:
        g = exec_gather_host(m).astype(np.int64)
    else:
        g = m.ell[m.ell_gather_word].astype(np.int64)
        if m.mode in ECC_MODES and m.ell_gather_word == "col":
            g &= ECC_COL_MASK
    K = g.shape[0]
    valid = np.arange(K)[:, None] < np.asarray(m.ell_len)[None, :]
    xs = np.asarray(x, np.float64)[np.clip(g, 0, m.R - 1)]
    terms = np.where(valid, np.asarray(md.values, np.float64) * xs, 0.0)
    u = 2.0 ** -24
    bound = K * u / (1 - K * u) * np.abs(terms).sum(axis=0)
    exact = terms.sum(axis=0)
    for w in products:
        err = np.abs(np.asarray(w, np.float64) - exact)
        assert (err <= bound).all(), float((err - bound).max())


def test_supports_policy():
    """The routing table: the kernel on a GPU for ELL planes, the plain
    live version for DIA, on the CPU and under a mesh."""
    m = protected("secded")
    assert m.exec_kind == "dia"
    assert route_for(m, "gpu") == "xla-live"
    e = protected_ell("secded")
    assert route_for(e, "gpu") == "triton-ell"
    for mat in (m, e):
        assert route_for(mat, "cpu") == "xla-live"
        assert route_name(mat, "gspmd") == "xla-live (gspmd)"
    assert set(ROUTES) == {"triton-ell", "xla-live"}


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "sec8", "secded"])
def test_fast_kernel_matches_jnp(fmt, mode):
    """The Pallas fast kernel: same w, no trigger on a clean matrix."""
    m = protected(mode, fmt)
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl_p = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    impl_j = make_spmv(m, jnp.float32, mode)
    if mode == "none":
        wp, _ = jax.jit(impl_p.full)(md, x)
        wj, _ = jax.jit(impl_j.full)(md, x)
    else:
        wp, trig_p = jax.jit(impl_p.fast)(md, x)
        wj, trig_j = jax.jit(impl_j.fast)(md, x)
        assert not bool(trig_p) and not bool(trig_j)
    np.testing.assert_allclose(np.asarray(wp), np.asarray(wj), rtol=1e-6)


@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_fast_kernel_triggers_on_fault(mode):
    m = protected(mode)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        _, trig = jax.jit(impl.fast)(device_matrix(m2), x)
        assert bool(trig), f"seed {seed}: single-bit fault missed by {mode}"


def test_secded_double_fault_triggers():
    m = protected("secded")
    impl = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    for seed in range(10):
        m2 = inject_bitflips(m, "ANY", 2, np.random.default_rng(seed),
                             echo=lambda s: None)
        if any((m2.planes[n] != m.planes[n]).any() for n in m.layout.word_names):
            _, trig = jax.jit(impl.fast)(device_matrix(m2), x)
            assert bool(trig)
            return
    pytest.fail("no corrupting double flip found")


@pytest.mark.parametrize("mode", ["sec7", "sec8", "secded"])
def test_backend_solve_corrects(mode):
    """Full pallas-target solve: fast loop -> classify -> scrubbed resume."""
    m = protected(mode, n=128, blocks=2)
    b = RNG.random(m.N)
    backend = create("pallas", mode)
    clean = backend.solve(m, b, 500, 1e-6, verbose=False, dtype="f32")
    assert not clean.failed and clean.corrected_count == 0

    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(7), echo=lambda s: None)
    res = backend.solve(m2, b, 500, 1e-6, verbose=False, dtype="f32")
    assert not res.failed
    assert res.corrected_count == 1
    assert res.iterations == clean.iterations
    np.testing.assert_allclose(res.x, clean.x, rtol=1e-5)


def test_backend_solve_sed_halts():
    m = protected("sed", n=128, blocks=2)
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(1), echo=lambda s: None)
    res = create("pallas", "sed").solve(m2, b, 500, 1e-6, verbose=False, dtype="f32")
    assert res.failed and res.errcode == 1
    assert any("error detected at index" in s for s in res.messages)


def protected_ell(mode, fmt="csr", n=200, blocks=2, shuffle=False):
    """Forced-ELL matrix for the banded windowed-gather kernel; with
    ``shuffle`` the band only exists after the RCM permutation."""
    from abft_sparse_cg.utils.matgen import shuffle_labels

    tri = spd_tridiagonal(n)
    if shuffle:
        tri = shuffle_labels(*tri, seed=3)
    a = assemble(tri[1], tri[0], tri[2], tri[3], blocks)
    return build_protected(fmt, a, mode, force_exec="ell")


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "sec8", "secded"])
def test_ellb_kernel_matches_jnp(mode, shuffle):
    """Banded-ELL windowed gather: bit-identical product, no trigger."""
    m = protected_ell(mode, shuffle=shuffle)
    assert route_for(m, "gpu") == "triton-ell" and m.exec_kind == "ell"
    assert (m.perm is not None) == shuffle
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl_p = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    impl_j = make_spmv(m, jnp.float32, mode)
    if mode == "none":
        wp, _ = jax.jit(impl_p.full)(md, x)
        wj, _ = jax.jit(impl_j.full)(md, x)
    else:
        wp, trig_p = jax.jit(impl_p.fast)(md, x)
        wj, trig_j = jax.jit(impl_j.fast)(md, x)
        assert not bool(trig_p) and not bool(trig_j)
    np.testing.assert_array_equal(np.asarray(wp), np.asarray(wj))


@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_ellb_kernel_triggers_on_fault(mode):
    m = protected_ell(mode, shuffle=True)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        _, trig = jax.jit(impl.fast)(device_matrix(m2), x)
        assert bool(trig), f"seed {seed}: single-bit fault missed by {mode}"


def test_constraints_pairs_kernel_with_checks():
    """Constraints mode: the kernel computes w, the jnp structural checks
    run alongside — violations still fail exactly like the jnp target."""
    m = protected_ell("constraints")
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl_p = make_pallas_spmv(m, jnp.float32, "constraints", interpret=True)
    impl_j = make_spmv(m, jnp.float32, "constraints")
    wp, sp_ = jax.jit(impl_p.full)(md, x)
    wj, sj = jax.jit(impl_j.full)(md, x)
    assert int(sp_.errcode) == int(sj.errcode) == 0
    np.testing.assert_array_equal(np.asarray(wp), np.asarray(wj))
    # Corrupt a column index out of range: both implementations flag it.
    planes = {k: v.copy() for k, v in m.planes.items()}
    planes["col"][7] |= np.uint32(1 << 23)
    m2 = m.with_planes(planes)
    md2 = device_matrix(m2)
    _, s2 = jax.jit(impl_p.full)(md2, x)
    _, s2j = jax.jit(impl_j.full)(md2, x)
    assert int(s2.errcode) == int(s2j.errcode) != 0
    assert int(s2.err_slot) == int(s2j.err_slot)


def test_ellb_high_k_matrix():
    """A banded matrix with ~24 entries per row through the ELL kernel
    matches jnp."""
    n, half = 512, 12
    rows, cols, vals = [], [], []
    rng = np.random.default_rng(8)
    for off in range(0, half):
        idx = np.arange(n - off)
        rows.append(idx + off)
        cols.append(idx)
        vals.append(-rng.random(n - off) * 0.05)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.concatenate(vals)
    diag = rows == cols
    vals[diag] = 2.0 * half  # diagonally dominant -> SPD
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded", force_exec="ell")
    assert m.K > 16 and route_for(m, "gpu") == "triton-ell"
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl_p = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    impl_j = make_spmv(m, jnp.float32, "secded")
    wp, tp = jax.jit(impl_p.fast)(md, x)
    wj, tj = jax.jit(impl_j.fast)(md, x)
    assert not bool(tp) and not bool(tj)
    assert_within_sum_bound(m, md, x, wp, wj)


def protected_wideband(mode, n=4096, b=2500, k=3, seed=2):
    """Uniformly wide band (random in-band neighbors): x reads span
    many row blocks."""
    rng = np.random.default_rng(seed)
    rows, cols = [np.arange(n)], [np.arange(n)]
    for _ in range(k):
        d = rng.integers(1, b, n)
        i = np.arange(n)
        keep = i + d < n
        rows.append((i + d)[keep])
        cols.append(i[keep])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, 30.0, -1.0)
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, mode, reorder="none",
                        force_exec="ell")
    assert m.exec_kind == "ell" and m.band > 1920
    return m


@pytest.mark.parametrize("mode", ["none", "sed", "secded"])
def test_ellb_wideband_kernel_matches_jnp(mode):
    """Band > 1920: the ELL kernel's indexed loads reach across row
    blocks, matching jnp."""
    m = protected_wideband(mode)
    assert route_for(m, "gpu") == "triton-ell"
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl_p = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    impl_j = make_spmv(m, jnp.float32, mode)
    if mode == "none":
        wp, _ = jax.jit(impl_p.full)(md, x)
        wj, _ = jax.jit(impl_j.full)(md, x)
    else:
        wp, trig_p = jax.jit(impl_p.fast)(md, x)
        wj, trig_j = jax.jit(impl_j.fast)(md, x)
        assert not bool(trig_p) and not bool(trig_j)
    # The kernel's sequential slot sums and XLA's tree reduce
    # reassociate differently (1-2 ulp; small-magnitude entries need the
    # atol), as in the high-K case above.
    np.testing.assert_allclose(np.asarray(wp), np.asarray(wj),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["sed", "secded"])
def test_ellb_wideband_triggers_on_fault(mode):
    m = protected_wideband(mode)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    for seed in range(3):
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                             echo=lambda s: None)
        _, trig = jax.jit(impl.fast)(device_matrix(m2), x)
        assert bool(trig), f"seed {seed}: single-bit fault missed"


def test_k1_ell_kernel():
    """K=1 ELL (one entry per row, too many distinct offsets for DIA)
    through the ELL kernel."""
    n = 2048
    rng = np.random.default_rng(4)
    # Value-only entries: one off-diagonal per row at a random offset
    # would not be SPD; a diagonal matrix with shuffled row labels keeps
    # K=1 while defeating DIA adoption via force_exec.
    rows = cols = np.arange(n)
    vals = rng.random(n) + 1.0
    a = assemble(cols, rows, vals, n, 1)
    m = build_protected("csr", a, "secded", force_exec="ell")
    assert m.exec_kind == "ell" and m.K == 1
    assert route_for(m, "gpu") == "triton-ell"
    impl = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    w, s = jax.jit(impl.full)(md, x)
    assert int(s.errcode) == 0
    np.testing.assert_allclose(np.asarray(w)[: m.N],
                               vals * np.asarray(x)[: m.N], rtol=1e-6)


def test_wide_band_past_split_rides_flat():
    """A label shuffle with reordering disabled: band-split by default
    (tests/test_routing.py); with the split ALSO disabled the build
    lands on the flat layout, which the pallas target runs as the plain
    live version on every platform."""
    from abft_sparse_cg.utils.matgen import shuffle_labels

    tri = shuffle_labels(*spd_tridiagonal(32768), seed=1)
    a = assemble(tri[1], tri[0], tri[2], tri[3], 1)
    m_split = build_protected("csr", a, "secded", reorder="none")
    assert m_split.exec_kind == "split"
    assert route_name(m_split, "gpu").startswith("split(triton-")

    m_flat = build_protected("csr", a, "secded", reorder="none",
                             split="none")
    assert m_flat.exec_kind == "flat"
    assert route_for(m_flat, "gpu") == "xla-live"
    impl = make_pallas_spmv(m_flat, jnp.float32, "secded",
                            interpret=True)
    md = device_matrix(m_flat)
    x = jnp.asarray(RNG.random(m_flat.R), jnp.float32)
    w, s = jax.jit(impl.full)(md, x)
    assert int(s.errcode) == 0


@pytest.mark.parametrize("half", [32, 64, 127])
def test_ellb_slot_count_past_64(half):
    """K in {65, 129, 255} ELL slots through the ELL kernel (the
    reference's row gather handles any degree uniformly,
    CSR/CPUContext.cpp:115-133).  Dense band forced to ELL; K =
    2*half+1."""
    from abft_sparse_cg.utils.matgen import spd_denseband

    r, c, v, n = spd_denseband(512, half)
    a = assemble(c, r, v, n, 1)
    m = build_protected("csr", a, "secded", force_exec="ell")
    assert m.K == 2 * half + 1 and m.exec_kind == "ell"
    assert route_for(m, "gpu") == "triton-ell"
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl_p = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    impl_j = make_spmv(m, jnp.float32, "secded")
    wp, tp = jax.jit(impl_p.fast)(md, x)
    wj, tj = jax.jit(impl_j.fast)(md, x)
    assert not bool(tp) and not bool(tj)
    assert_within_sum_bound(m, md, x, wp, wj)
    # Detection still triggers at this K: flip a stored codeword bit.
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(3),
                         echo=lambda s: None)
    md2 = device_matrix(m2)
    _, t2 = jax.jit(impl_p.fast)(md2, x)
    assert bool(t2)


def test_ell_slot_count_past_512_kernel():
    """K = 601 slots per row through the ELL kernel, matching jnp."""
    from abft_sparse_cg.utils.matgen import spd_denseband

    r, c, v, n = spd_denseband(2048, 300)   # K = 601
    a = assemble(c, r, v, n, 1)
    m = build_protected("csr", a, "secded", force_exec="ell")
    assert m.K == 601 and route_for(m, "gpu") == "triton-ell"
    impl = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    w, s = jax.jit(impl.full)(md, x)
    wj, _ = jax.jit(make_spmv(m, jnp.float32, "secded").full)(md, x)
    assert int(s.errcode) == 0
    assert_within_sum_bound(m, md, x, w, wj)


def test_ellb_slot_count_past_64_coo():
    """COO format (4-word codewords): K=129 through the ELL kernel with
    the fold-plane signals."""
    from abft_sparse_cg.utils.matgen import spd_denseband

    r, c, v, n = spd_denseband(512, 64)
    a = assemble(c, r, v, n, 1)
    m = build_protected("coo", a, "secded", force_exec="ell")
    assert m.K == 129 and route_for(m, "gpu") == "triton-ell"
    md = device_matrix(m)
    x = jnp.asarray(RNG.random(m.R), jnp.float32)
    impl_p = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    impl_j = make_spmv(m, jnp.float32, "secded")
    wp, tp = jax.jit(impl_p.fast)(md, x)
    wj, tj = jax.jit(impl_j.fast)(md, x)
    assert not bool(tp) and not bool(tj)
    assert_within_sum_bound(m, md, x, wp, wj)


# --------------------------------------------------------------------------
# CUDA cross-lowering: every kernel variant lowers to the Triton custom
# call (checked on CPU; the GPU compiles what this emits)
# --------------------------------------------------------------------------

TRITON_CALL = "__gpu$xla.gpu.triton"


@pytest.mark.parametrize("n", [1000, 1100])        # R = 1024 / ragged 1152
@pytest.mark.parametrize("product", [False, True])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "secded",
                                  "constraints"])
@pytest.mark.parametrize("layout", ["dia", "ell", "rcm-ell"])
def test_kernel_lowers_for_cuda(layout, mode, product, n):
    """ELL lowers to exactly one Triton call; DIA's route is plain XLA
    and lowers none."""
    tri = spd_tridiagonal(n)
    if layout == "rcm-ell":
        from abft_sparse_cg.utils.matgen import shuffle_labels

        tri = shuffle_labels(*tri, seed=3)
    a = assemble(tri[1], tri[0], tri[2], tri[3], 1)
    m = build_protected("csr", a, mode,
                        force_exec=None if layout == "dia" else "ell")
    make = make_pallas_product if product else make_pallas_spmv
    impl = make(m, jnp.float32, mode, platform="gpu")
    md = device_matrix(m)
    x = jnp.zeros(m.R, jnp.float32)
    text = jax.jit(impl.fast_pw).trace(md, x).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count(TRITON_CALL) == (0 if layout == "dia" else 1)


def test_xla_live_route_has_no_custom_call():
    """The flat layout's route is plain XLA: no Triton call lowered."""
    m = build_protected("csr", assemble(*_flat_args()), "secded",
                        force_exec="flat")
    impl = make_pallas_spmv(m, jnp.float32, "secded", platform="gpu")
    text = jax.jit(impl.fast_pw).trace(
        device_matrix(m), jnp.zeros(m.R, jnp.float32)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert TRITON_CALL not in text


def _flat_args():
    rows, cols, vals, n = spd_tridiagonal(300)
    return cols, rows, vals, n, 1


@pytest.mark.parametrize("mode", ["none", "secded"])
def test_kernel_f64_matches_jnp(mode):
    """Binary64 compute through the kernel (the GPU computes f64
    natively): same product as the jnp f64 path."""
    m = protected_ell(mode)
    md = make_matrix_device(m, jnp.float64)
    x = jnp.asarray(RNG.random(m.R), jnp.float64)
    w, trig, _ = jax.jit(make_pallas_spmv(m, jnp.float64, mode,
                                          interpret=True).fast_pw)(md, x)
    wj, _ = jax.jit(make_spmv(m, jnp.float64, mode).full)(md, x)
    assert not bool(trig)
    np.testing.assert_allclose(np.asarray(w), np.asarray(wj), rtol=1e-14)


def test_solve_jaxpr_has_no_dot_general():
    """No matrix product on the solve path: the dots are elementwise
    multiply + sum, so a GPU's TF32 matmul mode cannot touch them."""
    from abft_sparse_cg.solver.cg import make_cg_solver

    m = protected_ell("secded")
    md = device_matrix(m)
    b = jnp.ones(m.R, jnp.float32)
    for impl in (make_spmv(m, jnp.float32, "secded"),
                 make_pallas_spmv(m, jnp.float32, "secded",
                                  interpret=True)):
        jaxpr = jax.make_jaxpr(make_cg_solver(impl, 50, 1e-8))(md, b)
        assert "dot_general" not in str(jaxpr)
