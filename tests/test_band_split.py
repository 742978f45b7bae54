"""Band split: wide-band general matrices = banded core + flat tail.

The banded kernels' shuffle window caps the representable bandwidth at
1920; matrices beyond it used to ride the serialized XLA-gather
fallback whole.  try_band_split peels the out-of-band entries into a
flat tail so the core keeps the compiled tier.
"""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import spmv_dense_oracle

RNG = np.random.default_rng(4242)


def wide_band(n=32768, every=8, blocks=1, seed=5):
    """Tridiagonal core + a sparse random matching (~1/8 shortcut per
    node).  In the natural order the matching spans ~n — past the
    16256 scan-tier cap, so no whole-matrix kernel exists and the cost
    model peels the out-of-band entries (~6%) into the flat tail: the
    band split's target shape.  RCM *can* reband this small-world
    graph (band 3236, scan-tier whole — the calibrated model correctly
    keeps it whole), so the split tests build with reorder="none"."""
    rows = list(range(n)) + list(range(1, n))
    cols = list(range(n)) + list(range(n - 1))
    vals = [8.0] * n + [-1.0] * (n - 1)
    rng = np.random.default_rng(seed)
    for i in range(0, n, every):
        j = int(rng.integers(0, n))
        if abs(j - i) > 3:
            rows.append(max(i, j))
            cols.append(min(i, j))
            vals.append(-0.5)
    a = assemble(np.array(cols), np.array(rows), np.array(vals, float),
                 n, blocks)
    return a


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_wide_band_selects_band_split(fmt):
    a = wide_band()
    m = build_protected(fmt, a, "secded", reorder="none")
    assert m.exec_kind == "split"
    assert m.main.exec_kind in ("dia", "ell")
    assert m.main.band <= 16256          # a wide main
    assert m.tail.exec_kind == "flat"
    assert m.tail.nnz <= 0.10 * a.nnz
    assert m.main.nnz + m.tail.nnz == a.nnz
    # opt-out keeps the single-layout build
    m2 = build_protected(fmt, a, "secded", split="none", reorder="none")
    assert m2.exec_kind != "split"
    # with RCM allowed, band 3236 is whole-matrix-eligible: unsplit,
    # permuted ELL on the kernel route
    m3 = build_protected(fmt, a, "secded")
    assert m3.exec_kind == "ell" and m3.perm is not None


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "constraints", "sed", "sec7",
                                  "sec8", "secded"])
def test_band_split_spmv_and_solve(fmt, mode):
    a = wide_band()
    m = build_protected(fmt, a, mode, reorder="none")
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
def test_band_split_fault_events_match_unsplit(mode):
    """Same injection seed -> identical banners/events whether the
    matrix was band-split or kept whole (global canonical indexing)."""
    a = wide_band()
    b = RNG.random(a.N)
    results = {}
    for split in ("auto", "none"):
        m = build_protected("csr", a, mode, split=split, reorder="none")
        assert (m.exec_kind == "split") == (split == "auto")
        for seed in range(4):
            banners = []
            m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                                 echo=banners.append)
            res = create("jnp", mode).solve(m2, b, 2000, 1e-10,
                                            verbose=False, dtype="f64")
            results[(split, seed)] = (banners, res.errcode, res.err_index,
                                      res.corrected_count, res.messages)
    for seed in range(4):
        assert results[("auto", seed)] == results[("none", seed)], seed


def test_band_split_pallas_kernel_tier():
    """The composite's main part rides the ELL kernel (interpret mode);
    full solve matches the jnp oracle."""
    import jax
    import jax.numpy as jnp

    from abft_sparse_cg.ops.spmv import make_matrix_device, make_spmv
    from abft_sparse_cg.ops.spmv_pallas import make_pallas_spmv, route_for
    from abft_sparse_cg.solver.cg import make_cg_solver

    a = wide_band()
    m = build_protected("csr", a, "secded", reorder="none")
    assert m.exec_kind == "split"
    assert route_for(m.main, "gpu") == "triton-ell"
    md = make_matrix_device(m, jnp.float32)
    b = np.zeros(m.R)
    b[: m.N] = RNG.random(m.N)
    bdev = jnp.asarray(b, jnp.float32)
    impl = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    ref = jax.jit(make_cg_solver(make_spmv(m, jnp.float32, "secded"),
                                 300, 1e-8))
    fus = jax.jit(make_cg_solver(impl, 300, 1e-8))
    r0, r1 = ref(md, bdev), fus(md, bdev)
    assert int(r1.stats.errcode) == 0
    assert int(r1.iterations) == int(r0.iterations)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-5, atol=1e-6)
    # injected fault: detected, corrected, resumed
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(7),
                         echo=lambda s: None)
    md2 = make_matrix_device(m2, jnp.float32)
    r2 = fus(md2, bdev)
    assert int(r2.stats.errcode) == 0
    assert int(r2.stats.corrected_count) == 1
