"""Unstructured/expander SpMV on the pallas target: the flat exec
layout rides the plain live version (XLA gather + segment-sum, the
detection stream re-read every iteration) on every platform.

Pins the product against the dense oracle on matrices with no banded
structure, the detection/heal contract on injected faults, the lazy
detection-free product, and the routing through make_pallas_spmv.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import (
    make_matrix_device,
    make_spmv,
    spmv_dense_oracle,
)
from abft_sparse_cg.ops.spmv_pallas import (make_pallas_product,
                                            make_pallas_spmv, route_for)
from abft_sparse_cg.solver.cg import make_cg_solver

RNG = np.random.default_rng(7)


def random_graph(n=300, edges=900, seed=3, fmt="csr", mode="secded"):
    """SPD graph Laplacian with uniformly random edges — no banded
    structure at any ordering (the expander shape)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, n, edges)
    c = (rng.random(edges) * r).astype(np.int64)
    ij = np.unique(np.stack([r, c]), axis=1)
    r, c = ij[0], ij[1]
    vals = -rng.random(len(r))
    dv = np.zeros(n)
    np.add.at(dv, r, np.abs(vals))
    np.add.at(dv, c, np.abs(vals))
    rows = np.concatenate([r, np.arange(n)])
    cols = np.concatenate([c, np.arange(n)])
    vv = np.concatenate([vals, dv + 1.0])
    a = assemble(cols, rows, vv, n, 1)
    return build_protected(fmt, a, mode, force_exec="flat")


def make_unstructured_spmv(m, dtype, mode):
    """The pallas target's SpMV for a flat matrix, routed as on a GPU."""
    return make_pallas_spmv(m, dtype, mode, platform="gpu")


def exec_product(m, impl, xc):
    xe = np.zeros(m.R, np.float32)
    xe[: m.N] = m.to_exec_order(xc)
    md = make_matrix_device(m, jnp.float32)
    if impl.fast is not None:
        w, trig = impl.fast(md, jnp.asarray(xe))
    else:                      # mode none: the pw pair is the hot path
        w, trig, _pw = impl.fast_pw(md, jnp.asarray(xe))
    return m.from_exec_order(np.asarray(w)[: m.N]), bool(trig)


@pytest.mark.parametrize("fmt,mode", [
    ("csr", "secded"), ("csr", "none"), ("csr", "sec7"),
    ("csr", "constraints"), ("coo", "secded"), ("coo", "sed"),
])
def test_product_matches_oracle(fmt, mode):
    m = random_graph(fmt=fmt, mode=mode)
    assert m.exec_kind == "flat" and route_for(m, "gpu") == "xla-live"
    impl = make_unstructured_spmv(m, jnp.float32, mode)
    xc = RNG.random(m.N)
    w, trig = exec_product(m, impl, xc)
    oracle = spmv_dense_oracle(m, xc)
    assert not trig
    np.testing.assert_allclose(w, oracle,
                               rtol=1e-5, atol=1e-5 * np.abs(oracle).max())


def test_matches_jnp_flat_bitexact():
    """Identical arithmetic ordering is not required, but the result
    must agree with the jnp flat path to f32 roundoff on every row."""
    m = random_graph()
    ui = make_unstructured_spmv(m, jnp.float32, "secded")
    ji = make_spmv(m, jnp.float32, "secded")
    xc = RNG.random(m.N)
    wu, _ = exec_product(m, ui, xc)
    wj, _ = exec_product(m, ji, xc)
    np.testing.assert_allclose(wu, wj, rtol=1e-5,
                               atol=1e-5 * np.abs(wj).max())


def test_pallas_routing_picks_xla_live():
    """make_pallas_spmv routes flat matrices to the plain live version
    (and the detection-free product exists for the lazy schedule)."""
    m = random_graph()
    impl = make_pallas_spmv(m, jnp.float32, "secded", interpret=True)
    md = make_matrix_device(m, jnp.float32)
    xe = np.zeros(m.R, np.float32)
    xe[: m.N] = m.to_exec_order(RNG.random(m.N))
    w, trig = impl.fast(md, jnp.asarray(xe))
    assert w.shape == (m.R,)
    prod = make_pallas_product(m, jnp.float32, "secded", interpret=True)
    assert prod is not None
    w2, trig2 = prod.fast(md, jnp.asarray(xe))
    np.testing.assert_array_equal(np.asarray(w), np.asarray(w2))
    assert not bool(trig2)


def test_solver_detects_corrects_and_heals():
    """Full CG on the flat route with an injected fault: the live
    trigger fires, classify corrects and re-derives the device planes,
    and the solve converges to the clean solution."""
    m = random_graph(n=256, edges=700, seed=11)
    b = RNG.random(m.N)
    impl = make_unstructured_spmv(m, jnp.float32, "secded")
    solver = jax.jit(make_cg_solver(impl, 400, 1e-8))

    def run(mat):
        md = make_matrix_device(mat, jnp.float32)
        bpad = np.zeros(mat.R)
        bpad[: mat.N] = mat.to_exec_order(b)
        return solver(md, jnp.asarray(bpad, jnp.float32))

    clean = run(m)
    assert int(clean.stats.errcode) == 0
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(5),
                         echo=lambda s: None)
    res = run(m2)
    assert int(res.stats.errcode) == 0
    assert int(res.stats.corrected_count) >= 1
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(clean.x),
                               rtol=1e-4, atol=1e-5)


def test_sed_detects_and_failstops():
    m = random_graph(n=256, edges=700, seed=11, mode="sed")
    b = RNG.random(m.N)
    impl = make_unstructured_spmv(m, jnp.float32, "sed")
    solver = jax.jit(make_cg_solver(impl, 400, 1e-8))
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(5),
                         echo=lambda s: None)
    md = make_matrix_device(m2, jnp.float32)
    bpad = np.zeros(m2.R)
    bpad[: m2.N] = m2.to_exec_order(b)
    res = solver(md, jnp.asarray(bpad, jnp.float32))
    assert int(res.stats.errcode) != 0


def test_hub_row_matches_oracle():
    """A star graph (one hub touching every node): the hub row's
    1,200 entries reduce through the segment-sum like any other."""
    n = 1200
    r = np.arange(1, n)
    c = np.zeros(n - 1, np.int64)
    vals = -np.ones(n - 1) * 0.5
    rows = np.concatenate([r, np.arange(n)])
    cols = np.concatenate([c, np.arange(n)])
    dv = np.zeros(n)
    dv[0] = 0.5 * (n - 1)
    dv[1:] += 0.5
    vv = np.concatenate([vals, dv + 1.0])
    m = build_protected("csr", assemble(cols, rows, vv, n, 1),
                        "secded", force_exec="flat")
    impl = make_unstructured_spmv(m, jnp.float32, "secded")
    xc = RNG.random(m.N)
    w, _ = exec_product(m, impl, xc)
    oracle = spmv_dense_oracle(m, xc)
    np.testing.assert_allclose(w, oracle, rtol=1e-5,
                               atol=1e-5 * np.abs(oracle).max())


def test_lazy_ci_clean_matches_live():
    """The lazy --check-interval schedule on the flat route: unchecked
    iterations run the detection-free product — clean solves track the
    live schedule."""
    from abft_sparse_cg.solver.cg import make_lazy_ci_solver

    m = random_graph(n=256, edges=700, seed=11)
    b = RNG.random(m.N)
    impl = make_unstructured_spmv(m, jnp.float32, "secded")
    product = make_pallas_product(m, jnp.float32, "secded",
                                  interpret=True)
    assert product is not None
    live = jax.jit(make_cg_solver(impl, 200, 1e-8))
    lazy = jax.jit(make_lazy_ci_solver(impl, product, 4, 200, 1e-8))
    md = make_matrix_device(m, jnp.float32)
    bpad = np.zeros(m.R)
    bpad[: m.N] = m.to_exec_order(b)
    bdev = jnp.asarray(bpad, jnp.float32)
    r1, r2 = live(md, bdev), lazy(md, bdev)
    assert int(r1.stats.errcode) == 0 and int(r2.stats.errcode) == 0
    assert int(r1.iterations) == int(r2.iterations)
    # The products are bit-equal (test_pallas_routing_picks_xla_live
    # asserts it); the two loop bodies still compile separately and XLA
    # may reassociate a BLAS-1 reduction differently, so the
    # trajectories track to ulp-level rather than bit-exactly.
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                               rtol=2e-6, atol=2e-7)
