"""Fences around the documented detection-scope deviations (PARITY.md).

The fast paths detect even-weight multi-element faults through XOR
checksums over stored 8-row blocks — the jnp fast path over each word
plane, the pallas target's kernels over the rotated fold plane (ecc.fold)
— so cancellation escapes only within one block.

secded keeps the per-element parity mask, so multi-element single-bit
faults are detected at full granularity on every route.  These tests
execute the exact boundary so a regression cannot silently widen a
blind spot.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.ops.spmv import make_matrix_device, make_spmv
from abft_sparse_cg.ops.spmv_pallas import make_pallas_spmv
from abft_sparse_cg.utils.matgen import spd_tridiagonal

N = 16384  # two 8192-row chunks for the per-iteration kernel


def dia_mat(mode):
    rows, cols, vals, n = spd_tridiagonal(N)
    m = build_protected("csr", assemble(cols, rows, vals, n, 1), mode)
    assert m.exec_kind == "dia" and m.R == N
    return m


def flip_rows(m, r1, r2, bit=5):
    """Flip the same value_lo bit in the diagonal elements of two rows."""
    from abft_sparse_cg.ecc import ECC_COL_MASK

    rp = np.asarray(m.row_ptr)
    cols = np.asarray(m.planes["col"]) & np.uint32(ECC_COL_MASK)
    planes = {k: v.copy() for k, v in m.planes.items()}
    for r in (r1, r2):
        lo, hi = rp[r], rp[r + 1]
        idx = lo + int(np.nonzero(cols[lo:hi] == r)[0][0])
        planes["value_lo"][idx] ^= np.uint32(1 << bit)
    return m.with_planes(planes)


def fast_trigger(impl, m2, dtype):
    md = make_matrix_device(m2, dtype)
    x = jnp.zeros(m2.R, dtype)
    _, trig = impl.fast(md, x)
    return bool(trig)


# (row delta, jnp detects, kernel detects)
SCOPE = [
    (2, False, False),       # same 8-row block: all blind (doc'd)
    (8, True, True),         # adjacent blocks: all detect
    (1024, True, True),      # one kernel row block apart
    (8192, True, True),      # eight kernel row blocks apart
]


@pytest.mark.parametrize("delta,jnp_det,kern_det", SCOPE)
def test_sec7_multi_element_scope(delta, jnp_det, kern_det):
    """sec7 has no parity bit — the checksum blocks ARE the scope."""
    m = dia_mat("sec7")
    m2 = flip_rows(m, 4000, 4000 + delta)
    assert fast_trigger(make_spmv(m, jnp.float64, "sec7"), m2,
                        jnp.float64) == jnp_det
    assert fast_trigger(
        make_pallas_spmv(m, jnp.float32, "sec7", interpret=True), m2,
        jnp.float32) == kern_det


@pytest.mark.parametrize("block_rows", [1024, 16384],
                         ids=["multi-block", "one-block"])
@pytest.mark.parametrize("delta,jnp_det,kern_det", SCOPE)
def test_sec7_solve_scope(delta, jnp_det, kern_det, block_rows):
    """The whole pallas-target solve: a detected pair is classified and
    both single-bit elements corrected; a blind pair is not — and the
    boundary does not move with the kernel's row-block size."""
    from abft_sparse_cg.solver.cg import make_cg_solver

    m = dia_mat("sec7")
    m2 = flip_rows(m, 4000, 4000 + delta)
    md = make_matrix_device(m2, jnp.float32)
    b = np.zeros(m.R)
    b[: m.N] = np.random.default_rng(1).random(m.N)
    fus = jax.jit(make_cg_solver(
        make_pallas_spmv(m, jnp.float32, "sec7", interpret=True,
                         block_rows=block_rows), 50, 1e-6))
    r = fus(md, jnp.asarray(b, jnp.float32))
    assert int(r.stats.corrected_count) == (2 if kern_det else 0)
    assert int(r.stats.errcode) == 0


@pytest.mark.parametrize("delta,kern_det", [(2, False), (8, True),
                                            (1024, True)])
def test_sec7_wideband_solve_scope(delta, kern_det):
    """A wide-band ELL matrix through the ELL kernel's solve: the same
    8-row-block boundary as the banded case."""
    from abft_sparse_cg.solver.cg import make_cg_solver
    from tests.test_fused import wideband_matrix

    m = wideband_matrix("sec7")
    m2 = flip_rows(m, 1000, 1000 + delta)
    md = make_matrix_device(m2, jnp.float32)
    b = np.zeros(m.R)
    b[: m.N] = np.random.default_rng(1).random(m.N)
    fus = jax.jit(make_cg_solver(
        make_pallas_spmv(m, jnp.float32, "sec7", interpret=True), 50, 1e-6))
    r = fus(md, jnp.asarray(b, jnp.float32))
    assert int(r.stats.corrected_count) == (2 if kern_det else 0)
    assert int(r.stats.errcode) == 0


@pytest.mark.parametrize("delta,kern_det", [(2, False), (8, True),
                                            (4096, True)])
def test_sec7_periter_wideband_scope(delta, kern_det):
    """The ELL kernel on a wide band folds the same 8-row blocks as the
    banded kernel — the detect/miss boundary must not drift."""
    from tests.test_fused import wideband_matrix

    m = wideband_matrix("sec7", n=16384)
    assert m.band > 1920
    m2 = flip_rows(m, 1000, 1000 + delta)
    assert fast_trigger(
        make_pallas_spmv(m, jnp.float32, "sec7", interpret=True), m2,
        jnp.float32) == kern_det


@pytest.mark.parametrize("delta", [d for d, *_ in SCOPE])
def test_secded_parity_covers_multi_element(delta):
    """The per-element parity mask detects two odd-weight elements at
    full granularity in EVERY tier — no class cancellation."""
    m = dia_mat("secded")
    m2 = flip_rows(m, 4000, 4000 + delta)
    assert fast_trigger(make_spmv(m, jnp.float64, "secded"), m2,
                        jnp.float64)
    assert fast_trigger(
        make_pallas_spmv(m, jnp.float32, "secded", interpret=True), m2,
        jnp.float32)
