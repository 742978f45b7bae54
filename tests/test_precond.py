"""Jacobi-preconditioned CG (capability beyond the reference)."""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected

RNG = np.random.default_rng(17)


def illconditioned(n=96, blocks=2):
    """SPD tridiagonal with wildly varying diagonal (Jacobi shines)."""
    scale = 10.0 ** RNG.uniform(-2, 3, n)
    di = np.arange(n)
    oi = np.arange(n - 1)
    rows = np.concatenate([di, oi + 1])
    cols = np.concatenate([di, oi])
    offv = -0.1 * np.sqrt(scale[oi] * scale[oi + 1])
    vals = np.concatenate([4.0 * scale, offv])
    return assemble(cols, rows, vals, n, blocks)


@pytest.mark.parametrize("target", ["jnp", "cpu"])
@pytest.mark.parametrize("mode", ["none", "secded"])
def test_jacobi_converges_faster_and_correctly(target, mode):
    a = illconditioned()
    m = build_protected("csr", a, mode)
    b = RNG.random(m.N)
    backend = create(target, mode)

    plain = backend.solve(m, b, 3000, 1e-12, verbose=False, dtype="f64")
    pcg = backend.solve(m, b, 3000, 1e-12, verbose=False, dtype="f64",
                        precond="jacobi")
    assert not plain.failed and not pcg.failed
    # Same solution (both converged on rr <= 1e-12).
    np.testing.assert_allclose(pcg.x, plain.x, rtol=1e-4, atol=1e-8)
    # Jacobi needs (much) fewer iterations on this conditioning.
    assert pcg.iterations < plain.iterations


def test_jacobi_matches_across_targets():
    a = illconditioned()
    m = build_protected("csr", a, "sec8")
    b = RNG.random(m.N)
    rj = create("jnp", "sec8").solve(m, b, 2000, 1e-12, verbose=False,
                                     dtype="f64", precond="jacobi")
    rc = create("cpu", "sec8").solve(m, b, 2000, 1e-12, verbose=False,
                                     precond="jacobi")
    assert rj.iterations == rc.iterations
    np.testing.assert_allclose(rj.x, rc.x, rtol=1e-12)
    np.testing.assert_allclose(
        rj.rr_trace[: rj.iterations], rc.rr_trace[: rc.iterations], rtol=1e-9)


def test_unknown_precond_rejected():
    a = illconditioned()
    m = build_protected("csr", a, "none")
    with pytest.raises(ValueError, match="preconditioner"):
        create("jnp", "none").solve(m, RNG.random(m.N), 10, 1e-3,
                                    verbose=False, precond="ssor")
