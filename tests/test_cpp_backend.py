"""Native C++ backend ("cpu" target) vs the jnp oracle."""

import numpy as np
import pytest

pytest.importorskip("abft_sparse_cg.backends.cpp_backend")

from abft_sparse_cg.backends import available, create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(31)


def protected(fmt, mode, n=96, blocks=3):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    return build_protected(fmt, a, mode)


def test_cpu_target_registered():
    assert ("cpu", "secded") in available()


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "constraints", "sed", "sec7", "sec8", "secded"])
def test_solve_matches_jnp(fmt, mode):
    m = protected(fmt, mode)
    b = RNG.random(m.N)
    rc = create("cpu", mode).solve(m, b, 500, 1e-10, verbose=False)
    rj = create("jnp", mode).solve(m, b, 500, 1e-10, verbose=False, dtype="f64")
    assert rc.errcode == rj.errcode == 0
    assert rc.iterations == rj.iterations
    np.testing.assert_allclose(rc.x, rj.x, rtol=1e-12)
    np.testing.assert_allclose(
        rc.rr_trace[: rc.iterations], rj.rr_trace[: rj.iterations], rtol=1e-10
    )


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_abft_events_match_jnp(fmt):
    b = None
    for mode in ("sed", "sec7", "sec8", "secded"):
        for seed in range(3):
            m = protected(fmt, mode)
            if b is None:
                b = RNG.random(m.N)
            m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                                 echo=lambda s: None)
            rc = create("cpu", mode).solve(m2, b, 500, 1e-10, verbose=False)
            rj = create("jnp", mode).solve(m2, b, 500, 1e-10, verbose=False,
                                           dtype="f64")
            assert rc.errcode == rj.errcode, (mode, seed)
            assert rc.messages == rj.messages, (mode, seed)
            if rc.errcode == 0:
                np.testing.assert_allclose(rc.x, rj.x, rtol=1e-12)


def test_writeback_scrubs_planes():
    """The native backend repairs the planes in place (reference
    write-back semantics) — a second solve sees a clean matrix."""
    m = protected("csr", "sec8")
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(2), echo=lambda s: None)
    backend = create("cpu", "sec8")
    r1 = backend.solve(m2, b, 500, 1e-10, verbose=False)
    assert r1.corrected_count > 0
    # _plane_args copies planes, so m2 itself stays corrupted; but within
    # one solve the scrub means each element is corrected at most once.
    assert r1.corrected_count == 1


def test_native_breakdown_guard():
    """Indefinite matrix -> ERR_BREAKDOWN from the native loop too."""
    from abft_sparse_cg.ops.spmv import ERR_BREAKDOWN

    n = 32
    idx = np.arange(n)
    a = assemble(idx, idx, -np.ones(n), n, 1)  # A = -I
    m = build_protected("csr", a, "none")
    b = RNG.random(n)
    res = create("cpu", "none").solve(m, b, 100, 1e-10, verbose=False)
    assert res.failed and res.errcode == ERR_BREAKDOWN
    assert any("breakdown" in s for s in res.messages)


def test_live_streaming_skips_duplicate_messages():
    """verbose=True: the native loop streams rr + correction lines
    itself; the HostResult then carries no duplicate correction message
    and no trace to replay."""
    m = protected("csr", "sec8")
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(2),
                         echo=lambda s: None)
    res = create("cpu", "sec8").solve(m2, b, 500, 1e-10, verbose=True)
    assert res.corrected_count == 1
    assert not any(s.startswith("[ECC] corrected") for s in res.messages)
    assert res.rr_trace is None
