"""RCM exec-space reordering: band recovery, solve parity, fault parity.

The reorder layer (formats/reorder.py) stands in for the reference's
general-case gather kernel (CSR/CPUContext.cpp:115-133):
a matrix that is banded up to a symmetric permutation gets its band back
at build time, unlocking the stencil/window fast paths.  Everything
reference-visible (canonical indices, ECC events, injection banners,
solutions) must be unchanged by the permutation.
"""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.formats.reorder import (
    _rcm_numpy,
    bandwidth,
    inverse_permutation,
    rcm_permutation,
)
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import spmv_dense_oracle
from abft_sparse_cg.utils.matgen import (
    shuffle_labels,
    spd_laplacian_2d,
    spd_tridiagonal,
)

RNG = np.random.default_rng(31337)


def shuffled_tri(n=64, blocks=2, seed=5):
    tri = shuffle_labels(*spd_tridiagonal(n), seed=seed)
    return assemble(tri[1], tri[0], tri[2], tri[3], blocks)


def shuffled_lap(side=10, blocks=2, seed=7):
    lap = shuffle_labels(*spd_laplacian_2d(side), seed=seed)
    return assemble(lap[1], lap[0], lap[2], lap[3], blocks)


def dense_of(a):
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    return d


def test_rcm_recovers_band():
    a = shuffled_tri()
    nat = bandwidth(a.rows, a.cols)
    perm = rcm_permutation(a.rows, a.cols, a.N)
    pos = inverse_permutation(perm)
    rb = bandwidth(pos[a.rows], pos[a.cols])
    assert rb <= 2  # tridiagonal structure: RCM gets the band back
    assert rb < nat


def test_rcm_numpy_fallback_matches_quality():
    a = shuffled_tri(n=48, blocks=1)
    perm = _rcm_numpy(a.rows, a.cols, a.N)
    assert sorted(perm) == list(range(a.N))
    pos = inverse_permutation(perm)
    assert bandwidth(pos[a.rows], pos[a.cols]) <= 2


def test_auto_reorder_unlocks_dia():
    """A label-shuffled tridiagonal looks unstructured but must come out
    of build_protected as a (permuted) DIA stencil."""
    a = shuffled_tri()
    m = build_protected("csr", a, "secded")
    assert m.exec_kind == "dia"
    assert m.perm is not None
    assert m.band <= 2
    # reorder opt-out keeps the natural (ELL) layout.
    m2 = build_protected("csr", a, "secded", reorder="none")
    assert m2.perm is None and m2.exec_kind == "ell"


def test_constraints_mode_never_reorders():
    a = shuffled_tri()
    m = build_protected("csr", a, "constraints")
    assert m.perm is None


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "secded"])
def test_permuted_solve_matches_unpermuted(fmt, mode):
    """Same solution, same residual trajectory (CG is invariant under
    symmetric permutation), with the solve running on the permuted band."""
    a = shuffled_lap()
    mp = build_protected(fmt, a, mode)
    mn = build_protected(fmt, a, mode, reorder="none")
    assert mp.perm is not None and mn.perm is None
    b = RNG.random(a.N)
    backend = create("jnp", mode)
    rp = backend.solve(mp, b, 500, 1e-12, verbose=False, dtype="f64")
    rn = backend.solve(mn, b, 500, 1e-12, verbose=False, dtype="f64")
    assert not rp.failed and not rn.failed
    assert rp.iterations == rn.iterations
    np.testing.assert_allclose(rp.x, rn.x, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        rp.rr_trace[: rp.iterations], rn.rr_trace[: rn.iterations],
        rtol=1e-9)
    np.testing.assert_allclose(dense_of(a) @ rp.x, b, atol=1e-5)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_permuted_spmv_oracle(fmt):
    a = shuffled_lap(seed=3)
    m = build_protected(fmt, a, "sec8")
    assert m.perm is not None
    x = RNG.standard_normal(a.N)
    w, errcode, _ = create("jnp", "sec8").spmv_once(m, x, dtype="f64")
    assert errcode == 0
    np.testing.assert_allclose(w, spmv_dense_oracle(m, x), rtol=1e-12)


@pytest.mark.parametrize("mode", ["sed", "sec7", "sec8", "secded"])
def test_permuted_fault_events_match_canonical(mode):
    """Injected faults report the same canonical indices/events whether
    or not an exec-space permutation is active."""
    a = shuffled_lap(seed=11)
    b = RNG.random(a.N)
    backend = create("jnp", mode)
    for seed in range(4):
        events = {}
        for reorder in ("auto", "none"):
            m = build_protected("csr", a, mode, reorder=reorder)
            m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(seed),
                                 echo=lambda s: None)
            res = backend.solve(m2, b, 300, 1e-8, verbose=False, dtype="f64")
            events[reorder] = (res.errcode, res.err_index, res.messages,
                               res.corrected_count)
        assert events["auto"] == events["none"], f"seed {seed}: {events}"


def test_permuted_scrubbed_matrix_roundtrip():
    """HostResult.scrubbed under an active RCM permutation: the exec
    slot map is permuted, but the recovered canonical planes must equal
    the clean ones exactly."""
    a = shuffled_lap(seed=17)
    m = build_protected("csr", a, "sec8")
    assert m.perm is not None
    b = RNG.random(m.N)
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(6),
                         echo=lambda s: None)
    res = create("jnp", "sec8").solve(m2, b, 300, 1e-10, verbose=False,
                                      dtype="f64")
    assert not res.failed and res.corrected_count == 1
    assert res.scrubbed is not None and res.scrubbed.perm is not None
    for n in m.layout.word_names:
        assert (res.scrubbed.planes[n] == m.planes[n]).all()
    res2 = create("jnp", "sec8").solve(res.scrubbed, b, 300, 1e-10,
                                       verbose=False, dtype="f64")
    assert not res2.failed and res2.corrected_count == 0


def test_permuted_correction_recovers_exact_solution():
    a = shuffled_lap(seed=13)
    m = build_protected("csr", a, "secded")
    assert m.perm is not None
    b = RNG.random(a.N)
    backend = create("jnp", "secded")
    clean = backend.solve(m, b, 500, 1e-10, verbose=False, dtype="f64")
    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(2),
                         echo=lambda s: None)
    res = backend.solve(m2, b, 500, 1e-10, verbose=False, dtype="f64")
    assert not res.failed and res.corrected_count == 1
    np.testing.assert_allclose(res.x, clean.x, rtol=1e-12)


def test_rcm_adoption_bound_matches_split_whole_bound():
    """formats.protected._BAND_KERNEL_MAX (the RCM adoption bound) must
    equal the band split's whole-matrix bound (formats.split
    ._ROLLED_MAX_BAND): otherwise the split would decline a cut in
    favour of a whole-matrix ordering that the build then refuses to
    adopt."""
    from abft_sparse_cg.formats.protected import _BAND_KERNEL_MAX
    from abft_sparse_cg.formats.split import _ROLLED_MAX_BAND

    assert _BAND_KERNEL_MAX == _ROLLED_MAX_BAND
