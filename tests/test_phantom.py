"""ERR_PHANTOM livelock guard: a detection trigger that classify cannot
attribute (no correction, no fail-stop code, and the scrub's checksum
refresh does not clear it) must fail-stop after one retry instead of
re-entering the kernel forever.

The realistic route to this state is a kernel or hardware miscompute of
the detection signal itself.  Faults in the *stored* checksum plane are NOT phantoms:
classify refreshes checksums from the (corrected) word planes, so the
retry runs clean (pinned by test_cksum_corruption_heals below).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.ops.spmv import ERR_PHANTOM, SpmvStats, make_matrix_device
from abft_sparse_cg.ops.spmv_pallas import make_pallas_spmv
from abft_sparse_cg.solver.cg import (CGState, _lazy_exit_resolve,
                                      make_cg_solver)
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(7)


def _corrupt_baseline(md):
    """Flip one bit of the stored detection baseline the FAST kernel
    actually compares: fold_ck under the round-4 fold-plane live
    detection (with cksum flipped too, so the classify/oracle view
    stays consistent with the scenario), else cksum alone."""
    ck = np.asarray(md.cksum).copy()
    ck[0, 0] ^= np.uint32(1 << 5)
    md = md._replace(cksum=jnp.asarray(ck))
    if md.fold_ck is not None:
        fck = np.asarray(md.fold_ck).copy()
        fck[0, 0] ^= np.uint32(1 << 5)
        md = md._replace(fold_ck=jnp.asarray(fck))
    return md


def _mat(mode, n=1024):
    rows, cols, vals, n = spd_tridiagonal(n)
    return build_protected("csr", assemble(cols, rows, vals, n, 1), mode)


def _state(n):
    v = jnp.asarray(RNG.random(n), jnp.float32)
    rr = jnp.float32(float((np.asarray(v) ** 2).sum()))
    return CGState(itr=jnp.int32(3), x=v, r=v, p=v, rr=rr, rz=rr,
                   stats=SpmvStats.clean(), trace=jnp.zeros((4,)))


def test_lazy_exit_resolve_phantom():
    """Two consecutive unattributable triggers -> ERR_PHANTOM, done."""
    s1 = _state(256)
    snap = s1._replace(itr=jnp.int32(1))
    md = {"planes": jnp.zeros((4,))}  # any pytree — classify is a no-op

    def classify(md):
        return SpmvStats.clean(), md

    def verify(md, p):
        return jnp.bool_(False)

    trig, err = jnp.bool_(True), jnp.int32(0)
    done, md, s2, stuck = _lazy_exit_resolve(
        md, s1, snap, trig, err, verify, classify, jnp.int32(0))
    # First unproductive trigger: retry from the snapshot.
    assert not bool(done) and int(stuck) == 1
    assert int(s2.itr) == 1  # rolled back
    done, md, s3, stuck = _lazy_exit_resolve(
        md, s1, snap, trig, err, verify, classify, stuck)
    assert bool(done) and int(stuck) == 2
    assert int(s3.stats.errcode) == ERR_PHANTOM


def test_lazy_exit_resolve_productive_resets():
    """A repair that corrects something resets the stuck counter."""
    s1 = _state(256)
    snap = s1._replace(itr=jnp.int32(1))
    md = {"planes": jnp.zeros((4,))}

    def classify(md):
        return SpmvStats.clean()._replace(
            corrected_count=jnp.int32(1)), md

    done, md, s2, stuck = _lazy_exit_resolve(
        md, s1, snap, jnp.bool_(True), jnp.int32(0),
        lambda md, p: jnp.bool_(False), classify, jnp.int32(1))
    assert not bool(done) and int(stuck) == 0
    assert int(s2.stats.errcode) == 0


def test_lazy_exit_resolve_benign_adoption_not_phantom():
    """Consecutive benign constraints adoptions are CONSUMED events,
    not phantoms: classify refreshes the checksum baseline (errcode 0,
    corrected 0 — the reference consumes index changes silently,
    CSR/CPUContext.cpp:162-207), so two distinct benign index changes
    arriving in back-to-back rounds must keep solving.  Only a trigger
    that leaves the baseline bit-identical is unattributable."""
    m = _mat("constraints", 256)
    md = make_matrix_device(m, jnp.float32)
    s1 = _state(m.R)
    snap = s1._replace(itr=jnp.int32(1))

    def adopt(md):
        # benign adoption: the refreshed baseline differs from stored
        return SpmvStats.clean(), md._replace(
            cksum=md.cksum ^ jnp.uint32(1))

    def verify(md, p):
        return jnp.bool_(False)

    trig, err = jnp.bool_(True), jnp.int32(0)
    stuck = jnp.int32(0)
    for _round in range(3):
        done, md, s2, stuck = _lazy_exit_resolve(
            md, s1, snap, trig, err, verify, adopt, stuck)
        assert not bool(done) and int(stuck) == 0
        assert int(s2.stats.errcode) == 0
        assert int(s2.itr) == 1  # rolled back for the retry

    # ... while an adoption that changes NOTHING stays a phantom.
    def noop(md):
        return SpmvStats.clean(), md

    for want_stuck, want_done in ((1, False), (2, True)):
        done, md, s2, stuck = _lazy_exit_resolve(
            md, s1, snap, trig, err, verify, noop, stuck)
        assert int(stuck) == want_stuck and bool(done) == want_done
    assert int(s2.stats.errcode) == ERR_PHANTOM


@pytest.mark.parametrize("mode", ["sec7", "secded"])
def test_fused_phantom_failstop(mode):
    """The live schedule's outer loop over the kernel: persistent
    trigger + no-op classify -> ERR_PHANTOM fail-stop (without the guard
    this livelocks).  The trigger is forced by corrupting the stored
    cksum baseline while classify is replaced by one that does NOT
    refresh it."""
    m = _mat(mode)
    impl = make_pallas_spmv(m, jnp.float32, mode, interpret=True)
    impl = impl._replace(classify=lambda md: (SpmvStats.clean(), md))
    fus = jax.jit(make_cg_solver(impl, 50, 1e-8))
    md = make_matrix_device(m, jnp.float32)
    md = _corrupt_baseline(md)
    b = jnp.asarray(RNG.random(m.R), jnp.float32)
    res = fus(md, b)
    assert int(res.stats.errcode) == ERR_PHANTOM
    assert int(res.iterations) == 0  # no update ever stood


@pytest.mark.parametrize("mode", ["sec7", "secded"])
def test_cksum_corruption_heals(mode):
    """WITHOUT the classify patch, a corrupted stored-cksum plane is a
    productive repair: the scrub refreshes checksums and the retried
    solve converges clean (no phantom, no corrections)."""
    m = _mat(mode)
    fus = jax.jit(make_cg_solver(
        make_pallas_spmv(m, jnp.float32, mode, interpret=True), 50, 1e-8))
    md = make_matrix_device(m, jnp.float32)
    md = _corrupt_baseline(md)
    b = jnp.asarray(RNG.random(m.R), jnp.float32)
    res = fus(md, b)
    assert int(res.stats.errcode) == 0
    assert float(res.rr) <= 1e-8
