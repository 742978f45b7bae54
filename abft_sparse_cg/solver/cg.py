"""The CG iteration as one jitted program — detect fast, repair rarely.

The reference's loop (reference cg.cpp:93-118) round-trips four scalars
through the host every iteration and runs the full per-element ECC check
inside every SpMV; here the whole solve is a single device program with a
two-level structure for the ECC modes:

  outer while (not done):
    inner while (itr < max && rr > conv && no trigger):
        w, trigger = fast_spmv(md, p)       # raw values + cheap signals
        ... CG update (gated on !trigger) ...
    if trigger:   # rare: a fault was detected somewhere in the matrix
        classify(md) -> stats (+ fail-stop code), scrubbed planes
        resume the fast loop on the scrubbed matrix (the reference's
        write-back semantics, done functionally, once per fault)

The iteration that saw the trigger is *re-executed* after the repair, so
the iterates never consume corrupted values — the exact behaviour of the
reference, which corrects mid-SpMV before using the element.  Fail-stop
conditions (sed detection, secded double-bit) become a nonzero error code
that ends the outer loop; the caller maps it to the reference's stdout
strings and exit(1).

Modes without a lazy schedule (none, constraints) use a single plain
loop around the full-check SpMV.

Per-iteration residual printing (reference cg.cpp:117) is reproduced by
carrying an rr trace and printing post-hoc — one host callback per
iteration would stall the device loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.blas1 import calc_p, calc_xr, dot
from ..ops.spmv import ERR_BREAKDOWN, ERR_PHANTOM, SpmvImpl, SpmvStats

__all__ = ["CGResult", "CGState", "make_cg_solver", "make_cg_continue",
           "make_lazy_ci_solver", "init_state", "trace_length"]

_MAX_TRACE = 100_000


def trace_length(max_itrs: int, trace_rr: bool = True) -> int:
    """Length of the rr trace carried in CGState for a run bound."""
    return min(max_itrs, _MAX_TRACE) if trace_rr else 1


class CGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray   # completed iterations
    rr: jnp.ndarray           # final squared residual norm
    stats: SpmvStats          # accumulated ABFT stats (first events kept)
    rr_trace: jnp.ndarray     # (max_itrs,) rr after each iteration (nan-padded)
    md: object = None         # final MatrixDevice — scrubbed planes if the
    #                           lazy loop repaired a fault (the functional
    #                           analogue of the reference's in-place
    #                           write-back, CSR/CPUContext.cpp:275-277)


class CGState(NamedTuple):
    """Resumable solver state — everything a checkpoint must capture
    (the snapshot SURVEY §5 describes: (x, r, p, rr, itr) + ABFT stats
    and the residual trace)."""

    itr: jnp.ndarray
    x: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    rr: jnp.ndarray      # r . r           (convergence test, rr trace)
    rz: jnp.ndarray      # r . M^-1 r      (== rr when unpreconditioned)
    stats: SpmvStats
    trace: jnp.ndarray


def _iterate(x, r, p, rr, rz, w, minv, pw=None):
    """One (P)CG update.  ``minv`` is the Jacobi M^-1 diagonal or None;
    with None this is bit-for-bit the reference's iteration
    (cg.cpp:93-118).  ``pw``: the dot(p, w) reduction when the SpMV
    already fused it (SpmvImpl.fast_pw), else computed here.

    Also returns ``bad``: CG breakdown — p.A.p not positive (matrix not
    SPD) or a non-finite residual.  The reference divides by pw unguarded
    (cg.cpp:102) and silently rides the NaN to a fake "convergence"; here
    the caller turns ``bad`` into ERR_BREAKDOWN and fail-stops.
    """
    if pw is None:
        pw = dot(p, w)
    alpha = rz / pw
    x1, r1, rr1 = calc_xr(x, r, p, w, alpha)
    if minv is None:
        rz1 = rr1
        p1 = calc_p(p, r1, rr1 / rz)
    else:
        z = minv * r1
        rz1 = dot(r1, z)
        p1 = calc_p(p, z, rz1 / rz)
    bad = (pw <= 0) | ~jnp.isfinite(rr1)
    return x1, r1, p1, rr1, rz1, bad


def init_state(b, max_itrs: int, trace_rr: bool = True,
               minv=None) -> CGState:
    """Fresh solver state for right-hand side ``b`` (x0 = 0, r = b;
    p = M^-1 r, which is r itself unpreconditioned; reference
    cg.cpp:85-88)."""
    trace_len = trace_length(max_itrs, trace_rr)
    rr = dot(b, b)
    if minv is None:
        p0, rz = b, rr
    else:
        p0 = minv * b
        rz = dot(b, p0)
    return CGState(
        itr=jnp.int32(0),
        x=jnp.zeros_like(b),
        r=b,
        p=p0,
        rr=rr,
        rz=rz,
        stats=SpmvStats.clean(),
        trace=jnp.full((trace_len,), jnp.nan, b.dtype),
    )


def make_cg_continue(impl: SpmvImpl, conv_threshold: float,
                     trace_rr: bool = True):
    """Build ``continue_(md, state, upto) -> (CGState, MatrixDevice)``.

    Advances the solve until ``itr == upto`` (a runtime scalar — one
    compilation serves every segment length), convergence, or a
    fail-stop.  This is the checkpointable core: callers snapshot the
    returned ``CGState`` between segments and resume by calling again
    **with the returned MatrixDevice** — after a repair it holds the
    scrubbed planes, so a persistent fault classifies exactly once per
    solve, not once per segment.
    """
    if impl.classify is None:
        return _make_simple_continue(impl, conv_threshold, trace_rr)
    return _make_lazy_continue(impl, conv_threshold, trace_rr)


def make_cg_solver(impl: SpmvImpl, max_itrs: int, conv_threshold: float,
                   trace_rr: bool = True):
    """Build ``solve(md, b, minv=None) -> CGResult`` around a SpmvImpl.

    ``minv``: optional Jacobi preconditioner diagonal (M^-1), an (R,)
    device vector — a capability beyond the reference.
    """
    cont = make_cg_continue(impl, conv_threshold, trace_rr)

    def solve(md, b, minv=None):
        s, md_out = cont(md, init_state(b, max_itrs, trace_rr, minv),
                         jnp.int32(max_itrs), minv)
        return CGResult(x=s.x, iterations=s.itr, rr=s.rr, stats=s.stats,
                        rr_trace=s.trace, md=md_out)

    return solve


def _make_simple_continue(impl, conv_threshold, trace_rr):
    spmv_full = impl.full

    def continue_(md, state: CGState, upto, minv=None):
        conv = jnp.asarray(conv_threshold, state.rr.dtype)

        def cond(s):
            return (s.itr < upto) & (s.rr > conv) & (s.stats.errcode == 0)

        def body(s):
            if impl.fast_pw is not None:  # mode none: no checks to run
                w, _, pw = impl.fast_pw(md, s.p)
                st1 = SpmvStats.clean()
            else:
                w, st1 = spmv_full(md, s.p)
                pw = None
            st = s.stats.merge_first(st1)
            ok = st1.errcode == 0
            x1, r1, p1, rr1, rz1, bad = _iterate(s.x, s.r, s.p, s.rr, s.rz,
                                                 w, minv, pw)
            bad = bad & ok  # SpMV fail-stop takes precedence
            st = st.merge_first(SpmvStats.clean()._replace(
                errcode=jnp.where(bad, jnp.int32(ERR_BREAKDOWN),
                                  jnp.int32(0))))
            ok = ok & ~bad
            # On fail-stop the reference dies mid-SpMV; discard the update.
            x = jnp.where(ok, x1, s.x)
            r = jnp.where(ok, r1, s.r)
            p = jnp.where(ok, p1, s.p)
            rr = jnp.where(ok, rr1, s.rr)
            rz = jnp.where(ok, rz1, s.rz)
            trace = s.trace
            if trace_rr:
                trace = trace.at[s.itr].set(jnp.where(ok, rr, trace[s.itr]))
            itr = jnp.where(ok, s.itr + 1, s.itr)
            return CGState(itr, x, r, p, rr, rz, st, trace)

        return jax.lax.while_loop(cond, body, state), md

    return continue_


def _fast_pw_of(im: SpmvImpl):
    if im.fast_pw is not None:
        return im.fast_pw

    def f(md, p):
        w, trig = im.fast(md, p)
        return w, trig, dot(p, w)

    return f


def _cksum_leaves(md):
    """Stored-checksum baselines of a device matrix (split composites
    recurse over their (main, tail) parts); [] when the pytree carries
    none — the guard then treats every repair as unconsumed."""
    if hasattr(md, "cksum"):
        return [] if md.cksum is None else [md.cksum]
    if isinstance(md, tuple):
        out = []
        for part in md:
            out.extend(_cksum_leaves(part))
        return out
    return []


def _baseline_changed(md_before, md_after):
    la, lb = _cksum_leaves(md_before), _cksum_leaves(md_after)
    # Both come from the same pytree shape through lax.cond; a length
    # mismatch would mean a classify variant added/removed a
    # cksum-bearing part and zip() would silently drop leaves,
    # weakening the phantom guard — fail loudly instead.
    assert len(la) == len(lb), (len(la), len(lb))
    changed = jnp.bool_(False)
    for a, b in zip(la, lb):
        changed = changed | jnp.any(a != b)
    return changed


def _phantom_guard(trigged, st1, consumed, stuck):
    """Livelock guard shared by the lazy exit resolve and the live
    schedule's outer loop: a trigger classify cannot attribute — no correction, no
    errcode, AND the checksum-baseline refresh changed nothing
    (``consumed``) — gets ONE retry for the transient-signal case; a
    second consecutive unattributable trigger means the detection
    signal itself is wrong, so fail-stop with ERR_PHANTOM instead of
    rolling back forever.  ``consumed`` matters for constraints mode:
    a benign index change is ADOPTED by refreshing the baseline
    (errcode 0, corrected 0 — the reference consumes it silently), so
    two distinct benign events in consecutive rounds must not read as
    a phantom; only a trigger that leaves the baseline bit-identical
    is unattributable."""
    unprod = (trigged & (st1.errcode == 0)
              & (st1.corrected_count == 0) & ~consumed)
    stuck = jnp.where(unprod, stuck + 1, jnp.int32(0))
    st1 = st1._replace(errcode=jnp.where(
        (stuck >= 2) & (st1.errcode == 0),
        jnp.int32(ERR_PHANTOM), st1.errcode))
    return st1, stuck


def _lazy_exit_resolve(md, s1, snap, trig, err, verify, classify,
                       stuck=None):
    """Trigger/rollback resolution for the lazy ``--check-interval``
    schedule (keep the predicate in ONE place; it decides
    delivered-solution guarantees).

    Exit-time verification: on a clean exit, up to CI-1 tail iterations
    are unverified — one detection pass (``verify(md, p) -> bool``,
    skipped when the window already triggered) closes the window.
    Faults are persistent plane corruptions, so clean-now covers every
    unchecked iteration since the last check (PARITY.md).

    Retry-from-snapshot predicate: classify handled the anomaly — a
    correction, a benign constraints adoption (the refreshed checksum
    baseline cannot re-trigger on the same event), or a breakdown
    traced to a corrected fault.  An uncorrectable detection rolls back
    too (the tail iterations ran on corrupt planes) and fail-stops; a
    fault-free breakdown stands.
    """
    ttrig = jax.lax.cond(trig, lambda md, p: jnp.bool_(True), verify,
                         md, s1.p)
    trigged = trig | ttrig
    anomaly = trigged | (err != 0)

    def repair(md):
        st1, md2 = classify(md)
        return md2, st1

    def keep(md):
        return md, SpmvStats.clean()

    md_in = md
    md, st1 = jax.lax.cond(anomaly, repair, keep, md)
    if stuck is not None:
        st1, stuck = _phantom_guard(
            trigged, st1, _baseline_changed(md_in, md), stuck)
    fixed = ((trigged | (st1.corrected_count > 0))
             & (st1.errcode == 0))
    roll = fixed | (st1.errcode != 0)
    brk = jnp.where(fixed, jnp.int32(0), err)
    st = s1.stats.merge_first(st1._replace(
        errcode=jnp.where(st1.errcode != 0, st1.errcode, brk)))
    s2 = CGState(
        itr=jnp.where(roll, snap.itr, s1.itr),
        x=jnp.where(roll, snap.x, s1.x),
        r=jnp.where(roll, snap.r, s1.r),
        p=jnp.where(roll, snap.p, s1.p),
        rr=jnp.where(roll, snap.rr, s1.rr),
        rz=jnp.where(roll, snap.rz, s1.rz),
        stats=st, trace=s1.trace)
    done = (~fixed) | (st.errcode != 0)
    if stuck is not None:
        return done, md, s2, stuck
    return done, md, s2


def make_lazy_ci_continue(impl: SpmvImpl, product: SpmvImpl,
                          check_interval: int, conv_threshold: float,
                          trace_rr: bool = True):
    """Lazy ``--check-interval`` schedule of the pallas target:
    unchecked iterations run ``product`` — the detection-free SpMV
    (ops.spmv_pallas.make_pallas_product), same arithmetic, no
    detection stream — and every CI-th iteration runs the checked
    ``impl``.  A 3-vector verified-state
    snapshot rides the loop carry; any anomaly (a check trigger, a
    breakdown, or the one checked pass that closes the tail on every
    exit) classifies/scrubs and rolls back to the snapshot, re-executing
    the window (PARITY.md "Lazy detection schedule"): no result ever
    derives from unverified reads, detection latency <= CI iterations +
    rollback re-execution."""
    CI = int(check_interval)
    assert CI > 1 and impl.classify is not None
    checked = _fast_pw_of(impl)
    prod = _fast_pw_of(product)

    def continue_(md, state: CGState, upto, minv=None):
        conv = jnp.asarray(conv_threshold, state.rr.dtype)

        def inner(md, s: CGState, snap):
            c0 = (s, snap, jnp.bool_(False), jnp.int32(0))

            def cond(c):
                s, _, trig, err = c
                return ((s.itr < upto) & (s.rr > conv) & (~trig)
                        & (err == 0) & (s.stats.errcode == 0))

            def body(c):
                s, snap, _, _ = c
                chk = (s.itr % CI) == (CI - 1)
                # Any returned trigger is genuine: the product impl's
                # kernels emit a constant False, and a split tail's
                # live (jnp) signals just mean earlier detection.
                w, trig, pw = jax.lax.cond(chk, checked, prod, md, s.p)
                ok = ~trig
                x1, r1, p1, rr1, rz1, bad = _iterate(
                    s.x, s.r, s.p, s.rr, s.rz, w, minv, pw)
                # Breakdown is only meaningful when no fault fired; the
                # outer pass decides whether a fault explains it.
                bad = bad & ok
                err = jnp.where(bad, jnp.int32(ERR_BREAKDOWN),
                                jnp.int32(0))
                ok = ok & ~bad
                x = jnp.where(ok, x1, s.x)
                r = jnp.where(ok, r1, s.r)
                p = jnp.where(ok, p1, s.p)
                rr = jnp.where(ok, rr1, s.rr)
                rz = jnp.where(ok, rz1, s.rz)
                trace = s.trace
                if trace_rr:
                    trace = trace.at[s.itr].set(
                        jnp.where(ok, rr, trace[s.itr]))
                itr = jnp.where(ok, s.itr + 1, s.itr)
                s1 = CGState(itr, x, r, p, rr, rz, s.stats, trace)
                # A checked iteration that stood is verified state.
                snapped = ok & chk
                snap1 = CGState(
                    itr=jnp.where(snapped, itr, snap.itr),
                    x=jnp.where(snapped, x, snap.x),
                    r=jnp.where(snapped, r, snap.r),
                    p=jnp.where(snapped, p, snap.p),
                    rr=jnp.where(snapped, rr, snap.rr),
                    rz=jnp.where(snapped, rz, snap.rz),
                    stats=snap.stats, trace=snap.trace)
                return (s1, snap1, trig, err)

            return jax.lax.while_loop(cond, body, c0)

        def outer_cond(c):
            done, *_ = c
            return ~done

        def outer_body(c):
            _, md, s, snap, stuck = c
            s1, snap1, trig, err = inner(md, s, snap)
            done, md, s2, stuck = _lazy_exit_resolve(
                md, s1, snap1, trig, err,
                lambda md, p: checked(md, p)[1], impl.classify, stuck)
            return (done, md, s2, snap1, stuck)

        # The entry state is verified — it seeds the snapshot.
        _, md_out, s, _, _ = jax.lax.while_loop(
            outer_cond, outer_body,
            (jnp.bool_(False), md, state, state, jnp.int32(0)))
        return s, md_out

    return continue_


def make_lazy_ci_solver(impl: SpmvImpl, product: SpmvImpl,
                        check_interval: int, max_itrs: int,
                        conv_threshold: float, trace_rr: bool = True):
    """``solve(md, b, minv=None) -> CGResult`` on the solver-level lazy
    check-interval schedule (see make_lazy_ci_continue)."""
    cont = make_lazy_ci_continue(impl, product, check_interval,
                                 conv_threshold, trace_rr)

    def solve(md, b, minv=None):
        s, md_out = cont(md, init_state(b, max_itrs, trace_rr, minv),
                         jnp.int32(max_itrs), minv)
        return CGResult(x=s.x, iterations=s.itr, rr=s.rr, stats=s.stats,
                        rr_trace=s.trace, md=md_out)

    return solve


def _make_lazy_continue(impl, conv_threshold, trace_rr):
    def continue_(md, state: CGState, upto, minv=None):
        conv = jnp.asarray(conv_threshold, state.rr.dtype)

        def inner(md, s: CGState):
            s0 = (s, jnp.bool_(False))

            def cond(c):
                s, trig = c
                return ((s.itr < upto) & (s.rr > conv) & (~trig)
                        & (s.stats.errcode == 0))

            def body(c):
                s, _ = c
                if impl.fast_pw is not None:
                    w, trig, pw = impl.fast_pw(md, s.p)
                else:
                    w, trig = impl.fast(md, s.p)
                    pw = None
                ok = ~trig
                x1, r1, p1, rr1, rz1, bad = _iterate(s.x, s.r, s.p, s.rr,
                                                     s.rz, w, minv, pw)
                # A triggered iteration's w may be corrupt — breakdown is
                # only meaningful when no fault fired (the iteration is
                # re-executed on the scrubbed matrix otherwise).
                bad = bad & ok
                st = s.stats.merge_first(SpmvStats.clean()._replace(
                    errcode=jnp.where(bad, jnp.int32(ERR_BREAKDOWN),
                                      jnp.int32(0))))
                ok = ok & ~bad
                # A triggered iteration is re-executed after the repair,
                # so its (corrupt-value) update is discarded.
                x = jnp.where(ok, x1, s.x)
                r = jnp.where(ok, r1, s.r)
                p = jnp.where(ok, p1, s.p)
                rr = jnp.where(ok, rr1, s.rr)
                rz = jnp.where(ok, rz1, s.rz)
                trace = s.trace
                if trace_rr:
                    trace = trace.at[s.itr].set(
                        jnp.where(ok, rr, trace[s.itr])
                    )
                itr = jnp.where(ok, s.itr + 1, s.itr)
                return (CGState(itr, x, r, p, rr, rz, st, trace), trig)

            return jax.lax.while_loop(cond, body, s0)

        def outer_cond(c):
            done, *_ = c
            return ~done

        def outer_body(c):
            _, md, s, stuck = c
            s, trig = inner(md, s)

            def repair(md):
                st1, md2 = impl.classify(md)
                return md2, st1

            def keep(md):
                return md, SpmvStats.clean()

            md_in = md
            md, st1 = jax.lax.cond(trig, repair, keep, md)
            st1, stuck = _phantom_guard(
                trig, st1, _baseline_changed(md_in, md), stuck)
            st = s.stats.merge_first(st1)
            s = s._replace(stats=st)
            done = (~trig) | (st.errcode != 0)
            return (done, md, s, stuck)

        _, md_out, s, _ = jax.lax.while_loop(
            outer_cond, outer_body,
            (jnp.bool_(False), md, state, jnp.int32(0)))
        return s, md_out

    return continue_
