"""The ``pallas`` target's SpMV: live detection fused into the product pass.

The target's contract is LIVE detection — the protected planes are
re-checked on every iteration, not once at solve entry as XLA's
loop-invariant hoisting makes of the jnp target's signals.  Each
iteration reads the rotated-fold plane (ecc.fold — one uint32 plane
that carries the per-element parity and the 8-row-block XOR checksums
of every codeword word) beside the value plane and x.

Routing table (``route_for``; the route taken is reported in the solve
result):

  ==========  ==========================================================
  triton-ell  ELL planes on a GPU: a Pallas kernel through Triton.  One
              program per row block reads each slot's value plane once,
              takes x through an ordinary indexed load
              ``x[col & ECC_COL_MASK]`` (L2 serves the gathers), and in
              the same pass computes the fold plane's parity mask, its
              XOR fold per 8-row block against the stored baseline, and
              the block's ``p.w`` partial.  XLA reduces the per-block
              partials.
  xla-live    everything else (DIA and flat layouts, the CPU,
              mesh-sharded solves): plain XLA
              (ops.spmv.make_spmv(live=True)), the detection stream
              pinned to each iteration by an optimization barrier.  A
              DIA kernel of the same family lost to this route end to
              end on an H100 and was dropped (PERF.md).
  ==========  ==========================================================

Split composites combine their parts' routes.  The rare fault path
(locate via the 7-mask syndrome, correct, classify double-bit, scrub)
is the jnp classify on every route — it runs once per fault.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ecc import ECC_COL_MASK, codec
from .spmv import (MatrixDevice, SpmvImpl, SpmvStats, combine_impls,
                   make_constraints_check, make_product, make_spmv)

__all__ = ["ROUTES", "route_for", "route_name", "device_platform",
           "make_pallas_spmv", "make_pallas_product"]

ROUTES = ("triton-ell", "xla-live")

_BLOCK_ROWS = 1024   # rows per program
_NUM_WARPS = 4


def route_for(mat, platform: str) -> str:
    """The route of one (non-composite) matrix.  ``platform`` "gpu"
    takes the Triton kernel for ELL planes; anything else ("cpu", or
    "gspmd" for a mesh-sharded program) takes the plain live version."""
    if platform == "gpu" and mat.exec_kind == "ell":
        return "triton-ell"
    return "xla-live"


def route_name(mat, platform: str) -> str:
    """Route of a whole matrix (split composites name both parts)."""
    if platform == "gspmd":
        return "xla-live (gspmd)"
    if mat.exec_kind == "split":
        return (f"split({route_for(mat.main, platform)}"
                f"+{route_for(mat.tail, platform)})")
    return route_for(mat, platform)


def device_platform() -> str:
    """The routing platform of the default device ("gpu", "cpu", ...)."""
    return jax.devices()[0].platform


def make_pallas_spmv(mat, dtype=jnp.float32, mode: str = None,
                     interpret: bool = False, platform: str = None,
                     block_rows: int = None):
    """SpmvImpl of the pallas target (same contract as make_spmv).

    ``platform``: route as on this platform (default: the default
    device's).  ``interpret=True`` runs the Triton kernel through the
    Pallas interpreter whatever the platform (tests), so the routes
    are taken as on a GPU.  ``block_rows``: rows per kernel
    program (default _BLOCK_ROWS).
    """
    mode = mat.mode if mode is None else mode
    if platform is None:
        platform = "gpu" if interpret else device_platform()
    if mat.exec_kind == "split":
        return combine_impls(
            make_pallas_spmv(mat.main, dtype, mode, interpret, platform,
                             block_rows),
            make_pallas_spmv(mat.tail, dtype, mode, interpret, platform,
                             block_rows),
            mat.main.exec_size)
    route = route_for(mat, platform)
    if route == "xla-live":
        return make_spmv(mat, dtype, mode, live=True)
    fast_pw = _make_kernel(mat, mode, interpret, True, block_rows)
    return _wrap_mode(mat, dtype, mode, fast_pw)


def make_pallas_product(mat, dtype=jnp.float32, mode: str = None,
                        interpret: bool = False, platform: str = None,
                        block_rows: int = None):
    """Detection-free product for the lazy ``--check-interval``
    schedule's UNCHECKED iterations: the same arithmetic as the checked
    route — including the ECC masking the true ``mode`` implies on the
    gather index — but no detection stream; ``trig`` is constantly
    False.  Split composites keep the tail's checked impl (a live tail
    trigger is just earlier detection)."""
    mode = mat.mode if mode is None else mode
    if platform is None:
        platform = "gpu" if interpret else device_platform()
    if mat.exec_kind == "split":
        return combine_impls(
            make_pallas_product(mat.main, dtype, mode, interpret, platform,
                                block_rows),
            make_pallas_spmv(mat.tail, dtype, mode, interpret, platform,
                             block_rows),
            mat.main.exec_size)
    route = route_for(mat, platform)
    if route == "xla-live":
        return make_product(mat, dtype, mode)
    fast_pw = _make_kernel(mat, mode, interpret, False, block_rows)
    return SpmvImpl(full=None, fast=_drop_pw(fast_pw), fast_pw=fast_pw)


def _drop_pw(fast_pw):
    def fast(md, x):
        w, trig, _ = fast_pw(md, x)
        return w, trig

    return fast


def _wrap_mode(mat, dtype, mode, fast_pw):
    """Assemble the SpmvImpl around a kernel's fast_pw: the jnp oracle
    and classify for the rare paths, a mode-specific full()."""
    fast = _drop_pw(fast_pw)
    if mode == "none":
        def full_none(md, x):
            return fast(md, x)[0], SpmvStats.clean()

        return SpmvImpl(full=full_none, fast_pw=fast_pw)
    jnp_impl = make_spmv(mat, dtype, mode)
    if mode == "constraints":
        # The kernel scans the index-word checksums; the structural
        # checks run once per trigger in the jnp classify, which
        # refreshes the baseline when no constraint is violated.
        check = make_constraints_check(mat)

        def full_cons(md, x):
            return fast(md, x)[0], check(md)

        return SpmvImpl(full=full_cons, fast=fast,
                        classify=jnp_impl.classify, fast_pw=fast_pw)
    return SpmvImpl(full=jnp_impl.full, fast=fast,
                    classify=jnp_impl.classify, fast_pw=fast_pw)


# --------------------------------------------------------------------------
# Triton kernel
# --------------------------------------------------------------------------

def _signals(mat, mode, detect):
    """(use_parity, use_cksum, planes): which detection signals the
    kernel computes and from which planes.  ECC modes read the fold
    plane; constraints scans only its index words' checksums (the
    reference never validates values in that mode); none reads
    nothing."""
    if not detect or mode == "none":
        return False, False, ()
    if mode in codec.ECC_MODES:
        return (mode in ("sed", "sec8", "secded"),
                mode in ("sec7", "secded"), ("fold",))
    names = mat.layout.word_names
    idx = {"col"} | ({"row"} if mat.fmt == "coo" else set())
    return False, True, tuple(i for i, n in enumerate(names) if n in idx)


def _parity(t):
    """Bit parity of each uint32 (1 = odd weight).  Triton lowers no
    population count; three halvings fold the word to 4 bits, and the
    16-bit constant 0x6996 holds the parity of each 4-bit value."""
    t = t ^ (t >> 16)
    t = t ^ (t >> 8)
    t = t ^ (t >> 4)
    return (np.uint32(0x6996) >> (t & np.uint32(0xF))) & np.uint32(1)


def _xor8(t):
    """XOR-reduce the minor axis of a (B, 8) uint32 tile -> (B,).
    Triton has no XOR reduction; three halvings of the minor axis do
    it with split (which it lowers for power-of-two parts)."""
    for _ in range(3):
        a, b = jnp.split(t, 2, axis=1)
        t = a ^ b
    return t.reshape(t.shape[0])


def _make_kernel(mat, mode, interpret, detect, block_rows=None):
    """``fast_pw(md, x) -> (w, trigger, pw)`` of an ELL matrix through
    one Triton kernel over ceil(R / BR) row-block programs
    (``block_rows`` BR, a power of two >= 8; the last block is masked
    when BR does not divide R)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    R = mat.R
    BR = block_rows or _BLOCK_ROWS
    B8 = BR // 8
    G = -(-R // BR)
    ragged = R % BR != 0
    use_parity, use_cksum, det = _signals(mat, mode, detect)
    NW = len(det)
    K = mat.K
    gather_w = mat.layout.word_names.index(mat.ell_gather_word)
    mask_ecc = mat.ell_gather_word == "col" and mode in codec.ECC_MODES
    has_gidx = mat.perm is not None

    def kernel(*refs):
        vals_ref, x_ref, g_ref, len_ref = refs[:4]
        k = 4
        det_refs = refs[k:k + NW]
        k += NW
        if use_cksum:
            base_ref = refs[k]
            k += 1
        w_ref, pw_ref = refs[k:k + 2]
        flag_ref = refs[k + 2] if NW else None

        i = pl.program_id(0)
        rows = pl.ds(i * BR, BR)
        # Masks only where the last block overhangs R: a masked load
        # reads 0, so overhanging rows add nothing to w, pw or the folds.
        live = (i * BR + jnp.arange(BR) < R) if ragged else None
        live8 = (i * B8 + jnp.arange(B8) < R // 8) if ragged else None

        def load(ref, mask=live):
            return plt.load(ref, mask=mask, other=0 if ragged else None)

        ln = load(len_ref.at[rows])

        def slot(s, w):
            g = load(g_ref.at[s, rows])
            if not has_gidx:
                if mask_ecc:
                    g = g & np.uint32(ECC_COL_MASK)
                g = jax.lax.bitcast_convert_type(g, jnp.int32)
            # A corrupted index clamps like XLA's gather (detection
            # happens on the planes); padding slots read nothing.
            g = jnp.clip(g, 0, R - 1)
            valid = ln > s
            xg = plt.load(x_ref.at[g], mask=valid, other=0)
            v = load(vals_ref.at[s, rows])
            return w + jnp.where(valid, v * xg, 0)

        w = jax.lax.fori_loop(0, K, slot, jnp.zeros((BR,), vals_ref.dtype))
        xc = load(x_ref.at[rows])
        plt.store(w_ref.at[rows], w, mask=live)
        pw_ref[pl.ds(i, 1)] = jnp.full((1,), jnp.sum(w * xc), w.dtype)
        if not NW:
            return

        blk = pl.ds(i * B8, B8)
        tile8 = (jnp.broadcast_to(live8[:, None], (B8, 8)) if ragged
                 else None)
        bad = jnp.zeros((B8, 8), jnp.uint32)
        ckbad = jnp.zeros((B8,), jnp.int32)
        for j, dref in enumerate(det_refs):
            def plane(s, c, dref=dref):
                acc, par = c
                t = load(dref.at[s, blk, :], tile8)
                if use_parity:
                    par = par | _parity(t)
                return acc ^ t, par

            acc, bad = jax.lax.fori_loop(
                0, K, plane, (jnp.zeros((B8, 8), jnp.uint32), bad))
            if use_cksum:
                want = load(base_ref.at[j, blk], live8)
                ckbad = ckbad | (_xor8(acc) != want).astype(jnp.int32)
        flag = jnp.max(ckbad) | jnp.max(bad.astype(jnp.int32))
        flag_ref[pl.ds(i, 1)] = jnp.full((1,), flag, jnp.int32)

    def fast_pw(md: MatrixDevice, x):
        g = md.gidx if has_gidx else md.words[gather_w]
        args = [md.values, x, g, md.ell_len]
        if det == ("fold",):
            planes = [md.fold]
            base = md.fold_ck
        else:
            planes = [md.words[wi] for wi in det]
            base = md.cksum[np.array(det)] if det else None
        args += [p.reshape(K, R // 8, 8) for p in planes]
        if use_cksum:
            args.append(base)
        out_shape = [jax.ShapeDtypeStruct((R,), x.dtype),
                     jax.ShapeDtypeStruct((G,), x.dtype)]
        if NW:
            out_shape.append(jax.ShapeDtypeStruct((G,), jnp.int32))
        outs = pl.pallas_call(
            kernel,
            out_shape=out_shape,
            grid=(G,),
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                               num_stages=1),
            interpret=interpret,
            name="abft_spmv_ell",
        )(*args)
        trig = jnp.any(outs[2] != 0) if NW else jnp.bool_(False)
        return outs[0], trig, jnp.sum(outs[1])

    return fast_pw
