"""Backend protocol + host-side result shared by all targets."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..ecc import OVERALL_PARITY_BIT
from ..formats.protected import ProtectedMatrix
from ..ops.spmv import ERRCODES

__all__ = ["HostResult", "Backend", "default_dtype", "stats_to_messages"]


@dataclass
class HostResult:
    """Solve outcome, host types only (what the CLI prints from)."""

    x: np.ndarray
    iterations: int
    rr: float
    errcode: int
    err_index: int              # canonical element index (-1 if none)
    corrected_count: int
    corrected_index: int
    corrected_bit: int
    messages: List[str] = field(default_factory=list)
    solve_seconds: float = 0.0
    compile_seconds: float = 0.0
    rr_trace: Optional[np.ndarray] = None
    scrubbed: Optional[ProtectedMatrix] = None
    # ^ repaired matrix when the solve corrected a fault (the reference's
    #   in-place write-back, observable post-solve).
    route: str = ""
    # ^ the SpMV route the solve actually ran (ops.spmv_pallas.ROUTES for
    #   the pallas target, "xla" for jnp, "native" for cpu).

    @property
    def failed(self) -> bool:
        return self.errcode != 0


def default_dtype(requested: str = "auto"):
    """Compute-dtype policy: f64 when asked for, or on the CPU; ``auto``
    stays f32 on accelerators (binary64 storage is unchanged either
    way — only the vectors and the rebuilt value plane change width)."""
    import jax
    import jax.numpy as jnp

    if requested in ("f32", "float32"):
        return jnp.float32
    if requested in ("f64", "float64") or (
            requested == "auto" and jax.devices()[0].platform == "cpu"):
        if not jax.config.read("jax_enable_x64"):
            jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def slot_to_canonical(mat: ProtectedMatrix) -> np.ndarray:
    """Inverse of ell_slot: flat exec slot -> canonical element index."""
    inv = np.full(mat.exec_size, -1, dtype=np.int64)
    inv[mat.ell_slot] = np.arange(mat.nnz, dtype=np.int64)
    return inv


def stats_to_messages(mat: ProtectedMatrix, errcode, err_slot, cor_slot,
                      cor_bit, r_dev: int = None):
    """Render ABFT events with the reference's exact stdout strings.

    The correction strings come from CSR/CPUContext.cpp:278,324,331; the
    detection strings from :233,398 (grep'd verbatim by run_tests:35,75).
    Slots are flat ELL positions; they are mapped back to the canonical
    element index the reference would print.  ``r_dev``: the device
    planes' row count when it differs from ``mat.R`` (mesh padding —
    parallel.sharded pads rows to a multiple of 8 * n_devices), so flat
    device slots re-map onto the canonical slot grid.
    """
    # Composite (bordered-split) matrices own their slot routing.
    if hasattr(mat, "slot_to_canonical"):
        inv = mat.slot_to_canonical()
    else:
        inv = slot_to_canonical(mat)

    def canon_slot(slot):
        if r_dev is None or r_dev == mat.R or slot < 0:
            return slot
        k, r = divmod(slot, r_dev)
        return k * mat.R + r if r < mat.R else -1

    err_slot = canon_slot(err_slot)
    cor_slot = canon_slot(cor_slot)
    msgs = []
    err_index = -1
    opb_global = mat.layout.col_word * 32 + OVERALL_PARITY_BIT

    if cor_slot >= 0:
        idx = int(inv[cor_slot])
        if cor_bit == opb_global:
            msgs.append(f"[ECC] corrected overall parity bit at index {idx}")
        else:
            msgs.append(f"[ECC] corrected bit {cor_bit} at index {idx}")

    if errcode != 0:
        template = ERRCODES[mat.fmt][errcode]
        if err_slot >= 0:
            err_index = int(inv[err_slot])
        if "{index}" in template:
            msgs.append(template.format(index=err_index))
        else:
            msgs.append(template)  # double-bit / breakdown: no index

    return msgs, err_index


class Backend:
    """Interface every target implements (duck-typed; see registry)."""

    target = "?"

    def solve(self, mat: ProtectedMatrix, b: np.ndarray, max_itrs: int,
              conv_threshold: float, verbose: bool = True,
              dtype: str = "auto", precond: str = "none",
              devices: int = 0, solver: str = "standard") -> HostResult:
        """``devices`` > 1: row-shard the solve over a 1-D device mesh
        (GSPMD; parallel.sharded).  0/1 = single device.
        ``solver``: "standard" (the reference loop) or "pipelined"
        (Ghysels-Vanroose, one reduction point per iteration)."""
        raise NotImplementedError

    def spmv_once(self, mat: ProtectedMatrix, x: np.ndarray,
                  dtype: str = "auto"):
        """One A@x for the driver's final verification (cg.cpp:127-144)."""
        raise NotImplementedError

    @staticmethod
    def _host_residual_spmv(mat, x):
        """Binary64 A@x on the HOST through the ECC correct-on-read
        oracle — the refinement restart's residual SpMV.  Device-free on
        purpose: the protected planes are host-resident binary64 already,
        and the result must not depend on the device dtype.  Works on plain and
        composite (split) matrices alike (both expose the GLOBAL
        canonical planes).  Returns (w, errcode, messages) mirroring
        spmv_once."""
        from ..ecc import ECC_COL_MASK, codec
        from ..ecc.values import planes_to_f64_np
        from ..ops.spmv import ERR_DOUBLE, ERR_SED

        words, flags = codec.check_and_correct(mat.mode, mat.words_list(),
                                               mat.layout)
        planes = dict(zip(mat.layout.word_names, words))
        cols = planes["col"]
        if mat.mode in codec.ECC_MODES:
            cols = cols & ECC_COL_MASK
        cols = np.clip(cols.astype(np.int64), 0, mat.N - 1)
        if mat.fmt == "csr":
            rows = np.repeat(np.arange(mat.N), np.diff(mat.row_ptr))
        else:
            rows = np.clip(planes["row"].astype(np.int64), 0, mat.N - 1)
        vals = planes_to_f64_np(planes["value_lo"], planes["value_hi"])
        w = np.zeros(mat.N)
        np.add.at(w, rows, vals * np.asarray(x, np.float64)[cols])
        errcode, err_slot = 0, -1
        if mat.mode == "sed" and flags["detected"].any():
            errcode = ERR_SED
            err_slot = int(np.flatnonzero(flags["detected"])[0])
        elif mat.mode == "secded" and flags["double"].any():
            errcode = ERR_DOUBLE
            err_slot = int(np.flatnonzero(flags["double"])[0])
        # The flags arrays index CANONICAL elements (host plane order),
        # so messages are emitted directly — stats_to_messages expects
        # exec slots.
        msgs = []
        cor = np.flatnonzero(flags["corrected"])
        if len(cor):
            idx = int(cor[0])
            bit = int(flags["corrected_bit"].reshape(-1)[idx])
            opb_global = mat.layout.col_word * 32 + OVERALL_PARITY_BIT
            if bit == opb_global:
                msgs.append(
                    f"[ECC] corrected overall parity bit at index {idx}")
            else:
                msgs.append(f"[ECC] corrected bit {bit} at index {idx}")
        if errcode != 0:
            template = ERRCODES[mat.fmt][errcode]
            msgs.append(template.format(index=err_slot)
                        if "{index}" in template else template)
        return w, errcode, msgs

    def solve_refined(self, mat: ProtectedMatrix, b: np.ndarray,
                      max_itrs: int, conv_threshold: float, refine: int,
                      **kw) -> HostResult:
        """Mixed-precision iterative refinement (CLI ``--refine K``):
        up to ``refine`` rounds of [f32 inner CG on the current
        residual] + [binary64 TRUE-residual restart].

        An alternative to the reference's end-to-end f64 compute
        (reference cg.cpp:59-144): the stored planes ARE binary64
        (value_lo/value_hi), so the f64 residual r = b - A.x is exact
        w.r.t. the protected data, while the per-iteration hot loop
        stays in f32 (half the vector bytes of --dtype f64).  f32 CG stalls at a true residual
        ~ eps_f32 * cond(A); each refinement restart re-anchors against
        the f64 residual, recovering f64-level final accuracy for any
        system the inner iteration can reduce — the classic
        mixed-precision refinement guarantee.  Host-level wrapper, so
        every target supports it; ``rr`` in the result is the TRUE f64
        squared residual norm (the reference's convergence quantity),
        and ``iterations`` sums the inner solves' counts.

        ABFT interplay: each inner solve runs the full detect/correct/
        fail-stop machinery; a nonzero errcode aborts refinement with
        that result (fail-stop wins).  The f64 residual SpMV itself
        rides the correct-on-read oracle path."""
        from dataclasses import replace as _dc_replace

        inner_kw = dict(kw)
        inner_kw.pop("reps", None)
        x = np.zeros(mat.N, dtype=np.float64)
        b64 = np.asarray(b, dtype=np.float64)
        rhs = b64
        total_iters = 0
        total_solve = total_compile = 0.0
        msgs = []
        corrected = 0
        res = None
        rr = float(b64 @ b64)
        for _round in range(max(1, refine + 1)):
            if rr <= conv_threshold:
                break
            # Inner tolerance: reduce the residual-norm^2 by ~1e6 per
            # round (norm by 1e3), floored at the caller's target — the
            # f32 loop stops where it stalls anyway via max_itrs.
            inner_conv = max(conv_threshold, rr * 1e-6)
            res = self.solve(mat, rhs, max_itrs, inner_conv,
                             reps=1, **inner_kw)
            total_iters += res.iterations
            total_solve += res.solve_seconds
            total_compile += res.compile_seconds
            corrected += res.corrected_count
            msgs.extend(res.messages)
            if res.errcode != 0:
                return _dc_replace(res, iterations=total_iters,
                                   messages=msgs,
                                   solve_seconds=total_solve,
                                   compile_seconds=total_compile)
            x = x + np.asarray(res.x, dtype=np.float64)
            # Binary64 true residual ON HOST: the planes are already
            # host-resident binary64 — a numpy SpMV through the ECC
            # correct-on-read oracle is both exact and device-free.
            w, errcode, emsgs = self._host_residual_spmv(mat, x)
            # Correction lines from the residual pass are usually
            # re-reads of the same persistent fault an inner solve
            # already reported — dedupe by exact event string so a
            # fault FIRST corrected during a restart is still surfaced
            # (and counted), while repeats stay silent.
            fresh = [m for m in emsgs if m not in msgs]
            msgs.extend(fresh)
            corrected += sum(1 for m in fresh if "corrected bit" in m)
            if errcode != 0:
                return _dc_replace(res, x=x, errcode=errcode,
                                   iterations=total_iters, messages=msgs,
                                   corrected_count=corrected,
                                   solve_seconds=total_solve,
                                   compile_seconds=total_compile)
            r64 = b64 - np.asarray(w, dtype=np.float64)
            rr = float(r64 @ r64)
            rhs = r64
        if res is None:   # ||b||^2 already under the threshold
            return HostResult(x=x, iterations=0, rr=rr, errcode=0,
                              err_index=-1, corrected_count=0,
                              corrected_index=-1, corrected_bit=-1)
        return _dc_replace(res, x=x, rr=rr, iterations=total_iters,
                           messages=msgs, corrected_count=corrected,
                           solve_seconds=total_solve,
                           compile_seconds=total_compile)
