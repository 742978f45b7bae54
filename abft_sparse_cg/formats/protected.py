"""Protected matrix containers: flat canonical planes + ELL execution layout.

Two logical formats mirror the reference's two executables:

  - ``csr`` — codeword CSR96 ``[value_lo, value_hi, col]`` plus a row
    pointer; canonical element order is the loader's (row, col) sort
    (reference CSR/CPUContext.h:5-18).
  - ``coo`` — codeword COO128 ``[col, row, value_lo, value_hi]``; canonical
    element order is again the (row, col) sort (reference
    COO/ecc.h:11-16).

The *canonical flat planes* are the ground truth: ECC is encoded into
them at build time, fault injection flips their bits by (element index,
global bit) exactly like the reference injector, and the native C++
backend consumes them directly.

For the device compute path they are re-tiled into an *execution
layout*:

  - **ELL** (general): 2-D ``(K, R)`` planes grouped by output index
    (matrix row for CSR; matrix column for COO — valid because the
    loader symmetrizes), ``K`` = max group size.  Rows live on the minor
    axis — the transpose of textbook ELL — so each slot's plane is one
    contiguous stream.  SpMV is gather + multiply + slot-axis reduce.
  - **DIA** (banded fast path, chosen automatically): 2-D ``(D, R)``
    planes, one row per nonzero diagonal (offset = gather index − output
    index).  SpMV becomes a *stencil* — shifted multiply-adds with zero
    gathers, streamed at memory bandwidth, and the shape whose sharded
    form needs only halo exchanges instead of an all-gather.  Selected when the matrix has few distinct diagonals and
    they fill reasonably (mesh/CFD matrices like the reference's
    shallow_water1 and its block replicas qualify).

When the natural element order is not banded, ``build_protected`` can
apply a bandwidth-reducing symmetric permutation (RCM — see
formats.reorder) to the *execution* space only; the canonical planes,
their ECC bits, fault injection and all reference-visible indices stay
in the original order.  ``perm`` records it; vectors cross the boundary
via ``to_exec_order``/``from_exec_order``.

Both layouts pad with all-zero codewords (self-consistent under every
ECC mode) and keep a slot map from canonical element index to execution
slot so injected faults propagate and error slots map back to the
canonical indices the reference prints.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import numpy as np

from ..ecc import COO128, CSR96, CodewordLayout, codec
from ..ecc.values import f64_to_planes
from .loader import AssembledMatrix

__all__ = ["ProtectedMatrix", "build_protected", "FORMATS"]

FORMATS = ("csr", "coo")

_SUBLANE = 128  # rows pad to a multiple of 128 (whole checksum blocks
#                 and kernel row blocks).  Zero codewords are
#                 self-consistent padding.

# DIA is selected when distinct diagonals <= _DIA_MAX_D and the dense
# (D, R) layout wastes at most _DIA_MAX_EXPAND x the nnz footprint.
_DIA_MAX_D = 128
_DIA_MAX_EXPAND = 4.0


@dataclass(frozen=True)
class ProtectedMatrix:
    """An ABFT-protected sparse matrix (host-side planes)."""

    fmt: str                      # "csr" | "coo"
    mode: str                     # ABFT mode
    N: int
    nnz: int
    layout: CodewordLayout
    planes: Dict[str, np.ndarray]   # canonical flat planes, word order
    row_ptr: np.ndarray             # (N+1,) int64 — CSR only (None for coo)
    # Execution layout (derived; rebuilt after injection):
    exec_kind: str                  # "ell" | "dia"
    ell: Dict[str, np.ndarray]      # word name -> (K, R) or (D, R) uint32
    ell_len: np.ndarray             # (R,) int32 valid slots per output row
    ell_slot: np.ndarray            # (nnz,) int64 canonical idx -> flat slot
    ell_gather_word: str            # which word holds the gather index
    # Build-time (clean-matrix) XOR checksums of the exec planes at 8-row
    # block granularity: (num_words, R/8) uint32.  Captured at encode
    # time — fault injection must NOT refresh them (they play the role of
    # stored ECC metadata for the lazy-verification fast path).
    ell_cksum: np.ndarray = None
    # Same idea over the canonical FLAT planes, 8-element blocks —
    # consumed by the native backend's fast-scan path: (W, ceil(nnz/8)).
    flat_cksum: np.ndarray = None
    dia_offsets: tuple = ()         # DIA only: diagonal offsets, sorted
    block_size: int = 0
    num_blocks: int = 1
    # Exec-space reordering (formats.reorder): perm[new_row] = old_row,
    # None = identity.  Exec-space bandwidth max|gather - output| after
    # any reordering (the banded kernels' window bound).
    perm: np.ndarray = None
    band: int = 0
    # Bordered-split tails only (formats.split): ops.spmv.dense_tail_plan
    # result — (outlier exec rows, per-row span starts, span width S).
    # CLEAN build-time structural metadata (never derived from the
    # fault-exposed planes) that lets ops.spmv replace the flat path's
    # serialized gathers with span-densified outlier-row matvecs +
    # tiny-table selects.
    dense_plan: tuple = None

    @property
    def K(self) -> int:
        """ELL slots per row / number of diagonals (DIA) / max group
        length (flat)."""
        if self.exec_kind == "flat":
            return int(self.ell_len.max()) if len(self.ell_len) else 0
        return self.ell[self.ell_gather_word].shape[0]

    @property
    def R(self) -> int:
        """Padded output-row count of the execution layout."""
        return len(self.ell_len)

    @property
    def exec_row_axis(self) -> int:
        """Which axis of the execution planes is the output-row axis.
        Both layouts keep rows on the minor axis."""
        return 1

    def to_exec_order(self, v: np.ndarray) -> np.ndarray:
        """Canonical (N,) vector -> execution order (permuted rows)."""
        return v if self.perm is None else v[self.perm]

    def from_exec_order(self, v: np.ndarray) -> np.ndarray:
        """Execution-order (N,) vector -> canonical order."""
        if self.perm is None:
            return v
        out = np.empty_like(v)
        out[self.perm] = v
        return out

    @property
    def exec_size(self) -> int:
        return self.ell[self.ell_gather_word].size

    def words_list(self):
        """Flat planes as a list in codeword-word order."""
        return [self.planes[n] for n in self.layout.word_names]

    def diagonal(self) -> np.ndarray:
        """(N,) main-diagonal values from the canonical planes (for the
        Jacobi preconditioner — a capability beyond the reference).

        ECC correction is applied first so a corrupted-but-correctable
        diagonal yields the same preconditioner the (corrected) matrix
        multiplication actually uses."""
        from ..ecc import ECC_COL_MASK
        from ..ecc.values import planes_to_f64_np

        words, _ = codec.check_and_correct(self.mode, self.words_list(),
                                           self.layout)
        planes = dict(zip(self.layout.word_names, words))
        cols = planes["col"]
        if self.mode in codec.ECC_MODES:
            cols = cols & ECC_COL_MASK
        cols = cols.astype(np.int64)
        if self.fmt == "csr":
            rows = np.repeat(np.arange(self.N), np.diff(self.row_ptr))
        else:
            rows = planes["row"].astype(np.int64)
        vals = planes_to_f64_np(planes["value_lo"], planes["value_hi"])
        d = np.zeros(self.N)
        sel = rows == cols
        d[rows[sel]] = vals[sel]
        return d

    def with_planes(self, planes: Dict[str, np.ndarray]) -> "ProtectedMatrix":
        """Return a copy with new flat planes and a re-derived exec layout.

        Deliberately does NOT refresh ``ell_cksum``: new planes model
        *corruption* of stored data, and the checksums are reference
        metadata captured at encode time.
        """
        shape = self.ell[self.layout.word_names[0]].shape
        ell = _scatter_exec(planes, self.layout, self.ell_slot, shape)
        for name, aux in self.ell.items():  # non-word aux planes persist
            if name not in ell:
                ell[name] = aux
        return replace(self, planes=planes, ell=ell)

    def with_scrubbed_planes(self, planes: Dict[str, np.ndarray]
                             ) -> "ProtectedMatrix":
        """Like ``with_planes``, but the new planes are *repaired* data:
        the stored checksums are refreshed so the matrix is fully
        self-consistent again (what the reference's in-place write-back
        leaves behind, CSR/CPUContext.cpp:275-277)."""
        out = self.with_planes(planes)
        ell_cksum = compute_exec_checksums(out.ell, out.layout.word_names,
                                           out.exec_row_axis)
        flat_cksum = out.flat_cksum
        if flat_cksum is not None:
            flat_cksum = flat_checksums(planes, out.layout, out.nnz)
        return replace(out, ell_cksum=ell_cksum, flat_cksum=flat_cksum)


def _encode_planes(fmt, assembled: AssembledMatrix, mode: str):
    """Build the canonical flat planes, ECC bits included."""
    layout = CSR96 if fmt == "csr" else COO128
    if mode not in codec.MODES:
        raise ValueError(f"unknown ABFT mode: {mode!r}")
    if mode in codec.ECC_MODES and assembled.N > (1 << 24):
        raise ValueError(
            f"N={assembled.N} exceeds 2**24; ECC modes store parity bits in "
            "the high byte of the 32-bit column index"
        )
    vlo, vhi = f64_to_planes(assembled.values)
    col = assembled.cols.astype(np.uint32)
    row = assembled.rows.astype(np.uint32)
    if fmt == "csr":
        words = [vlo, vhi, col]
    else:
        words = [col, row, vlo, vhi]
    words = codec.encode(mode, words, layout)
    planes = dict(zip(layout.word_names, words))
    return layout, planes


CKSUM_BLOCK = 8  # rows per checksum block; 8 divides every padded R and
#                  every mesh shard (shards are multiples of 8 rows)


def flat_checksums(planes: Dict[str, np.ndarray], layout,
                   nnz: int) -> np.ndarray:
    """XOR checksums of the canonical FLAT planes per 8-element block —
    consumed by the native backend's fast-scan path: (W, ceil(nnz/8))."""
    nb = -(-max(nnz, 1) // CKSUM_BLOCK)
    out = np.zeros((layout.num_words, nb), dtype=np.uint32)
    for wi, name in enumerate(layout.word_names):
        p = np.zeros(nb * CKSUM_BLOCK, dtype=np.uint32)
        p[:nnz] = planes[name]
        out[wi] = np.bitwise_xor.reduce(p.reshape(nb, CKSUM_BLOCK), axis=1)
    return out


def compute_exec_checksums(ell: Dict[str, np.ndarray], word_names,
                           row_axis: int) -> np.ndarray:
    """XOR checksums of exec planes per 8-row block -> (W, R/8) uint32."""
    out = []
    for n in word_names:
        p = ell[n]
        folded = p if p.ndim == 1 else np.bitwise_xor.reduce(
            p, axis=1 - row_axis
        )
        out.append(
            np.bitwise_xor.reduce(
                folded.reshape(-1, CKSUM_BLOCK), axis=1
            )
        )
    return np.stack(out).astype(np.uint32)


def _scatter_exec(planes, layout, slot, shape):
    """Scatter flat planes into execution planes (all-zero padding)."""
    out = {}
    size = int(np.prod(shape))
    for name in layout.word_names:
        flat = np.zeros(size, dtype=np.uint32)
        flat[slot] = planes[name]
        out[name] = flat.reshape(shape)
    return out


# Layout-routing thresholds, inherited from the routing's first design
# and not yet measured on a GPU (the ledger re-decides them, ROADMAP
# design debt 3).  A reordering is adopted when it brings the exec-space
# bandwidth under _BAND_KERNEL_MAX — or when it makes the matrix
# DIA-eligible outright.
_BAND_KERNEL_MAX = 16256

# Past this exec-space bandwidth the build tries the band split
# (formats.split.try_band_split): a banded core plus a flat tail.
_BAND_SPLIT_TRIGGER = 1920

# ELL pads every output row to the longest one; when a few dense rows
# would blow the K*R footprint past this multiple of nnz, fall back to
# the memory-safe FLAT layout (1-D canonical-order planes, storage
# proportional to nnz like the reference's CSR; SpMV = gather + sorted
# segment-sum).
_ELL_MAX_EXPAND = 8.0


def _group_structure(group, gidx, N, nnz, presorted):
    """Per-group slot positions + group sizes, entries ordered by gather
    index within each group."""
    glen = np.bincount(group, minlength=N)
    gptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(glen, out=gptr[1:])
    within = np.empty(nnz, dtype=np.int64)
    if presorted:
        within = np.arange(nnz, dtype=np.int64) - gptr[group]
    else:
        order = np.lexsort((gidx, group))
        within[order] = np.arange(nnz, dtype=np.int64) - gptr[group[order]]
    return within, glen


def build_protected(fmt: str, assembled: AssembledMatrix, mode: str,
                    force_exec: str = None,
                    reorder: str = "auto",
                    split: str = "auto",
                    force_perm: np.ndarray = None,
                    row_align: int = None,
                    _part: bool = False):
    """Encode + lay out a protected matrix.

    ``force_exec``: None = auto-select execution layout; "ell"/"dia"
    forces one (tests, benchmarking layout comparisons).
    ``reorder``: "auto" = apply an RCM exec-space permutation when the
    natural order is not banded and the permuted one is (see
    formats.reorder); "rcm" = always attempt; None/"none" = never.
    Constraints mode never reorders (its checks assert the reference's
    natural-order invariants verbatim).
    ``split``: "auto" = when a few dense rows would blow up the ELL
    padding, return a formats.split.CompositeMatrix (banded main part +
    flat tail part); "none" = never (the flat layout then carries such
    matrices alone).
    ``force_perm``: impose a specific exec-space permutation (the split
    machinery aligns its parts with this; overrides ``reorder``).
    ``row_align``: pad the execution row count R up to a multiple of
    this (itself a multiple of 128).  A mesh-sharded solve needs R
    divisible by the shard granularity (8 rows/device for GSPMD), and
    aligning at BUILD time keeps the split layouts shardable (extra
    rows are zero codewords, exactly like the 128-row padding).  Layout-adoption heuristics
    ignore this padding: it is mandated by the mesh, not a property of
    the matrix structure.
    """
    if fmt not in FORMATS:
        raise ValueError(f"unknown format: {fmt!r}")
    layout, planes = _encode_planes(fmt, assembled, mode)

    rows = assembled.rows.astype(np.int64)
    cols = assembled.cols.astype(np.int64)
    N, nnz = assembled.N, assembled.nnz
    R0 = -(-N // _SUBLANE) * _SUBLANE   # structural padding only
    R = R0
    if row_align:
        if row_align % _SUBLANE:
            raise ValueError(
                f"row_align ({row_align}) must be a multiple of "
                f"{_SUBLANE}")
        R = -(-R0 // row_align) * row_align

    # CSR row pointer over the canonical (row, col) order.
    counts = np.bincount(rows, minlength=N)
    row_ptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])

    # Group = output index (matrix row for CSR; matrix column for COO —
    # the reference's COO kernel scatters into `col`,
    # COO/CPUContext.cpp:119); gather = the other index.
    gather_word = "col" if fmt == "csr" else "row"

    def exec_indices(perm):
        if perm is None:
            er, ec = rows, cols
        else:
            from .reorder import inverse_permutation

            pos = inverse_permutation(perm)
            er, ec = pos[rows], pos[cols]
        return (er, ec) if fmt == "csr" else (ec, er)

    def dia_check(group, gidx):
        offs = gidx - group
        uoffs, inv = np.unique(offs, return_inverse=True)
        ok = (
            nnz > 0
            and len(uoffs) <= _DIA_MAX_D
            # Expansion judged against the structural row count R0:
            # mesh-alignment padding is paid regardless of layout.
            and len(uoffs) * R0 <= _DIA_MAX_EXPAND * max(nnz, 1)
        )
        if ok:
            # A (group, offset) collision (duplicate entries) cannot be
            # represented densely; fall back to ELL.
            ok = np.unique(inv * R + group).size == nnz
        return ok, uoffs, inv

    perm = force_perm if mode != "constraints" else None
    group, gidx = exec_indices(perm)
    dia_ok, uoffs, inv = dia_check(group, gidx)
    band = int(np.abs(gidx - group).max()) if nnz else 0

    if (perm is None and not dia_ok and mode != "constraints" and nnz > 0
            and reorder in ("auto", "rcm")):
        from .reorder import rcm_permutation

        cand = rcm_permutation(rows, cols, N)
        pgroup, pgidx = exec_indices(cand)
        pdia_ok, puoffs, pinv = dia_check(pgroup, pgidx)
        pband = int(np.abs(pgidx - pgroup).max())
        # Adopt when it unlocks the DIA stencil, or narrows the band
        # under _BAND_KERNEL_MAX.
        if pdia_ok or (pband < band and pband <= _BAND_KERNEL_MAX):
            perm = cand
            group, gidx = pgroup, pgidx
            dia_ok, uoffs, inv = pdia_ok, puoffs, pinv
            band = pband

    if force_exec in ("ell", "flat"):
        dia_ok = False
    elif force_exec == "dia" and not dia_ok:
        raise ValueError("matrix is not representable as DIA")

    within, glen = _group_structure(
        group, gidx, N, nnz,
        presorted=(perm is None and fmt == "csr"),
    )
    K = max(1, int(glen.max()) if nnz else 1)
    ell_len = np.zeros(R, dtype=np.int32)
    ell_len[:N] = glen

    if dia_ok:
        exec_kind = "dia"
        ell_slot = inv * R + group
        ell = _scatter_exec(planes, layout, ell_slot, (len(uoffs), R))
        dia_offsets = tuple(int(o) for o in uoffs)
    elif force_exec != "ell" and nnz and (
            force_exec == "flat" or K * R0 > _ELL_MAX_EXPAND * nnz):
        if split == "auto" and force_exec is None and force_perm is None:
            from .split import try_split

            comp = try_split(fmt, assembled, mode, layout, planes, row_ptr,
                             reorder, row_align=row_align)
            if comp is not None:
                return comp
        # FLAT: 1-D planes in exec-sorted canonical order, padded to a
        # multiple of 8 with zero codewords; the slot map is the sort
        # order itself.
        exec_kind = "flat"
        nnz_pad = -(-nnz // CKSUM_BLOCK) * CKSUM_BLOCK
        order = np.lexsort((gidx, group))
        ell_slot = np.empty(nnz, dtype=np.int64)
        ell_slot[order] = np.arange(nnz, dtype=np.int64)
        ell = {}
        for name in layout.word_names:
            flat = np.zeros(nnz_pad, dtype=np.uint32)
            flat[ell_slot] = planes[name]
            ell[name] = flat
        # Output index per exec slot (the segment ids of the reduce).
        grp_exec = np.zeros(nnz_pad, dtype=np.int32)
        grp_exec[ell_slot] = group.astype(np.int32)
        grp_exec[nnz:] = R - 1 if R else 0   # padding joins the last row
        ell["__flat_group__"] = grp_exec
        dia_offsets = ()
    else:
        if (split == "auto" and force_exec is None and force_perm is None
                and nnz and band > _BAND_SPLIT_TRIGGER):
            # Wide band: peel the out-of-band entries into a flat tail
            # so the banded core keeps a narrow window.
            from .split import try_band_split

            comp = try_band_split(fmt, assembled, mode, layout, planes,
                                  row_ptr, reorder, row_align=row_align)
            if comp is not None:
                return comp
        if force_exec is None and force_perm is None and not _part and (
                band > _BAND_KERNEL_MAX or K < 2):
            # The band split did not pay and the band stays past
            # _BAND_KERNEL_MAX (the uniform-random-graph shape), or K=1:
            # rebuild on the flat layout — a flat gather (nnz elements)
            # never loses to an ELL gather (K*R).
            return build_protected(fmt, assembled, mode,
                                   force_exec="flat", reorder=reorder,
                                   split="none", force_perm=force_perm,
                                   row_align=row_align)
        exec_kind = "ell"
        # Transposed ELL: rows on the minor axis (see module docstring)
        # — flat slot = k * R + r.
        ell_slot = within * R + group
        ell = _scatter_exec(planes, layout, ell_slot, (K, R))
        dia_offsets = ()

    ell_cksum = compute_exec_checksums(
        {n: ell[n] for n in layout.word_names}, layout.word_names,
        row_axis=1)
    flat_cksum = None
    if mode in codec.ECC_MODES:  # only the native lazy paths consume it
        flat_cksum = flat_checksums(planes, layout, nnz)

    return ProtectedMatrix(
        fmt=fmt,
        mode=mode,
        N=N,
        nnz=nnz,
        layout=layout,
        planes=planes,
        row_ptr=row_ptr if fmt == "csr" else None,
        exec_kind=exec_kind,
        ell=ell,
        ell_len=ell_len,
        ell_slot=ell_slot,
        ell_gather_word=gather_word,
        ell_cksum=ell_cksum,
        flat_cksum=flat_cksum,
        dia_offsets=dia_offsets,
        block_size=assembled.block_size,
        num_blocks=assembled.num_blocks,
        perm=perm,
        band=band,
    )
