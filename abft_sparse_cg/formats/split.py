"""Outlier/bordered split: banded main part + flat tail part.

Mesh matrices with a few high-degree indices (boundary conditions,
constraint rows, Lagrange multipliers) defeat both banded layouts: the
dense rows blow the ELL padding (K*R) and connect everywhere, so no
reordering can recover a band.  The classical structure is *bordered*:
removing a handful of outlier indices leaves a nicely banded core.

``try_split`` decomposes A = M + T at the canonical level: ``tail`` =
every entry incident to an outlier index, ``main`` = the rest.  Each
part is an ordinary ProtectedMatrix (main goes through the usual
DIA/RCM/window machinery; the tail — tiny but wide — lands on the flat
layout), sharing one execution space (the tail is built with the main's
permutation imposed).  The SpMV is the sum of the parts' SpMVs; ABFT
events carry (part, slot) and map back to GLOBAL canonical indices, so
everything reference-visible (injection banners, `[ECC] corrected bit B
at index I`, error indices) is identical to the unsplit matrix.

ECC is encoded ONCE over the global canonical planes and the planes are
split by masks, so the codewords are bit-identical to an unsplit build
— the native backend keeps consuming the global planes directly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict

import numpy as np

from .loader import AssembledMatrix
from .protected import ProtectedMatrix, flat_checksums

__all__ = ["CompositeMatrix", "try_split", "try_band_split"]

_MAX_OUTLIERS = 256
_MAX_TAIL_FRAC = 0.25
# A handful of truly DENSE rows (classic arrowhead: k full rows over a
# thin core) can put most of nnz in the tail while remaining cheap —
# the span-window dense-tail plan turns them into T gather/scatter-free
# windowed AXPYs.  When the plan materializes and the outlier count is
# small, the tail fraction cap relaxes to:
_MAX_TAIL_FRAC_DENSE = 0.80
_FEW_OUTLIERS = 32
_DEG_FACTOR = 4

# --- band split (general matrices whose band exceeds the kernel cap) ---
# The thresholds and the per-entry cost model below are inherited from
# the layout routing's first design and have not been measured on a GPU;
# the ledger re-decides them (ROADMAP design debt 3).
_BAND_CUT_MAX = 1920         # widest "narrow" cut
_ROLLED_MAX_BAND = 16256     # a matrix banded under this stays WHOLE
_BAND_TAIL_MAX_FRAC = 0.10   # give up when the out-of-band tail is fat
# ... unless NO ordering keeps the band under _ROLLED_MAX_BAND: then a
# fat tail still wins as long as the banded main carries most entries.
_BAND_TAIL_FALLBACK_FRAC = 0.50
# Relative per-entry per-iteration cost weights for picking the cut:
# in-band entries cost in proportion to the window rows they span
# (narrow and wide cuts have separate slopes), tail entries pay a
# gather + scatter each.
_MAIN_NS_PER_WROW = 0.20
_MAIN_NS_SCAN = 0.012
_TAIL_NS = 12.0


def _main_ns(cut: int) -> float:
    return _MAIN_NS_PER_WROW if cut <= _BAND_CUT_MAX else _MAIN_NS_SCAN


@dataclass(frozen=True)
class CompositeMatrix:
    """A + S decomposition; duck-compatible with ProtectedMatrix where
    the backends/CLI need it (planes are GLOBAL canonical order)."""

    fmt: str
    mode: str
    N: int
    nnz: int
    layout: object
    planes: Dict[str, np.ndarray]       # global canonical planes
    row_ptr: np.ndarray                 # CSR only
    flat_cksum: np.ndarray              # native fast-scan checksums
    main: ProtectedMatrix
    tail: ProtectedMatrix
    idx_main: np.ndarray                # part canonical -> global canonical
    idx_tail: np.ndarray
    block_size: int = 0
    num_blocks: int = 1

    exec_kind = "split"

    @property
    def R(self) -> int:
        return self.main.R

    @property
    def K(self) -> int:
        return max(self.main.K, self.tail.K)

    @property
    def band(self) -> int:
        return self.main.band

    @property
    def perm(self):
        return self.main.perm

    @property
    def dia_offsets(self):
        return self.main.dia_offsets

    @property
    def exec_size(self) -> int:
        return self.main.exec_size + self.tail.exec_size

    def to_exec_order(self, v: np.ndarray) -> np.ndarray:
        return self.main.to_exec_order(v)

    def from_exec_order(self, v: np.ndarray) -> np.ndarray:
        return self.main.from_exec_order(v)

    def words_list(self):
        return [self.planes[n] for n in self.layout.word_names]

    def diagonal(self) -> np.ndarray:
        # The diagonal belongs to whichever part holds it; sum covers both.
        return self.main.diagonal() + self.tail.diagonal()

    def slot_to_canonical(self) -> np.ndarray:
        """Flat composite exec slot -> GLOBAL canonical element index
        (tail slots are offset by the main part's exec size)."""
        from ..backends.base import slot_to_canonical

        inv = np.full(self.exec_size, -1, dtype=np.int64)
        im = slot_to_canonical(self.main)
        sel = im >= 0
        inv[: self.main.exec_size][sel] = self.idx_main[im[sel]]
        it = slot_to_canonical(self.tail)
        sel = it >= 0
        inv[self.main.exec_size:][sel] = self.idx_tail[it[sel]]
        return inv

    def with_planes(self, planes: Dict[str, np.ndarray]) -> "CompositeMatrix":
        """Corruption semantics like ProtectedMatrix.with_planes: the new
        global planes are re-split; build-time checksums stay."""
        mainp = {n: p[self.idx_main] for n, p in planes.items()}
        tailp = {n: p[self.idx_tail] for n, p in planes.items()}
        return replace(self, planes=planes,
                       main=self.main.with_planes(mainp),
                       tail=self.tail.with_planes(tailp))

    def with_scrubbed_planes(self, planes) -> "CompositeMatrix":
        mainp = {n: p[self.idx_main] for n, p in planes.items()}
        tailp = {n: p[self.idx_tail] for n, p in planes.items()}
        return replace(
            self, planes=planes,
            flat_cksum=(flat_checksums(planes, self.layout, self.nnz)
                        if self.flat_cksum is not None else None),
            main=self.main.with_scrubbed_planes(mainp),
            tail=self.tail.with_scrubbed_planes(tailp),
        )


def try_band_split(fmt, assembled, mode, layout, planes, row_ptr, reorder,
                   row_align=None):
    """Band decomposition A = M + T for matrices whose (post-RCM)
    bandwidth exceeds the banded kernels' window cap: ``main`` = entries
    within a cut bandwidth (rides the compiled banded-ELL/DIA tier),
    ``tail`` = the out-of-band remainder on the flat layout.  This is
    the general-matrix answer the reference gets for free from its
    host row-gather kernel (reference CSR/CPUContext.cpp:115-133): the
    build keeps the scattered gather set as small as the structure
    allows.

    The cut is chosen by a per-iteration cost model (window rows scale
    the in-band cost; tail entries pay a gather + scatter); None when no
    cut leaves a thin enough tail (<= 10% nnz), in which case the caller
    keeps the whole matrix on one layout.
    """
    rows = assembled.rows.astype(np.int64)
    cols = assembled.cols.astype(np.int64)
    N, nnz = assembled.N, assembled.nnz

    cand_perms = [None]
    if reorder in ("auto", "rcm") and mode != "constraints":
        from .reorder import inverse_permutation, rcm_permutation

        cand_perms.append(rcm_permutation(rows, cols, N))
    pcands = []
    for perm in cand_perms:
        if perm is None:
            er, ec = rows, cols
        else:
            pos = inverse_permutation(perm)
            er, ec = pos[rows], pos[cols]
        off = np.abs(er - ec)
        pcands.append((perm, off, int(off.max()) if nnz else 0))

    # When some ordering keeps the WHOLE matrix banded under
    # _ROLLED_MAX_BAND, splits compete against it conservatively (thin
    # tails).  When NO ordering does, the cut search accepts fat tails:
    # a banded main carrying half the entries still wins.
    kernel_whole = any(band <= _ROLLED_MAX_BAND for _, _, band in pcands)
    # Candidate cuts span both slopes of the cost model (narrow to 1920,
    # wide to 16256); only the acceptable tail fraction is
    # regime-dependent.
    cuts = list(range(256, _BAND_CUT_MAX + 1, 256)) + list(
        range(_BAND_CUT_MAX + 1024, _ROLLED_MAX_BAND + 1, 1024))
    tail_cap = (_BAND_TAIL_MAX_FRAC if kernel_whole
                else _BAND_TAIL_FALLBACK_FRAC)
    forced = os.environ.get("ABFT_BAND_CUT")
    if forced:
        # Tuning/calibration override: force the cut bandwidth,
        # bypassing the cost search, the whole-matrix comparison, and
        # the tail cap (an explicit knob takes the user at their word).
        cuts = [int(forced)]
        kernel_whole = False
        tail_cap = 1.0

    best = None
    whole_cost = None   # best un-split option
    for perm, off, band in pcands:
        if band <= _ROLLED_MAX_BAND and not forced:
            wc = nnz * (2 * (band // 128) + 1) * _main_ns(band)
            if whole_cost is None or wc < whole_cost:
                whole_cost = wc
        for c in cuts:
            tail_n = int((off > c).sum())
            if tail_n == 0 or tail_n > tail_cap * nnz:
                continue
            wrows = 2 * (c // 128) + 1
            cost = ((nnz - tail_n) * wrows * _main_ns(c)
                    + tail_n * _TAIL_NS)
            if best is None or cost < best[0]:
                best = (cost, perm, c, off)
    if best is None or (whole_cost is not None and whole_cost <= best[0]):
        # Un-split is absent (no thin tail at any cut) or cheaper: the
        # caller's normal path keeps the whole matrix.
        return None
    _, perm, cut, off = best

    tail_mask = off > cut
    a_main = _sub_assembled(assembled, ~tail_mask)
    from .protected import build_protected

    main = build_protected(fmt, a_main, mode, reorder="none",
                           split="none", force_perm=perm,
                           row_align=row_align, _part=True)
    if main.exec_kind not in ("dia", "ell") or main.band > cut:
        return None
    a_tail = _sub_assembled(assembled, tail_mask)
    tail = build_protected(fmt, a_tail, mode, reorder="none", split="none",
                           force_perm=perm, force_exec="flat",
                           row_align=row_align, _part=True)
    if tail.R != main.R:
        return None

    from ..ecc.codec import ECC_MODES

    flat_cksum = (flat_checksums(planes, layout, nnz)
                  if mode in ECC_MODES else None)
    return CompositeMatrix(
        fmt=fmt, mode=mode, N=N, nnz=nnz, layout=layout,
        planes=planes, row_ptr=row_ptr, flat_cksum=flat_cksum,
        main=main, tail=tail,
        idx_main=np.flatnonzero(~tail_mask),
        idx_tail=np.flatnonzero(tail_mask),
        block_size=assembled.block_size,
        num_blocks=assembled.num_blocks,
    )


def _sub_assembled(a: AssembledMatrix, mask: np.ndarray) -> AssembledMatrix:
    # Canonical order is the (row, col) sort; a subsequence stays sorted.
    return AssembledMatrix(
        rows=a.rows[mask], cols=a.cols[mask], values=a.values[mask],
        N=a.N, nnz=int(mask.sum()),
        block_size=a.block_size, num_blocks=a.num_blocks,
    )


def try_split(fmt, assembled, mode, layout, planes, row_ptr, reorder,
              row_align=None):
    """Attempt the bordered decomposition; None if it doesn't pay off."""
    from ..ecc.codec import ECC_MODES
    from .protected import build_protected

    rows = assembled.rows.astype(np.int64)
    cols = assembled.cols.astype(np.int64)
    N, nnz = assembled.N, assembled.nnz

    deg = np.bincount(rows, minlength=N)
    med = max(1, int(np.median(deg[deg > 0])))
    cap = max(64, _DEG_FACTOR * med)
    outliers = np.flatnonzero(deg > cap)
    if not len(outliers) or len(outliers) > _MAX_OUTLIERS:
        return None
    is_out = np.zeros(N, dtype=bool)
    is_out[outliers] = True
    tail_mask = is_out[rows] | is_out[cols]
    tail_frac = tail_mask.sum() / max(nnz, 1)
    few = len(outliers) <= _FEW_OUTLIERS
    # Fat tails are only worth it in the dense-plan regime (checked
    # below, once the tail is built); beyond even that cap, bail early.
    if (tail_frac > (_MAX_TAIL_FRAC_DENSE if few else _MAX_TAIL_FRAC)
            or not (~tail_mask).any()):
        return None

    a_main = _sub_assembled(assembled, ~tail_mask)
    main = build_protected(fmt, a_main, mode, reorder=reorder, split="none",
                           row_align=row_align, _part=True)
    if main.exec_kind == "flat":
        return None  # the core is not banded either; flat alone is simpler

    a_tail = _sub_assembled(assembled, tail_mask)
    tail = build_protected(fmt, a_tail, mode, reorder="none", split="none",
                           force_perm=main.perm, row_align=row_align,
                           _part=True)
    if tail.R != main.R:
        return None  # should not happen (same N); stay safe
    if tail.exec_kind == "flat":
        from ..ops.spmv import dense_tail_plan

        plan = dense_tail_plan(tail, outliers)
        if plan is not None:
            tail = replace(tail, dense_plan=plan)
    if tail_frac > _MAX_TAIL_FRAC and not (
            few and getattr(tail, "dense_plan", None) is not None):
        # The fat tail did not earn the span-window path — a
        # gather over most of nnz would be slower than flat alone.
        return None

    flat_cksum = (flat_checksums(planes, layout, nnz)
                  if mode in ECC_MODES else None)
    return CompositeMatrix(
        fmt=fmt, mode=mode, N=N, nnz=nnz, layout=layout,
        planes=planes, row_ptr=row_ptr, flat_cksum=flat_cksum,
        main=main, tail=tail,
        idx_main=np.flatnonzero(~tail_mask),
        idx_tail=np.flatnonzero(tail_mask),
        block_size=assembled.block_size,
        num_blocks=assembled.num_blocks,
    )
