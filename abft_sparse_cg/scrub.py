"""Offline matrix scrub: verify and repair a protected matrix in one pass.

The reference repairs elements in place as the SpMV touches them; the
device solve repairs functionally via the solver's classify pass.  This is
the third form — an explicit maintenance operation (memory scrubbing in
the RAS sense): run the full ECC check over the canonical planes,
correct what is correctable, report what is not.

Host-side NumPy (the canonical planes live on the host); the same codec
the device kernels use, so outcomes are identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .ecc import OVERALL_PARITY_BIT, codec
from .formats.protected import ProtectedMatrix

__all__ = ["ScrubReport", "scrub", "scrubbed_from_device"]


def scrubbed_from_device(mat: ProtectedMatrix, md) -> ProtectedMatrix:
    """Materialize a solve's final device planes as a host matrix.

    ``md`` is the MatrixDevice a solver returned (``CGResult.md``).  When
    the lazy loop repaired a fault, those planes are the scrubbed data —
    this is the observable equivalent of the reference's in-place
    write-back (CSR/CPUContext.cpp:275-277): after a faulty solve, the
    caller holds a repaired, fully self-consistent matrix.
    """
    if mat.exec_kind == "split":
        main = scrubbed_from_device(mat.main, md[0])
        tail = scrubbed_from_device(mat.tail, md[1])
        planes = {}
        for n in mat.layout.word_names:
            g = mat.planes[n].copy()
            g[mat.idx_main] = main.planes[n]
            g[mat.idx_tail] = tail.planes[n]
            planes[n] = g
        return mat.with_scrubbed_planes(planes)
    planes = {}
    shape0 = mat.ell[mat.layout.word_names[0]].shape
    for name, w in zip(mat.layout.word_names, md.words):
        arr = np.asarray(w)
        if arr.shape != shape0:
            # Mesh-padded planes (parallel.sharded): strip the row padding
            # (2-D layouts) or the appended entry padding (1-D flat) so
            # flat slot indices line up with the canonical slot map.
            if arr.ndim == 1:
                arr = arr[: shape0[0]]
            else:
                ra = mat.exec_row_axis
                arr = arr[: shape0[0]] if ra == 0 else arr[:, : shape0[1]]
        planes[name] = np.ascontiguousarray(arr.reshape(-1)[mat.ell_slot],
                                            dtype=np.uint32)
    return mat.with_scrubbed_planes(planes)


@dataclass
class ScrubReport:
    corrected: int              # elements repaired
    uncorrectable: int          # sed detections / secded double-bit errors
    indices: List[int]          # canonical indices of repaired elements
    messages: List[str]         # reference-format event strings


def scrub(mat: ProtectedMatrix):
    """Return ``(repaired_matrix, report)``.

    For correction modes (sec7/sec8/secded) repaired planes replace the
    corrupted ones (and the derived execution layout is rebuilt; the
    encode-time checksums then match again by construction).  Detection
    modes (sed/secded double-bit) only report.
    """
    words = mat.words_list()
    fixed, flags = codec.check_and_correct(mat.mode, words, mat.layout)

    opb = mat.layout.col_word * 32 + OVERALL_PARITY_BIT
    messages = []
    indices = np.flatnonzero(np.asarray(flags["corrected"]))
    for i in indices:
        bit = int(flags["corrected_bit"][i])
        if bit == opb:
            messages.append(f"[ECC] corrected overall parity bit at index {i}")
        else:
            messages.append(f"[ECC] corrected bit {bit} at index {i}")

    uncorrectable = int(np.asarray(flags["detected"]).sum())
    for i in np.flatnonzero(np.asarray(flags["detected"])):
        if mat.mode == "sed":
            messages.append(f"[ECC] error detected at index {int(i)}")
        else:
            messages.append("[ECC] double-bit error detected")

    repaired = mat.with_planes(dict(zip(mat.layout.word_names, fixed)))
    report = ScrubReport(
        corrected=len(indices),
        uncorrectable=uncorrectable,
        indices=[int(i) for i in indices],
        messages=messages,
    )
    return repaired, report
