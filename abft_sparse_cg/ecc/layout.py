"""Codeword layouts for ABFT-protected sparse-matrix elements.

A protected element is a small fixed-width codeword made of 32-bit words.
The high byte of the *column* word (bits 24..31) is reserved for ECC:

  - bits 25..31 hold up to seven Hamming parity bits (bit ``32-p`` holds
    parity bit ``p``), enabling single-error *location* (and hence
    correction) anywhere in the codeword;
  - bit 24 holds an overall-parity bit (SEC8 / SECDED modes), enabling
    cheap single-error *detection* and double-error discrimination;
  - in SED mode bit 31 alone holds the overall parity.

Because the ECC bits live in the column word, column indices are limited
to 24 bits (N <= 2**24) whenever an ECC mode is active.

Two layouts exist, mirroring the two storage formats of the reference
implementation (see reference COO/ecc.h:7-16 and CSR/ecc.h:7-11):

  - ``COO128``: words ``[col, row, value_lo, value_hi]`` (128-bit codeword)
  - ``CSR96`` : words ``[value_lo, value_hi, col]``      (96-bit codeword)

``value_lo``/``value_hi`` are the low/high halves of the IEEE-754 binary64
bit pattern of the element value.  Keeping the value as two uint32 planes
(instead of a float64 array) is deliberate: every ECC operation is then
pure 32-bit integer math, which vectorizes on any accelerator and
never needs a float64 bitcast on device.

The Hamming construction (generated, not hard-coded): codeword positions
are numbered 3, 5, 6, 7, 9, ... (natural numbers with powers of two
skipped, starting at 3) and assigned in order to the data bits of the
codeword, skipping the reserved ECC byte.  Parity bit ``p`` covers every
position whose binary expansion has bit ``p-1`` set, plus its own storage
slot.  The resulting per-word AND-masks are computed once at import time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "CodewordLayout",
    "COO128",
    "CSR96",
    "NUM_PARITY_BITS",
    "ECC_COL_MASK",
    "OVERALL_PARITY_BIT",
    "SED_PARITY_BIT",
]

NUM_PARITY_BITS = 7

# Low 24 bits of the column word hold the real column index.
ECC_COL_MASK = np.uint32(0x00FFFFFF)

# Bit (within the column word) of the overall-parity bit in SEC8/SECDED.
OVERALL_PARITY_BIT = 24

# Bit (within the column word) of the overall-parity bit in SED.
SED_PARITY_BIT = 31


def _is_pow2(x: int) -> bool:
    return x != 0 and (x & (x - 1)) == 0


def _gen_hamming_masks(num_words: int, col_word: int) -> np.ndarray:
    """Generate the (7, num_words) uint32 parity masks for a layout.

    Global bit ``g = word*32 + bit`` for ``word`` in codeword order.  The
    reserved ECC byte occupies global bits [col_word*32+24, col_word*32+32);
    within it, parity bit ``p`` lives at global bit ``total_bits - p``
    (i.e. column-word bit ``32 - p``), and the remaining slot (column-word
    bit 24) is left uncovered so it can carry the overall-parity bit.
    """
    total_bits = num_words * 32
    region_lo = col_word * 32 + 24
    region_hi = col_word * 32 + 32
    masks = np.zeros((NUM_PARITY_BITS, num_words), dtype=np.uint64)

    x = 3  # first non-power-of-two Hamming position
    for g in range(total_bits):
        word, bit = divmod(g, 32)
        if region_lo <= g < region_hi:
            # Parity-bit storage slot: parity bit p covers itself
            # (parity bit p lives at column-word bit 32-p).
            p = col_word * 32 + 32 - g
            if 1 <= p <= NUM_PARITY_BITS:
                masks[p - 1, word] |= np.uint64(1) << np.uint64(bit)
            continue
        while _is_pow2(x):
            x += 1
        for p in range(1, NUM_PARITY_BITS + 1):
            if x & (1 << (p - 1)):
                masks[p - 1, word] |= np.uint64(1) << np.uint64(bit)
        x += 1

    return masks.astype(np.uint32)


@dataclass(frozen=True)
class CodewordLayout:
    """Static description of one protected-element codeword layout."""

    name: str
    num_words: int
    col_word: int
    word_names: tuple
    masks: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(
            self, "masks", _gen_hamming_masks(self.num_words, self.col_word)
        )

    @property
    def total_bits(self) -> int:
        return self.num_words * 32

    @property
    def parity_region_start(self) -> int:
        """Global bit index where the reserved ECC byte begins."""
        return self.col_word * 32 + 24

    def data_bit_count(self) -> int:
        return self.total_bits - 8


# Word order matches the in-memory order of the reference's element structs
# so that injected/printed bit indices agree with the reference numbering
# (reference COO/CPUContext.cpp:123-140, CSR/CPUContext.cpp:135-159).
COO128 = CodewordLayout("coo128", 4, 0, ("col", "row", "value_lo", "value_hi"))
CSR96 = CodewordLayout("csr96", 3, 2, ("value_lo", "value_hi", "col"))
