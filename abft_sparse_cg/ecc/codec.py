"""Vectorized ECC encode / check / correct over plane-of-uint32 codewords.

Every function here operates on *planes*: a protected matrix with ``nnz``
elements is stored as ``layout.num_words`` arrays of uint32, one array per
codeword word, in codeword-word order.  All operations are elementwise
32-bit integer math (AND/XOR/shift/popcount), so the same code runs

  - in NumPy on the host (matrix build time, fault injection, tests), and
  - in jax.numpy on device (fused into the SpMV compute path), where
    it maps onto plain vectorized integer ops.

Semantics follow the reference ABFT modes (reference COO/CPUContext.cpp:
196-379, CSR/CPUContext.cpp:209-411):

  ==========  ====================================================only=====
  mode        behaviour
  ==========  ========================================================
  none        no ECC bits; planes carry raw data
  sed         overall parity in col bit 31; 1-bit flips *detected*
  sec7        7 Hamming bits in col bits 25..31; 1-bit flips *corrected*
  sec8        Hamming + overall parity in col bit 24; parity checked
              first (cheap), syndrome only on failure; corrects data
              bits and the parity bit itself
  secded      like sec8, plus double-bit *detection*: syndrome != 0 with
              clean overall parity means an uncorrectable 2-bit error
  ==========  ========================================================

Unlike the reference (which mutates the matrix in place from inside the
SpMV), correction here is value-level: ``check_and_correct`` returns the
corrected planes plus per-element flags; callers decide whether to use the
corrected data transiently (correct-on-read) or persist it (scrub).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .layout import (
    CodewordLayout,
    NUM_PARITY_BITS,
    OVERALL_PARITY_BIT,
    SED_PARITY_BIT,
)

__all__ = [
    "MODES",
    "ECC_MODES",
    "encode",
    "overall_parity",
    "syndrome",
    "decode_flipped_bit",
    "check_and_correct",
    "flip_bits",
]

MODES = ("none", "constraints", "sed", "sec7", "sec8", "secded")
ECC_MODES = ("sed", "sec7", "sec8", "secded")


# --------------------------------------------------------------------------
# Array-module shims: the only operations that differ between NumPy and JAX.
# --------------------------------------------------------------------------

def _xp(arr):
    """Return the array module (numpy or jax.numpy) for ``arr``."""
    if isinstance(arr, np.ndarray) or np.isscalar(arr):
        return np
    import jax.numpy as jnp  # deferred: keep NumPy paths importable w/o jax

    return jnp


def _popcount(x):
    if _xp(x) is np:
        return np.bitwise_count(x).astype(np.uint32)
    import jax

    return jax.lax.population_count(x)


def _parity32(x):
    """Bitwise parity (popcount mod 2) of each uint32 lane."""
    return _popcount(x) & np.uint32(1)


def _bit_length_u8(x):
    """bit_length for small positive ints (x < 256), vectorized."""
    xp = _xp(x)
    out = xp.zeros_like(x)
    v = x
    for _ in range(8):
        out = xp.where(v > 0, out + np.uint32(1), out)
        v = v >> np.uint32(1)
    return out


def _u32(x):
    return np.uint32(x)


# --------------------------------------------------------------------------
# Core primitives
# --------------------------------------------------------------------------

def overall_parity(words: Sequence) -> "array":
    """Overall (1-bit) parity of each codeword: popcount(xor of words) & 1."""
    acc = words[0]
    for w in words[1:]:
        acc = acc ^ w
    return _parity32(acc)


def syndrome(words: Sequence, layout: CodewordLayout):
    """7-bit Hamming syndrome, packed into bits 25..31 of a uint32.

    Computing this on already-encoded codewords yields 0 when clean and a
    nonzero syndrome locating the flipped bit otherwise; computing it on a
    codeword with zeroed ECC bits yields the parity bits to store.
    """
    xp = _xp(words[0])
    masks = layout.masks  # (7, num_words) np.uint32 constants
    result = xp.zeros_like(words[0])
    for p in range(1, NUM_PARITY_BITS + 1):
        acc = words[0] & _u32(masks[p - 1, 0])
        for w in range(1, layout.num_words):
            acc = acc ^ (words[w] & _u32(masks[p - 1, w]))
        result = result | (_parity32(acc) << _u32(32 - p))
    return result


def decode_flipped_bit(syn, layout: CodewordLayout):
    """Map a nonzero syndrome to the global bit index of the flipped bit.

    Bit numbering matches the reference's injector/printout numbering
    (global bit ``g = word*32 + bit`` in codeword-word order):
      - COO128: 0..31 col, 32..63 row, 64..127 value
      - CSR96 : 0..63 value, 64..95 col
    Result is undefined for a zero syndrome (callers must gate on syn != 0).
    """
    xp = _xp(syn)
    # Hamming position x: parity bit p contributes 2**(p-1).
    x = xp.zeros_like(syn)
    for p in range(1, NUM_PARITY_BITS + 1):
        x = x | (((syn >> _u32(32 - p)) & _u32(1)) << _u32(p - 1))

    blen = _bit_length_u8(x)
    is_pow2 = (x != 0) & ((x & (x - _u32(1))) == 0)

    # Non-power-of-two position -> data bit, numbered skipping the ECC byte.
    data_bit = x - blen - _u32(1)
    region_start = _u32(layout.parity_region_start)
    data_bit = _xp(syn).where(data_bit >= region_start, data_bit + _u32(8), data_bit)

    # Power-of-two position -> one of the stored parity bits themselves:
    # parity bit p lives at column-word bit 32-p, i.e. global bit
    # col_word*32 + 31 - log2(x).
    parity_bit = _u32(layout.col_word * 32) + _u32(31) - (blen - _u32(1))

    return xp.where(is_pow2, parity_bit, data_bit)


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

def encode(mode: str, words: Sequence, layout: CodewordLayout):
    """Set the ECC bits of ``mode`` into fresh codeword planes.

    ``words`` must carry a clean 24-bit column (high byte zero).  Returns a
    new list of planes; only the column word changes.  Matches the encode
    order of the reference: Hamming bits first, then overall parity over
    the codeword *including* the Hamming bits (reference CSR/CPUContext.cpp:
    291-295).
    """
    if mode not in MODES:
        raise ValueError(f"unknown ABFT mode: {mode!r}")
    words = list(words)
    cw = layout.col_word

    if mode in ("none", "constraints"):
        return words

    if mode == "sed":
        par = overall_parity(words)
        words[cw] = words[cw] | (par << _u32(SED_PARITY_BIT))
        return words

    # sec7 / sec8 / secded all start with the Hamming bits.
    words[cw] = words[cw] | syndrome(words, layout)
    if mode == "sec7":
        return words

    # sec8 / secded: overall parity (covering the Hamming bits) in bit 24.
    par = overall_parity(words)
    words[cw] = words[cw] | (par << _u32(OVERALL_PARITY_BIT))
    return words


# --------------------------------------------------------------------------
# Check + correct
# --------------------------------------------------------------------------

def _xor_bit_into_planes(words, global_bit, do_it, layout):
    """XOR bit ``global_bit`` (per-element) into the planes where ``do_it``."""
    xp = _xp(words[0])
    out = []
    for w in range(layout.num_words):
        hit = do_it & ((global_bit >> _u32(5)) == _u32(w))
        mask = xp.where(hit, _u32(1) << (global_bit & _u32(31)), _u32(0))
        out.append(words[w] ^ mask)
    return out


def check_and_correct(mode: str, words: Sequence, layout: CodewordLayout):
    """Verify (and for SEC modes repair) each codeword.

    Returns ``(corrected_words, flags)`` where ``flags`` is a dict of
    per-element arrays:

      - ``detected``      bool: an uncorrectable-by-this-mode error was seen
                          (sed detection; secded double-bit)
      - ``corrected``     bool: a bit was corrected (sec7/sec8/secded)
      - ``corrected_bit`` uint32: which global bit was fixed (else 0)
      - ``double``        bool: secded double-bit signature

    Mirrors the lazy/eager structure of the reference modes: sed computes
    only overall parity; sec7 computes the syndrome unconditionally; sec8
    and secded compute overall parity always and use the syndrome to locate
    the flip.  (secded here adopts sec8's parity-first structure — the
    syndrome is still *logically* evaluated for every element, but XLA/the
    kernel may skip it on the all-clean fast path.)
    """
    xp = _xp(words[0])
    zeros_b = xp.zeros(words[0].shape, dtype=bool)
    zeros_u = xp.zeros(words[0].shape, dtype=np.uint32)
    flags = {
        "detected": zeros_b,
        "corrected": zeros_b,
        "corrected_bit": zeros_u,
        "double": zeros_b,
    }

    if mode in ("none", "constraints"):
        return list(words), flags

    if mode == "sed":
        par = overall_parity(words)
        flags = dict(flags, detected=par != 0)
        return list(words), flags

    if mode == "sec7":
        syn = syndrome(words, layout)
        bad = syn != 0
        bit = decode_flipped_bit(syn, layout)
        bit = xp.where(bad, bit, _u32(0))
        corrected = _xor_bit_into_planes(words, bit, bad, layout)
        flags = dict(flags, corrected=bad, corrected_bit=bit)
        return corrected, flags

    # sec8 / secded
    par = overall_parity(words) != 0
    syn = syndrome(words, layout)
    has_syn = syn != 0

    # parity fail + syndrome   -> correct the located bit
    # parity fail, no syndrome -> the overall-parity bit itself flipped
    fix_data = par & has_syn
    fix_pbit = par & ~has_syn
    bit = decode_flipped_bit(syn, layout)
    pbit_global = _u32(layout.col_word * 32 + OVERALL_PARITY_BIT)
    bit = xp.where(fix_pbit, pbit_global, xp.where(fix_data, bit, _u32(0)))
    corrected = _xor_bit_into_planes(words, bit, par, layout)

    flags = dict(flags, corrected=par, corrected_bit=bit)
    if mode == "secded":
        double = ~par & has_syn
        flags = dict(flags, double=double, detected=double)
    return corrected, flags


# --------------------------------------------------------------------------
# Fault injection (plane-level; host-side NumPy or device jnp both work)
# --------------------------------------------------------------------------

def flip_bits(words, index: int, bits, layout: CodewordLayout):
    """Flip the given global ``bits`` of element ``index`` in-place-style.

    Returns new planes (functional).  ``bits`` is a sequence of global bit
    indices in the layout's codeword numbering — the same numbering the
    reference's injector uses and prints.
    """
    xp = _xp(words[0])
    words = list(words)
    for b in bits:
        w, bit = divmod(int(b), 32)
        plane = words[w]
        if xp is np:
            plane = plane.copy()
            plane[index] ^= np.uint32(1 << bit)
        else:
            plane = plane.at[index].set(plane[index] ^ _u32(1 << bit))
        words[w] = plane
    return words
