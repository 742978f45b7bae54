"""Rotated XOR fold: the one-plane live-detection stream.

The LIVE detection schedule (the pallas target) re-reads its detection
stream every iteration; streaming every codeword word plane (3 for
CSR96, 4 for COO128) purely to feed the parity/checksum trigger arms
would cost more device-memory bytes than the product itself.  The
reference re-reads the full codeword per element access too
(reference CSR/CPUContext.cpp:353-406), but it is compute-bound on a
host CPU; on an accelerator the stream is the cost.

This module compresses the words into ONE uint32 plane at device-upload
time (XLA, loop-invariant — hoisted out of every solver loop) such that
both trigger arms keep their contract-relevant scope:

    fold = w0 ^ (w1 ^ rotl(w1,1) ^ rotl(w1,2))
              ^ (w2 ^ rotl(w2,1) ^ rotl(w2,3))
              [^ (w3 ^ rotl(w3,2) ^ rotl(w3,3))]

Viewed as a linear map GF(2)^{32W} -> GF(2)^32, the column of (word j,
bit b) is a set of rotation distances mod 32: {b} for w0, {b,b+1,b+2}
for w1, {b,b+1,b+3} for w2, {b,b+2,b+3} for w3.  Two properties are
engineered in:

1. every column has ODD weight, so an odd number of flipped bits in an
   element always flips parity(fold) — the parity trigger arm
   (popcount & 1) keeps its EXACT per-element odd-weight scope;
2. all 32*W columns are DISTINCT and nonzero, so any 1- or 2-bit error
   within an element changes the fold (no same-bit-different-word
   cancellation, which a plain w0^w1^w2 fold would suffer for 96 of the
   C(96,2) double-bit patterns) — the checksum arm keeps SEC triggers
   and the reference's double-bit-detect contract at its usual
   block-class granularity.

Because XOR checksums are linear and rotation commutes with XOR, the
fold plane's encode-time checksum baseline is simply the same fold
applied to the stored per-word checksums (`ell_cksum` rows) — no new
persisted state, and the injection-must-not-refresh / scrub-must-refresh
invariants are inherited for free.

Scope deltas vs the per-word streams (PARITY.md "fold" section): only
adversarial >= 4-bit patterns that pair even weights per element AND
cancel in the fold's column space differ — the per-word scheme has
same-shaped blind spots of its own (per-word class cancellation).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FOLD_SHIFTS", "fold_words", "fold_cksum_np"]

# Rotation-distance sets per word index; each set has odd size (parity
# preservation) and the induced columns {b + s mod 32 : s in set} are
# distinct across all (word, bit) pairs (see module docstring).
FOLD_SHIFTS = ((0,), (0, 1, 2), (0, 1, 3), (0, 2, 3))


def _rotl32(w, s: int):
    """uint32 rotate-left by a static 0..31 (numpy or jax.numpy array)."""
    if s == 0:
        return w
    # Shifts stay in [1, 31], so no undefined >>32 at the edges.
    return (w << np.uint32(s)) | (w >> np.uint32(32 - s))


def fold_words(words):
    """XOR-fold a sequence of uint32 planes (same shape each) into one.

    Works on numpy arrays and on jax arrays alike (only ^, <<, >> are
    used); callers pass the word planes in codeword-word order."""
    assert len(words) <= len(FOLD_SHIFTS), len(words)
    out = None
    for j, w in enumerate(words):
        for s in FOLD_SHIFTS[j]:
            t = _rotl32(w, s)
            out = t if out is None else out ^ t
    return out


def fold_cksum_np(ell_cksum: np.ndarray) -> np.ndarray:
    """Encode-time fold checksum baseline from the stored per-word
    checksums: (W, R/8) -> (1, R/8).  Valid because both the fold and
    the checksum are XOR-linear and rotation commutes with XOR."""
    return fold_words(list(ell_cksum))[None, :]
