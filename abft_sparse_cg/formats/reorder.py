"""Bandwidth-reducing reordering (reverse Cuthill-McKee) for exec layouts.

The fast SpMV paths are *stencil-shaped* — they read x at static
diagonal offsets (DIA) or inside a bounded row window (banded ELL).
Both want small matrix bandwidth: a narrow window keeps the reads of x
local.  Many "general" sparse
matrices (meshes and graphs under an arbitrary node numbering) are
banded *up to a symmetric permutation*; RCM recovers that band at build
time, turning the gather problem into a stencil problem.

The permutation lives in EXECUTION space only: the canonical planes, the
ECC codewords they protect, fault injection, and every reference-visible
element index stay in the original order (the slot map absorbs the
shuffle).  CG is invariant under symmetric permutation: solving
``(P A P^T) y = P b`` and returning ``P^T y`` produces the same iterates
(the Krylov space is permuted with the matrix), so residual trajectories
match the unpermuted solve to rounding.

The reference has no analogue — its OpenMP row-gather kernel
(reference CSR/CPUContext.cpp:115-133) gathers straight from the natural
order.  Whether RCM pays for its build cost on a GPU is for the ledger
to decide (ROADMAP design debt 3).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rcm_permutation", "bandwidth", "inverse_permutation"]


def bandwidth(rows: np.ndarray, cols: np.ndarray) -> int:
    """max |row - col| over the entries (0 for empty/diagonal)."""
    if len(rows) == 0:
        return 0
    return int(np.abs(rows.astype(np.int64) - cols.astype(np.int64)).max())


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def rcm_permutation(rows: np.ndarray, cols: np.ndarray, N: int) -> np.ndarray:
    """Reverse Cuthill-McKee order of the symmetric pattern.

    Returns ``perm`` with ``perm[new] = old`` (scipy convention).  The
    input triplets must already contain both (i,j) and (j,i) for every
    off-diagonal entry — the loader's symmetrization guarantees that
    (reference cg.cpp:385-391).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        pat = csr_matrix(
            (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(N, N)
        )
        return np.asarray(reverse_cuthill_mckee(pat, symmetric_mode=True),
                          dtype=np.int64)
    except ImportError:
        return _rcm_numpy(rows, cols, N)


def _rcm_numpy(rows: np.ndarray, cols: np.ndarray, N: int) -> np.ndarray:
    """Pure-NumPy RCM: level-set BFS, neighbors visited degree-ascending,
    result reversed.  Vectorized per BFS level (no per-node Python loop),
    so block-replicated matrices stay fast."""
    order_rc = np.lexsort((cols, rows))
    adj = cols[order_rc]
    deg = np.bincount(rows, minlength=N)
    ptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])

    visited = np.zeros(N, dtype=bool)
    out = np.empty(N, dtype=np.int64)
    pos = 0
    # Component seeds in min-degree order (classic pseudo-peripheral pick).
    seeds = np.argsort(deg, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        visited[seed] = True
        frontier = np.array([seed], dtype=np.int64)
        out[pos] = seed
        pos += 1
        while frontier.size:
            counts = deg[frontier]
            base = np.repeat(ptr[frontier], counts)
            within = np.arange(counts.sum(), dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            nbrs = adj[base + within]
            parent_rank = np.repeat(np.arange(frontier.size), counts)
            # CM order: children of earlier parents first, then by degree.
            sel = np.lexsort((deg[nbrs], parent_rank))
            nbrs = nbrs[sel]
            # Dedup: keep each unvisited node's highest-priority slot.
            uniq, first_idx = np.unique(nbrs, return_index=True)
            idx = np.sort(first_idx[~visited[uniq]])
            nxt = nbrs[idx]
            visited[nxt] = True
            out[pos:pos + nxt.size] = nxt
            pos += nxt.size
            frontier = nxt
    assert pos == N
    return out[::-1].copy()
