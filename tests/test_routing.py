"""Layout and route decision table.

`build_protected` auto-selects the execution layout and the pallas
target routes each layout (ops.spmv_pallas.route_for): ELL takes the
Triton kernel on a GPU, DIA and flat take the plain live version, split
composites combine their parts' routes.  This table pins the decision
for every matrix archetype a user is likely to feed in:
  - 1-D chain / 2-D Poisson / 3-D 7-point Poisson / 2-D periodic
    Poisson -> DIA (few distinct offsets; no offset-magnitude cap)
  - label-shuffled chain -> RCM recovers the tridiagonal -> DIA + perm
  - uniformly wide band (1920 < b <= 16256) -> ELL
  - bordered (a few dense rows) -> split (banded main + span-window
    tail)
  - banded + random sparse matching -> RCM compresses the matching
    into the band -> permuted ELL (the cost model keeps it whole)
  - uniform random at n <= 24576 -> RCM recovers a band under 16256 ->
    permuted ELL
  - band > 16256 with no RCM recovery -> band-split with a wide main
    (the cost model cuts near the 16256 cap)
"""

import numpy as np

import jax.numpy as jnp
import pytest

from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.ops.spmv_pallas import route_for, route_name
from abft_sparse_cg.utils.matgen import (
    shuffle_labels,
    spd_denseband,
    spd_laplacian_2d,
    spd_tridiagonal,
    spd_wideband,
)


def _sym_assemble(rows, cols, vals, n, blocks=1):
    return assemble(np.asarray(cols), np.asarray(rows),
                    np.asarray(vals, float), n, blocks)


def stencil_3d(n=12):
    """7-point 3-D Poisson on an n^3 grid (lower triangle)."""
    rows, cols, vals = [], [], []

    def idx(i, j, k):
        return (i * n + j) * n + k

    for i in range(n):
        for j in range(n):
            for k in range(n):
                r = idx(i, j, k)
                rows.append(r), cols.append(r), vals.append(6.0)
                for di, dj, dk in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    if i + di < n and j + dj < n and k + dk < n:
                        rows.append(idx(i + di, j + dj, k + dk))
                        cols.append(r)
                        vals.append(-1.0)
    return _sym_assemble(rows, cols, vals, n ** 3)


def periodic_2d(n=48):
    """5-point 2-D Poisson with periodic wrap in both directions."""
    rows, cols, vals = [], [], []
    N = n * n

    def idx(i, j):
        return i * n + j

    seen = {}
    for i in range(n):
        for j in range(n):
            r = idx(i, j)
            seen[(r, r)] = 5.0
            for rr, cc in (((i + 1) % n, j), (i, (j + 1) % n)):
                c = idx(rr, cc)
                if c != r:
                    seen[(max(r, c), min(r, c))] = -1.0
    rows = [k[0] for k in seen]
    cols = [k[1] for k in seen]
    vals = [seen[k] for k in seen]
    return _sym_assemble(rows, cols, vals, N)


def bordered(n=2048, dense_rows=(100, 777), per_row=120):
    rows, cols, vals, n = spd_tridiagonal(n)
    rows, cols, vals = list(rows), list(cols), list(vals)
    rng = np.random.default_rng(3)
    for r in dense_rows:
        for c in rng.choice(n, size=per_row, replace=False):
            hi, lo = max(r, int(c)), min(r, int(c))
            if hi != lo:
                rows.append(hi), cols.append(lo), vals.append(-0.01)
    rows, cols = np.array(rows), np.array(cols)
    vals = np.array(vals, float)
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    diag = rows == cols
    vals[diag] = deg.astype(float)[rows[diag]] + 4.0
    return _sym_assemble(rows, cols, vals, n)


def band_plus_matching(n=16384, every=8):
    rows = list(range(n)) + list(range(1, n))
    cols = list(range(n)) + list(range(n - 1))
    vals = [8.0] * n + [-1.0] * (n - 1)
    rng = np.random.default_rng(5)
    for i in range(0, n, every):
        j = int(rng.integers(0, n))
        if abs(j - i) > 3:
            rows.append(max(i, j)), cols.append(min(i, j))
            vals.append(-0.5)
    return _sym_assemble(rows, cols, vals, n)


def uniform_random(n=4096, k=6, diag=None):
    """Random couplings; RCM still recovers a < n band, and at
    n <= 16256 the wideband window covers whatever is left."""
    rng = np.random.default_rng(9)
    rows, cols = list(range(n)), list(range(n))
    vals = [float(diag if diag is not None else k + 4)] * n
    for r in range(n):
        for c in rng.integers(0, n, size=k // 2):
            hi, lo = max(r, int(c)), min(r, int(c))
            if hi != lo:
                rows.append(hi), cols.append(lo), vals.append(-0.01)
    return _sym_assemble(rows, cols, vals, n)


def wide_past_cap(n=65536, band=20000):
    """Uniform couplings within +-20000 on 65536 rows: band > 16256 in
    any ordering, no thin cut -> the FAT-tail band split."""
    rows, cols, vals, n = spd_wideband(n, band, k=2)
    r2 = list(rows) + list(range(1, n))
    c2 = list(cols) + list(range(n - 1))
    v2 = list(vals) + [-0.5] * (n - 1)
    return _sym_assemble(r2, c2, v2, n)


CASES = [
    # name, builder, kw, expected exec_kind, permuted
    ("chain", lambda: _sym_assemble(*spd_tridiagonal(512), blocks=2),
     {}, "dia", False),
    ("poisson2d", lambda: _sym_assemble(*spd_laplacian_2d(40)),
     {}, "dia", False),
    ("poisson3d", stencil_3d, {}, "dia", False),
    ("periodic2d", periodic_2d, {}, "dia", False),
    ("shuffled-chain",
     lambda: _sym_assemble(*shuffle_labels(*spd_tridiagonal(1024), seed=3)),
     {}, "dia", True),
    ("wideband", lambda: _sym_assemble(*spd_wideband(8192, 2500)),
     {"reorder": "none"}, "ell", False),
    ("bordered", bordered, {}, "split", False),
    ("band+matching", band_plus_matching, {}, "ell", True),
    ("uniform-random", uniform_random, {}, "ell", True),
    # RCM compresses even this to band < 16256: the whole matrix must
    # stay whole — NOT get a fat-tail split (the fallback-regime cut
    # search must never fire when some ordering keeps the band under
    # the cap).
    ("uniform-random-24k", lambda: uniform_random(24576), {},
     "ell", True),
    ("wide-past-cap", wide_past_cap, {"reorder": "none"},
     "split", False),
    # High-degree families: a dense band of half-width h has exactly one
    # entry per offset, so h <= 63 (D = 2h+1 <= 128 distinct offsets)
    # rides DIA; beyond that it is the high-K ELL case — the reference's
    # row gather handles any degree uniformly
    # (CSR/CPUContext.cpp:115-133), so none of these may fall off the
    # banded layouts.
    ("denseband-d65",
     lambda: _sym_assemble(*spd_denseband(512, 32)),
     {"reorder": "none"}, "dia", False),
    ("denseband-k129",
     lambda: _sym_assemble(*spd_denseband(512, 64)),
     {"reorder": "none"}, "ell", False),
    ("denseband-k255",
     lambda: _sym_assemble(*spd_denseband(512, 127)),
     {"reorder": "none"}, "ell", False),
]


def gpu_route(m):
    """The pallas target's route on a GPU: the Triton kernel for ELL
    planes, the plain live version for every other layout."""
    return "triton-ell" if m.exec_kind == "ell" else "xla-live"


@pytest.mark.parametrize("name,builder,kw,kind,permuted",
                         CASES, ids=[c[0] for c in CASES])
def test_layout_and_tier_routing(name, builder, kw, kind, permuted):
    m = build_protected("csr", builder(), "secded", **kw)
    assert m.exec_kind == kind, (name, m.exec_kind)
    assert (m.perm is not None) == permuted, name

    if kind == "split":
        # The banded main part carries the main route; the tail is
        # flat (the border's outlier entries or the out-of-band rest).
        assert m.main.exec_kind in ("dia", "ell"), name
        assert route_for(m.main, "gpu") == gpu_route(m.main), name
        assert m.tail.exec_kind == "flat", name
    else:
        assert route_for(m, "gpu") == gpu_route(m), (name, m.band, m.K)


@pytest.mark.parametrize("name,builder,kw,kind,permuted",
                         CASES, ids=[c[0] for c in CASES])
def test_gpu_route_table(name, builder, kw, kind, permuted):
    """The route each archetype takes on a GPU (and on the CPU, where
    every layout takes the plain live version), with the row alignment
    the CLI passes for a four-device mesh: alignment changes no
    layout and no route."""
    m = build_protected("csr", builder(), "secded", row_align=128 * 4,
                        **kw)
    assert m.exec_kind == kind, (name, m.exec_kind)
    if kind == "split":
        expect = f"split({gpu_route(m.main)}+xla-live)"
    else:
        expect = gpu_route(m)
    assert route_name(m, "gpu") == expect, name
    assert "triton" not in route_name(m, "cpu"), name
    assert route_name(m, "gspmd") == "xla-live (gspmd)"


def _assert_composite_spmv_exact(m, a):
    from abft_sparse_cg.ops.spmv import make_matrix_device, make_spmv

    impl = make_spmv(m, jnp.float64)
    md = make_matrix_device(m, jnp.float64)
    rng = np.random.default_rng(2)
    x = rng.random(m.N)
    xpad = np.zeros(m.R)
    xpad[: m.N] = m.to_exec_order(x)
    w, stats = impl.full(md, jnp.asarray(xpad, jnp.float64))
    assert int(stats.errcode) == 0
    want = np.zeros(m.N)
    np.add.at(want, a.rows, a.values * x[a.cols])
    got = np.asarray(m.from_exec_order(np.asarray(w)[: m.N]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_band_split_past_cap_picks_scan_tier_main():
    """Band > 16256 with no narrow ordering: the cost model cuts WIDE —
    a wide main soaking up most entries beats gathering them in the
    tail — and the composite SpMV stays exact: composite vs direct
    COO."""
    a = wide_past_cap()
    m = build_protected("csr", a, "secded", reorder="none")
    assert m.exec_kind == "split"
    assert m.main.band > 1920          # a wide main, not a thin cut
    assert m.tail.nnz > 0
    _assert_composite_spmv_exact(m, a)


def test_forced_fat_tail_band_split_is_correct(monkeypatch):
    """ABFT_BAND_CUT forces the cut (tuning/calibration knob); a thin
    forced cut leaves a genuinely FAT tail (~50% of entries) which must
    still compute the exact SpMV."""
    monkeypatch.setenv("ABFT_BAND_CUT", "256")
    a = wide_past_cap()
    m = build_protected("csr", a, "secded", reorder="none")
    assert m.exec_kind == "split"
    assert m.main.band <= 256
    assert m.tail.nnz / m.nnz > 0.10   # genuinely past the thin cap
    _assert_composite_spmv_exact(m, a)
