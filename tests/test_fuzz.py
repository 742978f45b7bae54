"""Randomized cross-target soak: random SPD structures, random modes,
random injections — jnp vs native vs the dense oracle must agree on
products, solutions, and every observable fault event."""

import numpy as np
import pytest

from abft_sparse_cg.backends import available, create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import BITFLIP_KINDS, inject_bitflips
from abft_sparse_cg.ops.spmv import spmv_dense_oracle

MODES = ("none", "constraints", "sed", "sec7", "sec8", "secded")
HAVE_CPU = ("cpu", "none") in available()


def random_spd(rng, n):
    """Random SPD structure: mix of short diagonals, sprinkled off-band
    entries, relabeled bands, and bordered (dense-row) shapes — covers
    every exec layout (DIA, ELL, RCM-ELL, flat, split)."""
    kind = rng.integers(0, 4)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    if kind == 0:       # banded
        for off in rng.choice(np.arange(1, 9), size=3, replace=False):
            idx = np.arange(n - off)
            rows.append(idx + off)
            cols.append(idx)
    elif kind == 1:     # random sparse
        m = 3 * n
        r = rng.integers(0, n, m)
        c = rng.integers(0, n, m)
        keep = r > c
        pairs = np.unique(np.stack([r[keep], c[keep]], 1), axis=0)
        rows.append(pairs[:, 0])
        cols.append(pairs[:, 1])
    elif kind == 2:     # banded after relabel
        relab = rng.permutation(n)
        for off in (1, 2):
            idx = np.arange(n - off)
            r2, c2 = relab[idx + off], relab[idx]
            swap = r2 < c2
            r2[swap], c2[swap] = c2[swap], r2[swap]
            rows.append(r2)
            cols.append(c2)
    else:               # bordered: band + one dense row
        idx = np.arange(n - 1)
        rows.append(idx + 1)
        cols.append(idx)
        r = int(rng.integers(0, n))
        targets = np.setdiff1d(rng.choice(n, size=n // 2, replace=False),
                               [r - 1, r, r + 1])
        rows.append(np.maximum(r, targets))
        cols.append(np.minimum(r, targets))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    off_diag = rows != cols
    vals = np.where(off_diag, -rng.random(len(rows)), 0.0)
    deg = np.bincount(rows[off_diag], minlength=n) + np.bincount(
        cols[off_diag], minlength=n)
    vals[~off_diag] = deg.astype(float)[rows[~off_diag]] + 1.0 + rng.random(n)
    return assemble(cols, rows, vals, n, int(rng.integers(1, 4)))


@pytest.mark.parametrize("trial", range(20))
def test_fuzz_cross_target(trial):
    rng = np.random.default_rng(1000 + trial)
    a = random_spd(rng, int(rng.integers(24, 80)))
    mode = MODES[int(rng.integers(0, len(MODES)))]
    m = build_protected("csr" if rng.integers(2) else "coo", a, mode)
    x = rng.standard_normal(a.N)
    b = rng.random(a.N)

    backend = create("jnp", mode)
    w, errcode, _ = backend.spmv_once(m, x, dtype="f64")
    assert errcode == 0
    np.testing.assert_allclose(w, spmv_dense_oracle(m, x), rtol=1e-11,
                               atol=1e-12)

    res = backend.solve(m, b, 2000, 1e-16, verbose=False, dtype="f64")
    assert not res.failed, (trial, mode, res.messages)
    d = np.zeros((a.N, a.N))
    d[a.rows, a.cols] = a.values
    np.testing.assert_allclose(d @ res.x, b, atol=1e-6)

    # Injected fault: jnp and native agree on every observable — except
    # when the fault goes UNDETECTED by the active mode (e.g. sec8's
    # parity cancels on an even flip count, faithful to the reference):
    # computing with corrupted index words is UB the reference also has,
    # and the layouts consume index words differently (PARITY.md).
    kind = BITFLIP_KINDS[int(rng.integers(0, len(BITFLIP_KINDS)))]
    nflips = int(rng.integers(1, 3))
    m2 = inject_bitflips(m, kind, nflips, np.random.default_rng(trial),
                         echo=lambda s: None)
    r1 = backend.solve(m2, b, 2000, 1e-12, verbose=False, dtype="f64")
    corrupted = any((m2.planes[n] != m.planes[n]).any()
                    for n in m.layout.word_names)
    undetected = (r1.errcode == 0 and r1.corrected_count == 0 and corrupted)
    if HAVE_CPU and not undetected:
        r2 = create("cpu", mode).solve(m2, b, 2000, 1e-12, verbose=False)
        assert r1.errcode == r2.errcode, (trial, mode, kind, nflips)
        assert r1.messages == r2.messages, (trial, mode, kind, nflips)
        assert r1.corrected_count == r2.corrected_count
        # The solutions solve the ORIGINAL system only when the repair
        # was genuine: a >=2-bit fault under a SEC-only mode mis-corrects
        # to a consistent-but-wrong codeword (the reference does the
        # same, which is why run_tests injects a single flip for sec
        # modes).  r1.scrubbed tells us what the solver actually used.
        genuine = not corrupted or (
            r1.corrected_count > 0 and r1.scrubbed is not None
            and all((r1.scrubbed.planes[n] == m.planes[n]).all()
                    for n in m.layout.word_names))
        if r1.errcode == 0 and genuine:
            # Different summation orders converge to different points
            # inside the rr <= 1e-12 ball (x-distance scales with the
            # condition number) — assert both SOLVE the system instead.
            d2 = np.zeros((a.N, a.N))
            d2[a.rows, a.cols] = a.values
            for rx in (r1, r2):
                assert np.linalg.norm(d2 @ rx.x - b) < 1e-4, (trial, mode)
