"""Loader pipeline, MM I/O, protected containers, injector."""

import os
import tempfile

import numpy as np
import pytest

from abft_sparse_cg.ecc import ECC_COL_MASK, check_and_correct
from abft_sparse_cg.formats import (
    assemble,
    build_protected,
    load_matrix,
    read_coordinate,
    read_header,
    write_coordinate,
)
from abft_sparse_cg.ecc.values import planes_to_f64_np
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.utils.matgen import spd_tridiagonal, write_mm_triangle


@pytest.fixture(scope="module")
def tri_mtx():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tri.mtx")
        rows, cols, vals, n = spd_tridiagonal(64)
        write_mm_triangle(path, rows, cols, vals, n)
        yield path, n


def test_mmio_roundtrip(tmp_path):
    path = str(tmp_path / "m.mtx")
    i = np.array([0, 1, 5])
    j = np.array([0, 1, 2])
    v = np.array([1.5, -2.25, 3.0])
    write_coordinate(path, i, j, v, (6, 6), symmetry="general")
    hdr, i2, j2, v2 = read_coordinate(path)
    assert hdr.symmetry == "general" and hdr.nnz == 3 and hdr.rows == 6
    assert (i2 == i).all() and (j2 == j).all() and (v2 == v).all()


def test_mmio_pattern(tmp_path):
    path = str(tmp_path / "p.mtx")
    write_coordinate(path, [0, 2], [1, 2], None, (3, 3))
    hdr, i, j, v = read_coordinate(path)
    assert hdr.field == "pattern"
    assert (v == 1.0).all()


def test_mmio_rejects_garbage(tmp_path):
    path = str(tmp_path / "g.mtx")
    path2 = str(tmp_path / "g2.mtx")
    with open(path, "w") as f:
        f.write("not a matrix\n1 1 1\n")
    with pytest.raises(ValueError, match="banner"):
        read_header(path)
    with open(path2, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n% c\n2 2 3\n"
                "1 1 1.0\n2 2 1.0\n")  # header lies: says 3, has 2
    with pytest.raises(ValueError, match="mismatch"):
        read_coordinate(path2)


# ---- native parser (native/mmio_fast.cpp) vs loadtxt fallback parity ----

_MM_BODIES = {
    "real": "%%MatrixMarket matrix coordinate real general\n3 3 4\n"
            "1 1 1.5\n2 2 -2.25e-3\n3 1 +4E2\n3 3 .5\n",
    "integer": "%%MatrixMarket matrix coordinate integer symmetric\n3 3 3\n"
               "1 1 7\n2 1 -3\n3 3 12\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n3 3 3\n"
               "1 1\n2 2\n3 1\n",
    "blank_lines": "%%MatrixMarket matrix coordinate real general\n2 2 2\n"
                   "\n1 1 1.0\n\n  \n2 2 2.0\n\n",
    "crlf": "%%MatrixMarket matrix coordinate real general\r\n2 2 2\r\n"
            "1 1 1.0\r\n2 2 2.0\r\n",
    "no_trailing_nl": "%%MatrixMarket matrix coordinate real general\n"
                      "2 2 2\n1 1 1.0\n2 2 2.0",
    "tabs_and_spaces": "%%MatrixMarket matrix coordinate real general\n"
                       "2 2 2\n 1\t1\t1.0 \n\t2 2  2.0\t\n",
}


@pytest.mark.parametrize("case", sorted(_MM_BODIES))
def test_mmio_native_matches_fallback(tmp_path, monkeypatch, case):
    path = str(tmp_path / f"{case}.mtx")
    with open(path, "w", newline="") as f:
        f.write(_MM_BODIES[case])
    from abft_sparse_cg.formats import mmio

    if mmio._load_fast_lib() is None:
        pytest.skip("native mmio library unavailable")
    hdr_n, i_n, j_n, v_n = read_coordinate(path)
    monkeypatch.setenv("ABFT_NO_NATIVE_MMIO", "1")
    hdr_f, i_f, j_f, v_f = read_coordinate(path)
    assert hdr_n == hdr_f
    assert (i_n == i_f).all() and (j_n == j_f).all()
    np.testing.assert_array_equal(v_n, v_f)
    assert i_n.dtype == np.int64 and v_n.dtype == np.float64


def test_mmio_native_count_mismatch_same_error(tmp_path):
    # Native declines on count mismatch; the loadtxt path owns the
    # canonical ValueError either way.
    path = str(tmp_path / "short.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n2 2 3\n"
                "1 1 1.0\n2 2 2.0\n")
    with pytest.raises(ValueError, match="mismatch"):
        read_coordinate(path)
    path2 = str(tmp_path / "long.mtx")
    with open(path2, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n1 1 1\n"
                "1 1 1.0\n1 1 2.0\n1 1 3.0\n")
    with pytest.raises(ValueError, match="mismatch"):
        read_coordinate(path2)


def test_mmio_native_syntax_error_falls_back(tmp_path):
    # Junk the native parser declines must still raise (via loadtxt),
    # never return garbage silently.
    path = str(tmp_path / "bad.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n2 2 2\n"
                "1 1 1.0\n2 two 2.0\n")
    with pytest.raises(ValueError):
        read_coordinate(path)


def test_assemble_symmetrize_sort_replicate():
    # One triangle of [[4,-1],[-1,4]] : entries (0,0,4),(1,1,4),(1,0,-1)
    cols = np.array([0, 1, 0])
    rows = np.array([0, 1, 1])
    vals = np.array([4.0, 4.0, -1.0])
    a = assemble(cols, rows, vals, width=2, num_blocks=3)
    assert a.N == 6 and a.nnz == 4 * 3
    # Block 0 sorted by (row, col): (0,0,4),(0,1,-1),(1,0,-1),(1,1,4)
    assert a.rows[:4].tolist() == [0, 0, 1, 1]
    assert a.cols[:4].tolist() == [0, 1, 0, 1]
    assert a.values[:4].tolist() == [4.0, -1.0, -1.0, 4.0]
    # Block replication shifts indices by j*width.
    assert (a.rows[4:8] == a.rows[:4] + 2).all()
    assert (a.cols[8:12] == a.cols[:4] + 4).all()
    assert (a.values[4:8] == a.values[:4]).all()


def test_load_matrix_end_to_end(tri_mtx):
    path, n = tri_mtx
    a = load_matrix(path, num_blocks=4)
    assert a.N == 4 * n
    assert a.nnz == 4 * (3 * n - 2)
    # Dense reconstruction of block 0 is the tridiagonal matrix.
    dense = np.zeros((n, n))
    sel = a.rows < n
    dense[a.rows[sel], a.cols[sel]] = a.values[sel]
    assert (np.diag(dense) == 4.0).all()
    assert (np.diag(dense, 1) == -1.0).all()
    assert (np.diag(dense, -1) == -1.0).all()
    assert (dense == dense.T).all()


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec8", "secded"])
def test_build_protected_planes_and_ell(tri_mtx, fmt, mode):
    path, n = tri_mtx
    a = load_matrix(path, num_blocks=2)
    m = build_protected(fmt, a, mode)
    assert m.nnz == a.nnz and m.N == a.N
    # Values survive the plane split (ECC never touches value words).
    vals = planes_to_f64_np(m.planes["value_lo"], m.planes["value_hi"])
    assert (vals == a.values).all()
    # Column low 24 bits survive encoding.
    assert (m.planes["col"] & ECC_COL_MASK == a.cols).all()
    if mode != "none":
        _, flags = check_and_correct(mode, m.words_list(), m.layout)
        assert not flags["detected"].any() and not flags["corrected"].any()
    # ELL layout: scattering the flat planes back through ell_slot agrees.
    for name in m.layout.word_names:
        assert (m.ell[name].reshape(-1)[m.ell_slot] == m.planes[name]).all()
    # ELL row lengths sum to nnz; padded rows are zero codewords.
    assert int(m.ell_len.sum()) == m.nnz
    assert m.R % 8 == 0
    # Padding slots are all-zero (a valid codeword under every mode).
    occupied = np.zeros(m.R * m.K, dtype=bool)
    occupied[m.ell_slot] = True
    for name in m.layout.word_names:
        assert (m.ell[name].reshape(-1)[~occupied] == 0).all()


def test_ecc_mode_rejects_oversized_n():
    cols = np.array([0])
    rows = np.array([0])
    vals = np.array([1.0])
    a = assemble(cols, rows, vals, width=1 << 23, num_blocks=3)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        build_protected("csr", a, "secded")


@pytest.mark.parametrize("fmt,kind,lo,hi", [
    ("coo", "ANY", 0, 128), ("coo", "VALUE", 64, 128), ("coo", "INDEX", 0, 64),
    ("csr", "ANY", 0, 96), ("csr", "VALUE", 0, 64), ("csr", "INDEX", 64, 96),
])
def test_inject_regions_and_detectability(tri_mtx, fmt, kind, lo, hi):
    path, n = tri_mtx
    a = load_matrix(path, num_blocks=1)
    m = build_protected(fmt, a, "secded")
    msgs = []
    rng = np.random.default_rng(7)
    m2 = inject_bitflips(m, kind, 1, rng, echo=msgs.append)
    assert len(msgs) == 1 and msgs[0].startswith("*** flipping bit ")
    bit = int(msgs[0].split()[3])
    assert lo <= bit < hi
    # Exactly one element's parity now fails, and correction restores it.
    fixed, flags = check_and_correct("secded", m2.words_list(), m2.layout)
    assert int(flags["corrected"].sum()) == 1
    idx = int(np.flatnonzero(flags["corrected"])[0])
    assert int(flags["corrected_bit"][idx]) == bit
    for w, name in enumerate(m.layout.word_names):
        assert (fixed[w] == m.planes[name]).all()
    # The injected fault propagated into the ELL planes too.
    assert any(
        (m2.ell[nm] != m.ell[nm]).any() for nm in m.layout.word_names
    )


def test_inject_double_cancel_quirk(tri_mtx):
    """Two flips may hit the same bit and cancel — reference quirk kept."""
    path, n = tri_mtx
    a = load_matrix(path, num_blocks=1)
    m = build_protected("csr", a, "secded")
    hits = {True: 0, False: 0}
    for seed in range(40):
        m2 = inject_bitflips(m, "ANY", 2, np.random.default_rng(seed), echo=lambda s: None)
        changed = any((m2.planes[nm] != m.planes[nm]).any() for nm in m.layout.word_names)
        hits[changed] += 1
    assert hits[True] > 0  # most double-flips actually corrupt
