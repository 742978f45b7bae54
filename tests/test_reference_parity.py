"""Direct parity against the REAL reference binaries.

Builds the reference's cg-csr/cg-coo from source (read-only mount at
/root/reference), runs them and this framework on the *identical*
problem (same matrix file, bit-identical b via the glibc rand()
emulation), and compares iteration counts, the per-iteration residual
trajectory, and the final error — the strongest form of the
BASELINE.json "residual trajectory matches the reference" target.

Skipped automatically when the reference tree or a C++ toolchain is
unavailable.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.environ.get("ABFT_REFERENCE_DIR", "/root/reference")

pytestmark = pytest.mark.skipif(
    not (os.path.isdir(REF) and shutil.which("g++") and shutil.which("gcc")),
    reason="reference source or toolchain unavailable",
)

from abft_sparse_cg.backends import create  # noqa: E402
from abft_sparse_cg.formats import build_protected, load_matrix  # noqa: E402
from abft_sparse_cg.utils.glibc_rand import glibc_rand, glibc_rand_uniform  # noqa: E402
from abft_sparse_cg.utils.matgen import spd_tridiagonal, write_mm_triangle  # noqa: E402


@pytest.fixture(scope="module")
def ref_exes(tmp_path_factory):
    d = tmp_path_factory.mktemp("refbuild")
    mmio_o = str(d / "mmio.o")
    subprocess.run(
        ["gcc", "-O2", "-c", f"{REF}/mmio.c", "-o", mmio_o, f"-I{REF}"],
        check=True, capture_output=True)
    exes = {}
    for fmt, ctx in (("csr", "CSR"), ("coo", "COO")):
        exe = str(d / f"cg-{fmt}-ref")
        subprocess.run(
            ["g++", "-O2", "-fopenmp", f"-I{REF}", f"{REF}/cg.cpp",
             f"{REF}/CGContext.cpp", f"{REF}/{ctx}/CPUContext.cpp",
             mmio_o, "-o", exe],
            check=True, capture_output=True)
        exes[fmt] = exe
    mtx = str(d / "tri.mtx")
    rows, cols, vals, n = spd_tridiagonal(128)
    write_mm_triangle(mtx, rows, cols, vals, n)
    return exes, mtx


def run_ref(exe, mtx, mode, blocks=4):
    p = subprocess.run(
        [exe, "-f", mtx, "-b", str(blocks), "-t", "cpu", "-m", mode],
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    rr = [float(m) for m in re.findall(r"rr =\s+([\d.]+)", p.stdout)]
    iters = int(re.search(r"ran for (\d+) iterations", p.stdout).group(1))
    total_err = float(re.search(r"total error = ([\d.]+)", p.stdout).group(1))
    return rr, iters, total_err


def test_glibc_rand_matches_compiled_c(tmp_path):
    src = tmp_path / "p.c"
    src.write_text(
        '#include <stdio.h>\n#include <stdlib.h>\n'
        'int main(){for(int i=0;i<64;i++)printf("%d\\n",rand());return 0;}\n')
    exe = str(tmp_path / "p")
    subprocess.run(["gcc", str(src), "-o", exe], check=True)
    out = subprocess.run([exe], capture_output=True, text=True).stdout.split()
    assert glibc_rand(64).tolist() == [int(x) for x in out]


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "sed", "sec7", "sec8", "secded",
                                  "constraints"])
@pytest.mark.parametrize("target", ["jnp", "cpu"])
def test_residual_trajectory_matches_reference(ref_exes, fmt, mode, target):
    exes, mtx = ref_exes
    rr_ref, iters_ref, err_ref = run_ref(exes[fmt], mtx, mode)

    a = load_matrix(mtx, 4)
    m = build_protected(fmt, a, mode)
    b = glibc_rand_uniform(m.N)  # bit-identical to the reference's b
    res = create(target, mode).solve(m, b, 1000, 0.001, verbose=False,
                                     dtype="f64")
    assert not res.failed
    assert res.iterations == iters_ref
    # The reference prints rr to 4 decimals; different (but valid) f64
    # summation orders shift the low digits.
    ours = res.rr_trace[: res.iterations]
    np.testing.assert_allclose(ours, rr_ref, rtol=1e-6, atol=6e-5)

    # Final ||Ax-b|| agrees too (reference prints 6 decimals).
    w, errcode, _ = create(target, mode).spmv_once(m, res.x, dtype="f64")
    assert errcode == 0
    total_err = float(np.sqrt(np.sum((b - w) ** 2)))
    assert abs(total_err - err_ref) < 5e-5 + 1e-6 * err_ref


def _flip_same(m, index, bits):
    """Apply the reference's exact injected flips to our matrix."""
    from abft_sparse_cg.ecc import codec

    words = codec.flip_bits(m.words_list(), index, bits, m.layout)
    return m.with_planes(dict(zip(m.layout.word_names, words)))


def run_ref_inject(exe, mtx, mode, nflips=1, blocks=4):
    p = subprocess.run(
        [exe, "-f", mtx, "-b", str(blocks), "-t", "cpu", "-m", mode,
         "-x", str(nflips)],
        capture_output=True, text=True, timeout=120)
    flips = [(int(b), int(i)) for b, i in
             re.findall(r"\*\*\* flipping bit (\d+) at index (\d+) \*\*\*",
                        p.stdout)]
    return p, flips


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["sec7", "sec8", "secded"])
def test_fault_replay_correction_matches_reference(ref_exes, fmt, mode):
    """Replay the reference's own (time-seeded) injected flip into our
    matrix and demand the identical correction event and outcome."""
    exes, mtx = ref_exes
    p, flips = run_ref_inject(exes[fmt], mtx, mode)
    assert flips, p.stdout
    index = flips[0][1]
    bits = [b for b, _ in flips]

    a = load_matrix(mtx, 4)
    m = _flip_same(build_protected(fmt, a, mode), index, bits)
    b = glibc_rand_uniform(m.N)
    res = create("jnp", mode).solve(m, b, 1000, 0.001, verbose=False,
                                    dtype="f64")

    ref_corr = re.findall(
        r"\[ECC\] corrected (?:bit (\d+)|overall parity bit) at index (\d+)",
        p.stdout)
    if p.returncode == 0:
        # Reference corrected and converged; we must too, with the same
        # located bit at the same element.
        assert not res.failed
        assert res.corrected_count >= 1
        assert ref_corr, p.stdout
        got = res.messages[0]
        want_bit, want_idx = ref_corr[0]
        assert f"at index {want_idx}" in got
        if want_bit:
            assert f"corrected bit {want_bit} " in got
        else:
            assert "overall parity bit" in got
        # Corrected solve == the reference's clean trajectory.
        rr_ref, iters_ref, _ = run_ref(exes[fmt], mtx, mode)
        assert res.iterations == iters_ref
        np.testing.assert_allclose(res.rr_trace[: res.iterations], rr_ref,
                                   rtol=1e-6, atol=6e-5)
    else:
        # Rare alias (e.g. a flip the mode cannot handle): both must fail.
        assert res.failed or res.corrected_count >= 1


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_fault_replay_sed_detection_matches_reference(ref_exes, fmt):
    exes, mtx = ref_exes
    p, flips = run_ref_inject(exes[fmt], mtx, "sed")
    assert flips and p.returncode == 1
    idx_ref = int(re.search(r"error detected at index (\d+)", p.stdout).group(1))

    a = load_matrix(mtx, 4)
    m = _flip_same(build_protected(fmt, a, "sed"), flips[0][1],
                   [b for b, _ in flips])
    res = create("jnp", "sed").solve(m, glibc_rand_uniform(m.N), 1000, 0.001,
                                     verbose=False, dtype="f64")
    assert res.failed and res.errcode == 1
    assert res.err_index == idx_ref


@pytest.fixture(scope="module")
def bordered_mtx(tmp_path_factory):
    """Bordered matrix (tridiagonal + dense rows) — exercises the split
    layout against the reference's general-purpose kernels."""
    from tests.test_split import bordered

    a = bordered(n=512, dense_rows=(17, 300), spread=100, blocks=1)
    keep = a.rows >= a.cols
    mtx = str(tmp_path_factory.mktemp("bord") / "bordered.mtx")
    write_mm_triangle(mtx, a.rows[keep], a.cols[keep], a.values[keep], a.N)
    return mtx


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("mode", ["none", "secded"])
def test_bordered_trajectory_matches_reference(ref_exes, bordered_mtx, fmt,
                                               mode):
    """The split (bordered) execution path reproduces the reference's
    residual trajectory line for line."""
    exes, _ = ref_exes
    rr_ref, iters_ref, err_ref = run_ref(exes[fmt], bordered_mtx, mode)

    a = load_matrix(bordered_mtx, 4)
    m = build_protected(fmt, a, mode)
    assert m.exec_kind == "split"
    b = glibc_rand_uniform(m.N)
    res = create("jnp", mode).solve(m, b, 1000, 0.001, verbose=False,
                                    dtype="f64")
    assert not res.failed
    assert res.iterations == iters_ref
    np.testing.assert_allclose(res.rr_trace[: res.iterations], rr_ref,
                               rtol=1e-6, atol=6e-5)
    w, errcode, _ = create("jnp", mode).spmv_once(m, res.x, dtype="f64")
    assert errcode == 0
    total_err = float(np.sqrt(np.sum((b - w) ** 2)))
    assert abs(total_err - err_ref) < 5e-5 + 1e-6 * err_ref
