"""Mixed-precision iterative refinement (backends.base.solve_refined,
CLI --refine) on an ill-conditioned system (round-4 verdict item 6).

The demonstration matrix is the anisotropic 2-D Laplacian
(utils.matzoo.aniso_laplace_2d), cond ~ side^2/eps: plain f32 CG's
RECURSIVE residual reports convergence while the TRUE residual is
catastrophically wrong (measured: reported 1e-10 vs true 2e+3 at
side=48); the refinement loop re-anchors on the binary64 true residual
each round and recovers f64-level accuracy with f32 inner solves.
"""

import numpy as np
import pytest

from abft_sparse_cg.backends import create
from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.utils.matzoo import aniso_laplace_2d


@pytest.fixture(scope="module")
def illcond():
    r, c, v, n = aniso_laplace_2d(side=32, eps=1e-2)
    a = assemble(np.asarray(c), np.asarray(r), np.asarray(v, float), n, 1)
    m = build_protected("csr", a, "secded")
    b = np.random.default_rng(3).random(m.N)
    return a, m, b


def _true_rr(a, x, b):
    ax = np.zeros(a.N)
    np.add.at(ax, a.rows,
              a.values * np.asarray(x, np.float64)[a.cols])
    r64 = b - ax
    return float(r64 @ r64)


def test_f32_stalls_and_refinement_recovers(illcond):
    a, m, b = illcond
    be = create("jnp", "secded")
    res32 = be.solve(m, b, 2500, 1e-10, verbose=False, dtype="f32")
    t32 = _true_rr(a, res32.x, b)
    resr = be.solve_refined(m, b, 2500, 1e-10, refine=5,
                            verbose=False, dtype="f32")
    tr = _true_rr(a, resr.x, b)
    # The f32 recursive residual lies at this conditioning; the true
    # residual stalls orders of magnitude above the f64 target.
    assert t32 > 1e-4, t32
    # Refinement reports the TRUE residual (no recursive drift) ...
    assert tr == pytest.approx(resr.rr, rel=1e-6)
    # ... and recovers >= 6 orders of magnitude over plain f32.
    assert tr < t32 * 1e-6, (tr, t32)
    assert tr < 1e-7


def test_refine_aborts_on_fail_stop(illcond):
    """An uncorrectable detection inside an inner solve must abort
    refinement with the fail-stop result (ABFT wins)."""
    from abft_sparse_cg.inject import inject_bitflips

    a, m, b = illcond
    m2 = inject_bitflips(m, "ANY", 2, np.random.default_rng(5),
                         echo=lambda s: None)
    be = create("jnp", "secded")
    res = be.solve_refined(m2, b, 50, 1e-10, refine=3,
                           verbose=False, dtype="f32")
    assert res.failed


def test_refine_corrects_single_fault(illcond):
    """A correctable fault is corrected inside the inner solve and
    refinement proceeds to the f64-level answer."""
    from abft_sparse_cg.inject import inject_bitflips

    a, m, b = illcond
    m1 = inject_bitflips(m, "ANY", 1, np.random.default_rng(7),
                         echo=lambda s: None)
    be = create("jnp", "secded")
    res = be.solve_refined(m1, b, 2500, 1e-10, refine=5,
                           verbose=False, dtype="f32")
    assert not res.failed
    assert res.corrected_count >= 1
    assert _true_rr(a, res.x, b) < 1e-7


def test_refine_cli_flag():
    from abft_sparse_cg import cli

    params = cli.parse_arguments(["--refine", "3"], "csr")
    assert params["refine"] == 3


def test_refine_rejects_checkpoint(tmp_path, capsys):
    """--refine + --checkpoint is a wrong-result path (all inner rounds
    would share one snapshot path; --resume would replay round 1's
    state against a different rhs) — the CLI rejects the combination
    up front (ADVICE r4)."""
    import pytest

    from abft_sparse_cg import cli
    from abft_sparse_cg.utils.matgen import (
        spd_tridiagonal,
        write_mm_triangle,
    )

    mtx = tmp_path / "t.mtx"
    rows, cols, vals, n = spd_tridiagonal(64)
    write_mm_triangle(str(mtx), rows, cols, vals, n)
    with pytest.raises(SystemExit) as ex:
        cli.main(["-f", str(mtx), "--refine", "2",
                  "--checkpoint", str(tmp_path / "c.npz")], fmt="csr")
    assert ex.value.code == 1
    assert "--refine cannot be combined" in capsys.readouterr().out
