"""Adversarial matrix zoo: routing assertions (utils.matzoo).

Eleven structurally distinct SPD families NOT drawn from the bench
generators; each entry pins the verified layout and route decision
(`row_align=1024`, a multiple of every mesh alignment the CLI uses).  A
regression that silently drops a family from its kernel route fails
here.
"""

import numpy as np
import pytest

from abft_sparse_cg.formats import build_protected
from abft_sparse_cg.ops.spmv_pallas import route_for
from abft_sparse_cg.utils.matzoo import ZOO, zoo_assembled

# Families small enough for the CPU test budget (blockdiag-random takes
# the same code path with bigger constants; k729 has its own test).
FAST = [n for n in ZOO if n not in ("blockdiag-random",
                                    "dense-radius-k729")]  # own test


@pytest.mark.parametrize("name", FAST)
def test_zoo_routing(name):
    _builder, pred = ZOO[name]
    m = build_protected("csr", zoo_assembled(name), "secded",
                        row_align=1024)
    assert m.exec_kind == pred["kind"], (name, m.exec_kind)
    assert (m.perm is not None) == pred["perm"], name
    part = m.main if m.exec_kind == "split" else m
    kern = route_for(part, "gpu") != "xla-live"
    assert kern == pred["kernel"], (name, kern)


def test_zoo_arrowhead_gets_dense_tail_plan():
    """The fat-but-dense tail (66% of nnz in 3 dense rows) must ride
    the span-window plan — the round-4 _MAX_TAIL_FRAC_DENSE regime."""
    m = build_protected("csr", zoo_assembled("arrowhead"), "secded",
                        row_align=1024)
    assert m.exec_kind == "split"
    assert m.main.exec_kind == "dia"
    assert m.tail.dense_plan is not None


def test_zoo_k729_routes_to_ell_kernel():
    """K=729 slots per row at a narrow band: ELL (the K*R footprint is
    within the padding bound), on the ELL kernel route."""
    m = build_protected("csr", zoo_assembled("dense-radius-k729"),
                        "secded", row_align=1024)
    assert m.exec_kind == "ell" and m.K == 729
    assert route_for(m, "gpu") == "triton-ell"


def test_zoo_highk_k175_on_kernel():
    """dense-radius-3d: K=175 must stay on the ELL kernel route."""
    m = build_protected("csr", zoo_assembled("dense-radius-3d"),
                        "secded", row_align=1024)
    assert m.exec_kind == "ell" and m.K == 175
    assert route_for(m, "gpu") == "triton-ell"


def test_zoo_solves_correctly():
    """End-to-end correctness on the nastiest three: jnp f64 solve
    converges and matches a dense-ish oracle residual."""
    from abft_sparse_cg.backends import create

    for name in ("arrowhead", "bitreversal-banded", "powerlaw-graph"):
        a = zoo_assembled(name)
        m = build_protected("csr", a, "secded", row_align=1024)
        b = np.random.default_rng(3).random(m.N)
        res = create("jnp", "secded").solve(m, b, 400, 1e-8,
                                            verbose=False, dtype="f64")
        assert not res.failed, name
        x = np.asarray(res.x)
        # True residual via triplet SpMV.
        ax = np.zeros(m.N)
        np.add.at(ax, a.rows, a.values * x[a.cols])
        rr = np.linalg.norm(b - ax) / np.linalg.norm(b)
        assert rr < 1e-6, (name, rr)
