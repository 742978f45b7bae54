"""Checkpoint/resume composed with the mesh-sharded tiers.

A production multi-chip solve must survive a host crash: the segmented
CheckpointedSolve drives the SAME sharded continue-loop (the GSPMD
program of the jnp target or of the pallas target's live version),
snapshots CGState to host .npz
between segments, and on resume re-establishes the row sharding via the
``state_put`` hook.  Segmenting must not change the arithmetic: the
segmented/resumed solves are asserted bit-exact against the straight
sharded solve, including a mid-solve ABFT correction carried across a
segment boundary (the scrubbed md of one segment seeds the next).

Runs on the conftest's 8-virtual-device CPU mesh.
"""

import numpy as np

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from abft_sparse_cg.formats import assemble, build_protected
from abft_sparse_cg.inject import inject_bitflips
from abft_sparse_cg.ops.spmv import make_spmv
from abft_sparse_cg.parallel.sharded import (
    _device_put_sharded,
    default_mesh,
)
from abft_sparse_cg.solver.cg import make_cg_solver
from abft_sparse_cg.solver.checkpoint import CheckpointedSolve
from abft_sparse_cg.utils.matgen import spd_tridiagonal

RNG = np.random.default_rng(23)
NDEV = 8


def _mesh():
    assert len(jax.devices()) >= NDEV
    return default_mesh(NDEV)


def _protected(n=512, blocks=2, mode="secded", **kw):
    rows, cols, vals, n = spd_tridiagonal(n)
    a = assemble(cols, rows, vals, n, blocks)
    return build_protected("csr", a, mode, **kw)


def _row_put(mesh):
    sh = NamedSharding(mesh, P(mesh.axis_names[0]))
    return lambda v: jax.device_put(v, sh)


def test_gspmd_segmented_and_resumed_match_straight(tmp_path):
    """GSPMD tier: segmented == straight bit-exact; crash + resume (with
    the state_put re-sharding hook) lands on the same solution."""
    mesh = _mesh()
    m = _protected()
    b = RNG.random(m.N)
    md, bdev, _ = _device_put_sharded(m, b, mesh, jnp.float32)
    impl = make_spmv(m, jnp.float32)

    straight = jax.jit(make_cg_solver(impl, 200, 1e-7))(md, bdev)
    assert int(straight.stats.errcode) == 0

    path = str(tmp_path / "ck.npz")
    seg = CheckpointedSolve(impl, 1e-7, every=3, path=path).run(
        md, bdev, max_itrs=200)
    assert int(seg.iterations) == int(straight.iterations)
    np.testing.assert_array_equal(np.asarray(seg.x),
                                  np.asarray(straight.x))

    # Crash after 4 iterations, resume on a fresh runner.
    path2 = str(tmp_path / "ck2.npz")
    r1 = CheckpointedSolve(impl, 1e-7, every=2, path=path2).run(
        md, bdev, max_itrs=4)
    assert int(r1.iterations) == 4
    r2 = CheckpointedSolve(impl, 1e-7, every=50, path=path2,
                           state_put=_row_put(mesh)).run(
        md, bdev, max_itrs=200, resume=True)
    assert int(r2.iterations) == int(straight.iterations)
    np.testing.assert_array_equal(np.asarray(r2.x),
                                  np.asarray(straight.x))


def test_gspmd_fault_correction_across_segments(tmp_path):
    """An injected fault classified in segment 1 stays scrubbed in later
    segments (corrected exactly once) and the solution matches clean."""
    mesh = _mesh()
    m = _protected()
    b = RNG.random(m.N)
    md, bdev, _ = _device_put_sharded(m, b, mesh, jnp.float32)
    impl = make_spmv(m, jnp.float32)
    clean = jax.jit(make_cg_solver(impl, 200, 1e-7))(md, bdev)

    m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(7),
                         echo=lambda s: None)
    md2, _, _ = _device_put_sharded(m2, b, mesh, jnp.float32)
    res = CheckpointedSolve(impl, 1e-7, every=3,
                            path=str(tmp_path / "ck.npz")).run(
        md2, bdev, max_itrs=200)
    assert int(res.stats.errcode) == 0
    assert int(res.stats.corrected_count) == 1
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(clean.x))


@pytest.mark.parametrize("inject", [False, True])
def test_gspmd_live_checkpointed(tmp_path, inject):
    """The pallas target's mesh route (GSPMD over the live version)
    rides the same segmented runner: make_cg_continue over the live
    SpMV, snapshots between segments, resume re-sharded — bit-exact vs
    the straight solve."""
    from abft_sparse_cg.ops.spmv_pallas import make_pallas_spmv

    mesh = _mesh()
    m = _protected(n=1024 * NDEV - 64, blocks=1, mode="secded",
                   row_align=128 * NDEV)
    assert m.exec_kind == "dia"
    b = RNG.random(m.N)
    md, bdev, _ = _device_put_sharded(m, b, mesh, jnp.float32)
    impl = make_pallas_spmv(m, jnp.float32, "secded", platform="gspmd")
    straight = jax.jit(make_cg_solver(impl, 100, 1e-7))(md, bdev)
    assert int(straight.stats.errcode) == 0

    if inject:
        m2 = inject_bitflips(m, "ANY", 1, np.random.default_rng(13),
                             echo=lambda s: None)
        md, _, _ = _device_put_sharded(m2, b, mesh, jnp.float32)

    path = str(tmp_path / "ck.npz")
    r1 = CheckpointedSolve(impl, 1e-7, every=2, path=path).run(
        md, bdev, max_itrs=4)
    assert int(r1.iterations) == 4
    r2 = CheckpointedSolve(impl, 1e-7, every=50, path=path,
                           state_put=_row_put(mesh)).run(
        md, bdev, max_itrs=100, resume=True)
    assert int(r2.stats.errcode) == 0
    # A persistent fault corrects once per runner invocation: the
    # resumed process is handed the original (still-faulty) matrix —
    # as after a real crash — so its first touch re-corrects it, on
    # top of the pre-crash correction carried in the snapshot stats.
    assert int(r2.stats.corrected_count) == (2 if inject else 0)
    assert int(r2.iterations) == int(straight.iterations)
    np.testing.assert_array_equal(np.asarray(r2.x),
                                  np.asarray(straight.x))


@pytest.mark.parametrize("target", ["jnp", "pallas"])
def test_backend_solve_devices_checkpoint_resume(tmp_path, target):
    """The CLI path end-to-end: backend.solve(devices=8, checkpoint=...)
    segments the sharded solve, a truncated run resumes, and the result
    matches the straight sharded solve bit-exactly.  pallas routes
    through the GSPMD live continue."""
    from abft_sparse_cg.backends import create

    if target == "pallas":
        m = _protected(n=1024 * NDEV - 64, blocks=1, mode="secded",
                       row_align=128 * NDEV)
    else:
        m = _protected()
    b = RNG.random(m.N)
    be = create(target, "secded")
    ck = str(tmp_path / "ck.npz")

    r0 = be.solve(m, b, 200, 1e-7, verbose=False, dtype="f32", devices=NDEV)
    r1 = be.solve(m, b, 4, 1e-7, verbose=False, dtype="f32", devices=NDEV,
                  checkpoint=ck, checkpoint_every=2)
    assert r1.iterations == 4
    r2 = be.solve(m, b, 200, 1e-7, verbose=False, dtype="f32",
                  devices=NDEV, checkpoint=ck, resume=True)
    assert r2.errcode == 0
    assert r2.iterations == r0.iterations
    np.testing.assert_array_equal(r2.x, r0.x)
