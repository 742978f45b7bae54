"""Mesh-sharded CG: 1-D row sharding over a jax.sharding.Mesh.

The reference is strictly single-node (no MPI/NCCL anywhere — SURVEY §2);
this is the scaling axis it lacks.  Design (GSPMD):

  - exec planes ``(K, R)``/``(D, R)`` and all vectors ``(R,)`` are
    sharded along rows of a 1-D ``("shard",)`` mesh (``R`` padded to a
    multiple of 8 * n_devices so every shard holds whole 8-row checksum
    blocks; rows are the minor axis of every plane);
  - the solve is the *same* single-device program (``ops.spmv`` +
    ``solver.cg``) jitted with sharding annotations: XLA's SPMD
    partitioner inserts the one all-gather CG needs (the SpMV reads
    off-shard entries of p) and psums for the dot/argmax/sum reductions
    — exactly the two collectives SURVEY §5 calls for, which XLA hands
    to NCCL on GPUs;
  - per-shard ABFT verification is purely local; error/correction
    reductions fold in with the same automatic collectives;
  - FLAT (bordered-matrix) layouts shard their per-*entry* planes along
    the same mesh axis instead (``_put_flat``): each shard computes
    partial row contributions and the segment-sum's scatter-add reduces
    them into the row-sharded w; SPLIT composites shard the banded main
    part by rows and the flat tail by entries.

Faults, detection, correction and the stdout contract are identical to
the single-device path because it *is* the same program.
"""

from __future__ import annotations

import numpy as np

from ..formats.protected import ProtectedMatrix
from ..ops.spmv import make_spmv
from ..solver.cg import make_cg_solver

__all__ = ["default_mesh", "pad_rows", "make_sharded_solver", "solve_sharded"]


def default_mesh(n_devices=None, axis="shard"):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_rows(arr: np.ndarray, R_pad: int, axis: int = 0):
    pad = R_pad - arr.shape[axis]
    if pad == 0:
        return arr
    width = [(0, 0)] * arr.ndim
    width[axis] = (0, pad)
    return np.pad(arr, width)


def _put_flat(mat: ProtectedMatrix, mesh, dtype, R_pad: int):
    """Entry-sharded upload of a FLAT-layout part.

    Flat planes are per-*entry* (1-D, length nnz padded to a checksum
    block), not per-row, so the mesh axis shards the entry dimension:
    each device computes partial contributions from its entry shard and
    the segment-sum's scatter-add folds them into the row-sharded w
    (GSPMD inserts the reduce).  Entries pad to a multiple of
    8 * n_devices with zero codewords (zero blocks checksum to zero and
    fail no parity), so 8-entry checksum blocks never straddle a shard
    and detection stays collective-free.  Exec slots are entry positions
    — appending padding never shifts them, so ABFT slot routing is
    unchanged.
    """
    import jax
    import jax.numpy as jnp  # noqa: F401  (kept for parity with row path)
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = mesh.devices.size
    axis = mesh.axis_names[0]
    ent1d = NamedSharding(mesh, P(axis))
    row1d = NamedSharding(mesh, P(axis))

    names = mat.layout.word_names
    E0 = mat.ell[names[0]].shape[0]
    E_pad = -(-E0 // (8 * ndev)) * (8 * ndev)

    words = tuple(
        jax.device_put(pad_rows(mat.ell[n], E_pad), ent1d) for n in names
    )
    # Padding joins the last (padded) row like the build-time padding —
    # contributions are masked to zero by the nnz bound, and R - 1 keeps
    # the segment ids sorted.
    grp = pad_rows(mat.ell["__flat_group__"], E_pad)
    grp[E0:] = mat.R - 1
    flat_group = jax.device_put(grp, ent1d)
    cksum = jax.device_put(
        pad_rows(mat.ell_cksum, E_pad // 8, axis=1),
        NamedSharding(mesh, P(None, axis)),
    )
    ell_len = jax.device_put(pad_rows(mat.ell_len, R_pad), row1d)

    from ..ecc.values import planes_to_value
    from ..ops.spmv import MatrixDevice

    values = planes_to_value(
        words[names.index("value_lo")], words[names.index("value_hi")], dtype
    )
    gidx = perm_pos = None
    if mat.perm is not None:
        from ..formats.reorder import inverse_permutation
        from ..ops.spmv import exec_gather_host

        gidx = jax.device_put(pad_rows(exec_gather_host(mat), E_pad), ent1d)
        pp = np.zeros(R_pad, dtype=np.int32)
        pp[: mat.N] = inverse_permutation(mat.perm)
        perm_pos = jax.device_put(pp, row1d)
    return MatrixDevice(words=words, ell_len=ell_len, cksum=cksum,
                        values=values, flat_group=flat_group, gidx=gidx,
                        perm_pos=perm_pos)


def _device_put_sharded(mat: ProtectedMatrix, b: np.ndarray, mesh, dtype):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = mesh.devices.size
    if mat.exec_kind == "split":
        # Composite (bordered): banded main part row-sharded as usual,
        # flat tail part entry-sharded; w = w_main + w_tail lands on the
        # same row sharding.  The composite's slot offset (main.exec_size,
        # ops.spmv.combine_impls) is baked against the single-device exec
        # grid, so the mesh must not re-pad the main part's rows.
        if mat.R % (8 * ndev):
            raise ValueError(
                f"bordered-split sharding needs R ({mat.R}) divisible by "
                f"8 * n_devices ({8 * ndev}) so exec slots keep their "
                "single-device grid; use fewer devices"
            )
        md_main, bdev, put_vec = _device_put_sharded(mat.main, b, mesh,
                                                     dtype)
        md_tail = _put_flat(mat.tail, mesh, dtype, R_pad=mat.R)
        return (md_main, md_tail), bdev, put_vec

    if mat.exec_kind == "flat":
        R_pad = -(-mat.R // (8 * ndev)) * (8 * ndev)
        md = _put_flat(mat, mesh, dtype, R_pad)

        def put_vec_flat(v):
            vpad = np.zeros(R_pad, dtype=np.float64)
            vpad[: mat.N] = mat.to_exec_order(v)
            return jax.device_put(jnp.asarray(vpad, dtype=dtype),
                                  NamedSharding(mesh, P(mesh.axis_names[0])))

        return md, put_vec_flat(b), put_vec_flat
    axis = mesh.axis_names[0]
    R_pad = -(-mat.R // (8 * ndev)) * (8 * ndev)

    # Execution planes are (K, rows) / (D, rows): rows live on the lane
    # dimension for both layouts -> shard dim 1.
    ra = mat.exec_row_axis
    row2d = NamedSharding(mesh, P(None, axis))
    row1d = NamedSharding(mesh, P(axis))

    from ..ops.spmv import MatrixDevice

    padded = {n: pad_rows(mat.ell[n], R_pad, ra) for n in mat.layout.word_names}
    words = tuple(
        jax.device_put(padded[n], row2d) for n in mat.layout.word_names
    )
    ell_len = jax.device_put(pad_rows(mat.ell_len, R_pad), row1d)
    # Build-time checksums, zero-padded to the mesh-padded row count
    # (zero blocks checksum to zero) and sharded like the rows.
    cksum = jax.device_put(
        pad_rows(mat.ell_cksum, R_pad // 8, axis=1),
        NamedSharding(mesh, P(None, axis)),
    )
    from ..ecc.values import planes_to_value

    names = mat.layout.word_names
    values = planes_to_value(
        words[names.index("value_lo")], words[names.index("value_hi")], dtype
    )
    gidx = perm_pos = None
    if mat.perm is not None and mat.exec_kind == "ell":
        from ..formats.reorder import inverse_permutation
        from ..ops.spmv import exec_gather_host

        gidx = jax.device_put(pad_rows(exec_gather_host(mat), R_pad, 1),
                              row2d)
        pp = np.zeros(R_pad, dtype=np.int32)
        pp[: mat.N] = inverse_permutation(mat.perm)
        perm_pos = jax.device_put(pp, row1d)
    fold = fold_ck = None
    from ..ecc import codec as _codec

    if mat.mode in _codec.ECC_MODES:
        # Rotated-fold live-detection plane + baseline (ecc.fold),
        # derived from the sharded planes so each piece inherits the
        # row sharding — read by the pallas target's live schedule.
        from ..ecc.fold import fold_words

        fold = fold_words(list(words))
        fold_ck = fold_words(list(cksum))[None, :]
    md = MatrixDevice(words=words, ell_len=ell_len, cksum=cksum,
                      values=values, gidx=gidx, perm_pos=perm_pos,
                      fold=fold, fold_ck=fold_ck)

    def put_vec(v):
        """Canonical (N,) host vector -> exec-order, padded, row-sharded."""
        vpad = np.zeros(R_pad, dtype=np.float64)
        vpad[: mat.N] = mat.to_exec_order(v)
        return jax.device_put(jnp.asarray(vpad, dtype=dtype), row1d)

    return md, put_vec(b), put_vec


def make_sharded_solver(mat: ProtectedMatrix, mesh, max_itrs: int,
                        conv_threshold: float, dtype):
    """Jitted sharded solve(md, b) for this matrix config."""
    import jax

    spmv = make_spmv(mat, dtype)
    solver = make_cg_solver(spmv, max_itrs, conv_threshold)
    return jax.jit(solver)


def solve_sharded(mat: ProtectedMatrix, b: np.ndarray, max_itrs: int,
                  conv_threshold: float, mesh=None, dtype=None):
    """Row-sharded CG over all (or the given mesh's) devices.

    ``b`` is in canonical order; the returned ``CGResult.x`` is in
    execution order (map back with ``mat.from_exec_order`` after
    stripping the mesh padding) — identical unless the matrix was built
    with an RCM reordering.
    """
    import jax.numpy as jnp

    if mesh is None:
        mesh = default_mesh()
    dtype = dtype or jnp.float32
    md, bdev, _ = _device_put_sharded(mat, b, mesh, dtype)
    solver = make_sharded_solver(mat, mesh, max_itrs, conv_threshold, dtype)
    return solver(md, bdev)
