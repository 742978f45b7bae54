"""The `jnp` target: pure jax.numpy SpMV + while-loop CG.

This is the correctness oracle and the portable tier — it runs on any XLA
backend (CPU for tests, GPU in production) and is the reference point the
pallas target's kernels are diffed against.  Solves are compiled once per
(shape, mode, dtype, limits) configuration and cached.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..formats.protected import ProtectedMatrix
from ..ops.spmv import make_spmv
from ..solver.cg import make_cg_solver
from . import registry
from .base import Backend, HostResult, default_dtype, stats_to_messages

__all__ = ["JnpBackend"]

_SOLVER_CACHE = {}

_warned_live = set()


def warn_live_schedule(route):
    """Warn (once per route per process) when ABFT_CHECK_INTERVAL > 1
    is set but this solve has no lazy schedule — only the pallas target
    has a lazy --check-interval variant (the jnp program's detection
    signals are hoisted by XLA; the cpu target's schedule is fixed).
    Without this, a benchmark that sets the env var around a jnp
    prepare would record a measurement labeled lazy.  ``route`` names
    the target."""
    import sys

    raw = os.environ.get("ABFT_CHECK_INTERVAL", "1") or "1"
    try:
        ci = int(raw)
    except ValueError:
        return
    if ci > 1 and route not in _warned_live:
        _warned_live.add(route)
        print(f"warning: --check-interval has no lazy schedule on the "
              f"{route} route; running the live detection schedule",
              file=sys.stderr)


def _device_arrays(mat: ProtectedMatrix, dtype):
    from ..ops.spmv import make_matrix_device

    return make_matrix_device(mat, dtype)


class JnpBackend(Backend):
    target = "jnp"

    def __init__(self, mode: str):
        self.mode = mode

    # -- construction of jitted callables (cached) ---------------------

    def _route(self, mat, mesh):
        return "xla (gspmd)" if mesh is not None else "xla"

    def _get_solver(self, mat, dtype, max_itrs, conv, r_dev=None,
                    variant="standard", mesh=None):
        # The jnp program is shape-polymorphic under jit and
        # GSPMD-sharded by the operands, so r_dev and mesh do not key it.
        import jax

        warn_live_schedule(self.target)
        # A bordered tail's dense_plan statics (outlier rows, span
        # starts) are baked into the compiled solver — distinguish
        # matrices that agree on every size but differ there.
        tail_plan = (getattr(mat.tail, "dense_plan", None)
                     if mat.exec_kind == "split" else None)
        key = ("solve", variant, mat.fmt, self.mode, mat.exec_kind,
               mat.dia_offsets, mat.R, mat.K, mat.N, mat.nnz, tail_plan,
               str(dtype), max_itrs, float(conv))
        if key not in _SOLVER_CACHE:
            spmv = make_spmv(mat, dtype, self.mode)
            if variant == "pipelined":
                from ..solver.pipelined import make_pipelined_solver

                solver = make_pipelined_solver(spmv, max_itrs, conv)
            else:
                solver = make_cg_solver(spmv, max_itrs, conv)
            _SOLVER_CACHE[key] = jax.jit(solver)
        return _SOLVER_CACHE[key]

    def _checkpoint_continue(self, mat, dtype, max_itrs, conv, variant,
                             mesh, precond=False):
        """Segment function for ``--checkpoint``: make_cg_continue over
        this target's SpMV.  The jnp program is the same single-device
        code on a mesh (GSPMD shards it from the operands), so no
        sharded variant is needed here."""
        if variant != "standard":
            raise ValueError(
                "--checkpoint requires --solver standard (the pipelined "
                "recurrence carries state a snapshot cannot re-seed)")
        from ..solver.cg import make_cg_continue

        warn_live_schedule(self.target)
        return make_cg_continue(make_spmv(mat, dtype, self.mode), conv)

    def _get_spmv(self, mat, dtype):
        import jax

        tail_plan = (getattr(mat.tail, "dense_plan", None)
                     if mat.exec_kind == "split" else None)
        key = ("spmv", mat.fmt, self.mode, mat.exec_kind, mat.dia_offsets,
               mat.R, mat.K, mat.N, mat.nnz, tail_plan, str(dtype))
        if key not in _SOLVER_CACHE:
            impl = make_spmv(mat, dtype, self.mode)
            _SOLVER_CACHE[key] = jax.jit(impl.full)
        return _SOLVER_CACHE[key]

    # -- Backend API ----------------------------------------------------

    def prepare_timed_solve(self, mat, b, max_itrs, conv_threshold,
                            dtype="auto", reps=20):
        """Compile + warm a (single-device, non-checkpoint) solve and
        return ``(batch, iterations)`` where ``batch()`` runs ONE
        timing batch — ``reps`` back-to-back dispatches, ended by
        ``block_until_ready`` — and returns seconds per solve.  Callers
        can prepare several configs and alternate their batches."""
        import jax
        import jax.numpy as jnp

        dt = default_dtype(dtype)
        md = _device_arrays(mat, dt)
        bpad = np.zeros(mat.R, dtype=np.float64)
        bpad[: mat.N] = mat.to_exec_order(b)
        bdev = jnp.asarray(bpad, dtype=dt)

        solve_fn = self._get_solver(mat, dt, max_itrs, conv_threshold)
        compiled = solve_fn.lower(md, bdev, None).compile()
        warm = compiled(md, bdev, None)
        iterations = int(warm.iterations)

        def batch():
            t0 = time.perf_counter()
            for _i in range(reps):
                res = compiled(md, bdev, None)
            jax.block_until_ready(res)
            return (time.perf_counter() - t0) / reps

        return batch, iterations

    def solve(self, mat, b, max_itrs, conv_threshold, verbose=True,
              dtype="auto", precond="none", devices: int = 0,
              solver: str = "standard", reps: int = 0,
              checkpoint: str = None, checkpoint_every: int = 100,
              resume: bool = False) -> HostResult:
        """``reps``: executions averaged into `time taken` (0 = one),
        each timed to ``block_until_ready``.  Surfaced as --reps on the
        CLI.

        ``checkpoint``: snapshot path enabling the segmented solve
        (solver.checkpoint.CheckpointedSolve) — CG state is written to
        host .npz every ``checkpoint_every`` iterations; ``resume``
        restarts from the snapshot if present.  The run executes once
        (no reps averaging: each segment already syncs to the host)."""
        import jax
        import jax.numpy as jnp

        dt = default_dtype(dtype)
        minv_host = None
        if precond == "jacobi":
            d = mat.diagonal()
            minv_host = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 1.0)
        elif precond != "none":
            raise ValueError(f"unknown preconditioner: {precond!r}")

        r_dev = mesh = None
        if devices and devices > 1:
            # GSPMD row-sharded solve over a 1-D mesh (parallel.sharded):
            # same program, sharding annotations on the inputs.
            from ..parallel.sharded import _device_put_sharded, default_mesh

            if devices > len(jax.devices()):
                raise ValueError(
                    f"requested {devices} devices, "
                    f"found {len(jax.devices())}"
                )
            mesh = default_mesh(devices)
            md, bdev, put_vec = _device_put_sharded(mat, b, mesh, dt)
            minv = put_vec(minv_host) if minv_host is not None else None
            if mat.exec_kind == "flat":
                # Flat exec slots are entry positions — mesh padding
                # appends, never shifts, so no slot remap is needed.
                r_dev = None
            elif mat.exec_kind == "split":
                r_dev = int(md[0].words[0].shape[-1])  # == mat.R (asserted
                #                                        by the sharded put)
            else:
                r_dev = int(md.words[0].shape[-1])
        else:
            md = _device_arrays(mat, dt)
            # Vectors enter the solver in execution order (identity unless
            # an RCM reordering was adopted at build time; formats.reorder).
            bpad = np.zeros(mat.R, dtype=np.float64)
            bpad[: mat.N] = mat.to_exec_order(b)
            bdev = jnp.asarray(bpad, dtype=dt)
            minv = None
            if minv_host is not None:
                mpad = np.zeros(mat.R)
                mpad[: mat.N] = mat.to_exec_order(minv_host)
                minv = jnp.asarray(mpad, dtype=dt)

        if checkpoint:
            from ..solver.checkpoint import CheckpointedSolve

            cont = self._checkpoint_continue(mat, dt, max_itrs,
                                             conv_threshold, solver, mesh,
                                             precond=minv is not None)
            state_put = None
            if mesh is not None:
                # Snapshots are host .npz — a resumed segment must get
                # its vectors back on the row sharding.
                from jax.sharding import NamedSharding, PartitionSpec as P

                sh = NamedSharding(mesh, P(mesh.axis_names[0]))
                state_put = lambda v: jax.device_put(v, sh)  # noqa: E731
            runner = CheckpointedSolve(None, conv_threshold,
                                       every=checkpoint_every,
                                       path=checkpoint, continue_fn=cont,
                                       state_put=state_put)
            t0 = time.perf_counter()
            runner.warm(md, bdev, max_itrs, minv)
            t1 = time.perf_counter()
            res = jax.block_until_ready(
                runner.run(md, bdev, max_itrs, resume=resume, minv=minv))
            t2 = time.perf_counter()
            reps = 1  # each segment host-syncs; no reps averaging
        else:
            solve_fn = self._get_solver(mat, dt, max_itrs, conv_threshold,
                                        r_dev=r_dev, variant=solver,
                                        mesh=mesh)

            t0 = time.perf_counter()
            compiled = solve_fn.lower(md, bdev, minv).compile()
            # The first execution also loads the executable onto the
            # device — run it once untimed so `time taken` is steady
            # state (the reference's benchmark averages warm runs too).
            jax.block_until_ready(compiled(md, bdev, minv))
            t1 = time.perf_counter()
            reps = max(1, reps)
            for _i in range(reps):
                res = compiled(md, bdev, minv)
            jax.block_until_ready(res)
            t2 = time.perf_counter()
        x_host = mat.from_exec_order(
            np.asarray(res.x)[: mat.N]  # bulk transfer, not timed
        )

        st = res.stats
        errcode = int(st.errcode)
        msgs, err_index = stats_to_messages(
            mat, errcode, int(st.err_slot), int(st.first_cor_slot),
            int(st.first_cor_bit), r_dev=r_dev,
        )
        # Repaired planes, observable post-solve (the reference's in-place
        # write-back).
        scrubbed = None
        if int(st.corrected_count) > 0:
            from ..scrub import scrubbed_from_device

            scrubbed = scrubbed_from_device(mat, res.md)
        return HostResult(
            x=x_host,
            iterations=int(res.iterations),
            rr=float(res.rr),
            errcode=errcode,
            err_index=err_index,
            corrected_count=int(st.corrected_count),
            corrected_index=int(st.first_cor_slot),
            corrected_bit=int(st.first_cor_bit),
            messages=msgs,
            solve_seconds=(t2 - t1) / reps,
            compile_seconds=t1 - t0,
            rr_trace=np.asarray(res.rr_trace),
            scrubbed=scrubbed,
            route=self._route(mat, mesh),
        )

    def spmv_once(self, mat, x, dtype="auto"):
        import jax.numpy as jnp

        dt = default_dtype(dtype)
        md = _device_arrays(mat, dt)
        xpad = np.zeros(mat.R, dtype=np.float64)
        xpad[: mat.N] = mat.to_exec_order(x)
        spmv = self._get_spmv(mat, dt)
        w, st = spmv(md, jnp.asarray(xpad, dtype=dt))
        errcode = int(st.errcode)
        msgs, err_index = stats_to_messages(
            mat, errcode, int(st.err_slot), int(st.first_cor_slot),
            int(st.first_cor_bit),
        )
        return mat.from_exec_order(np.asarray(w)[: mat.N]), errcode, msgs


def _register():
    from ..ecc.codec import MODES

    for mode in MODES:
        registry.register("jnp", mode, lambda m=mode: JnpBackend(m))


_register()
