"""The `pallas` target: live detection on every iteration.

Same Backend contract as the jnp target; the SpMV comes from
ops.spmv_pallas, whose routing table picks a Triton kernel for the banded
layouts on a GPU and the plain-XLA live version everywhere else
(``HostResult.route`` names the route taken).  ``--devices N`` rides the
GSPMD program of the live version (a Triton custom call has no SPMD
partitioning rule).
"""

from __future__ import annotations

from ..ops.spmv_pallas import (device_platform, make_pallas_product,
                               make_pallas_spmv, route_name)
from ..solver.cg import (make_cg_continue, make_cg_solver,
                         make_lazy_ci_continue, make_lazy_ci_solver)
from . import registry
from .jnp_backend import JnpBackend, _SOLVER_CACHE

__all__ = ["PallasBackend"]


def _check_interval(variant="standard"):
    """The lazy detection schedule's interval from ABFT_CHECK_INTERVAL
    (the CLI's --check-interval sets it for the invocation), validated.
    ``auto`` is the live schedule (1).  The pipelined solver has no lazy
    variant — its recurrences carry extra vectors a rollback would have
    to re-seed — so it warns and runs the live schedule."""
    import os
    import sys

    raw = os.environ.get("ABFT_CHECK_INTERVAL", "1") or "1"
    if raw == "auto":
        return 1
    try:
        ci = max(1, int(raw))
    except ValueError:
        raise ValueError(
            f"ABFT_CHECK_INTERVAL must be an integer or 'auto', "
            f"got {raw!r}")
    if ci > 1 and variant == "pipelined":
        print("warning: --check-interval has no pipelined-solver "
              "variant; running the live detection schedule",
              file=sys.stderr)
        return 1
    return ci


class PallasBackend(JnpBackend):
    target = "pallas"

    def _route(self, mat, mesh):
        return route_name(mat, "gspmd" if mesh is not None
                          else device_platform())

    def _impls(self, mat, dtype, mesh, ci):
        """(checked impl, detection-free product or None) for the route."""
        platform = "gspmd" if mesh is not None else None
        spmv = make_pallas_spmv(mat, dtype, self.mode, platform=platform)
        product = None
        if ci > 1 and spmv.classify is not None:
            product = make_pallas_product(mat, dtype, self.mode,
                                          platform=platform)
        return spmv, product

    def _get_solver(self, mat, dtype, max_itrs, conv, r_dev=None,
                    variant="standard", mesh=None):
        import jax

        ci = _check_interval(variant)
        # A bordered tail's dense_plan statics are baked into the
        # compiled solver — same-shaped matrices must not collide.
        tail_plan = (getattr(mat.tail, "dense_plan", None)
                     if mat.exec_kind == "split" else None)
        key = ("psolve", variant, mat.fmt, self.mode, mat.exec_kind,
               mat.dia_offsets, mat.R, mat.K, mat.N, mat.nnz, mat.band,
               mat.perm is not None, tail_plan, str(dtype), max_itrs,
               float(conv), ci, self._route(mat, mesh))
        if key not in _SOLVER_CACHE:
            spmv, product = self._impls(mat, dtype, mesh, ci)
            if variant == "pipelined":
                from ..solver.pipelined import make_pipelined_solver

                solver = make_pipelined_solver(spmv, max_itrs, conv)
            elif product is not None:
                solver = make_lazy_ci_solver(spmv, product, ci, max_itrs,
                                             conv)
            else:
                solver = make_cg_solver(spmv, max_itrs, conv)
            _SOLVER_CACHE[key] = jax.jit(solver)
        return _SOLVER_CACHE[key]

    def _checkpoint_continue(self, mat, dtype, max_itrs, conv, variant,
                             mesh, precond=False):
        """Segment function for ``--checkpoint``: the same routes as
        _get_solver (lazy loop when --check-interval K > 1)."""
        if variant != "standard":
            return super()._checkpoint_continue(mat, dtype, max_itrs,
                                                conv, variant, mesh,
                                                precond)
        spmv, product = self._impls(mat, dtype, mesh, _check_interval())
        if product is not None:
            return make_lazy_ci_continue(spmv, product, _check_interval(),
                                         conv)
        return make_cg_continue(spmv, conv)

    def _get_spmv(self, mat, dtype):
        import jax

        tail_plan = (getattr(mat.tail, "dense_plan", None)
                     if mat.exec_kind == "split" else None)
        key = ("pspmv", mat.fmt, self.mode, mat.exec_kind, mat.dia_offsets,
               mat.R, mat.K, mat.N, mat.nnz, mat.band, mat.perm is not None,
               tail_plan, str(dtype), self._route(mat, None))
        if key not in _SOLVER_CACHE:
            impl = make_pallas_spmv(mat, dtype, self.mode)
            _SOLVER_CACHE[key] = jax.jit(impl.full)
        return _SOLVER_CACHE[key]


def _register():
    from ..ecc.codec import MODES

    for mode in MODES:
        registry.register("pallas", mode, lambda m=mode: PallasBackend(m))


_register()
