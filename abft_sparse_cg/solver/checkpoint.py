"""Checkpoint / resume for long solves.

The reference has no checkpointing (solves run in seconds; SURVEY §5),
but a production framework needs it: the solver core is already
segmented (`make_cg_continue` advances to a runtime iteration bound), so
a checkpoint is just the ``CGState`` snapshot — (x, r, p, rr, itr), the
accumulated ABFT stats and the residual trace — written with NumPy
(``.npz``; no new dependencies, readable anywhere).

Usage:

    runner = CheckpointedSolve(impl, conv=1e-3, every=100, path="ckpt.npz")
    result = runner.run(md, b, max_itrs=10_000)      # saves every 100 its
    result = runner.run(md, b, max_itrs=10_000, resume=True)
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.spmv import SpmvStats
from .cg import (
    CGResult,
    CGState,
    init_state,
    make_cg_continue,
    trace_length,
)

__all__ = ["save_state", "load_state", "CheckpointedSolve"]

_FIELDS = ("itr", "x", "r", "p", "rr", "rz", "trace")
_STAT_FIELDS = SpmvStats._fields


def save_state(path: str, state: CGState):
    arrays = {f: np.asarray(getattr(state, f)) for f in _FIELDS}
    for f in _STAT_FIELDS:
        arrays[f"stats_{f}"] = np.asarray(getattr(state.stats, f))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, dtype=None) -> CGState:
    import jax.numpy as jnp

    with np.load(path) as z:
        stats = SpmvStats(**{
            f: jnp.asarray(z[f"stats_{f}"]) for f in _STAT_FIELDS
        })
        cast = (lambda a: jnp.asarray(a, dtype)) if dtype is not None else jnp.asarray
        return CGState(
            itr=jnp.asarray(z["itr"]),
            x=cast(z["x"]),
            r=cast(z["r"]),
            p=cast(z["p"]),
            rr=cast(z["rr"]),
            rz=cast(z["rz"]),
            stats=stats,
            trace=cast(z["trace"]),
        )


class CheckpointedSolve:
    """Drive a solve in segments, snapshotting state between them."""

    def __init__(self, impl, conv_threshold: float, every: int,
                 path: str, trace_rr: bool = True, continue_fn=None,
                 state_put=None):
        """``continue_fn`` overrides the solver loop: any callable with
        the ``make_cg_continue`` contract ``(md, state, upto, minv) ->
        (state, md)`` — e.g. ``solver.cg.make_lazy_ci_continue`` for
        the lazy --check-interval schedule (``impl`` may be None
        then).

        ``state_put``: optional per-vector placement hook applied to
        the (x, r, p) vectors of a *resumed* state — a checkpoint is
        host .npz, so a mesh-sharded solve passes the row sharding here
        (e.g. ``lambda v: jax.device_put(v, row1d)``) to re-establish
        shard placement instead of starting the segment replicated.
        Fresh runs never need it: ``init_state`` derives placement from
        ``b``."""
        import jax

        self.every = int(every)
        self.path = path
        self.trace_rr = trace_rr
        self.state_put = state_put
        if continue_fn is None:
            continue_fn = make_cg_continue(impl, conv_threshold, trace_rr)
        self._cont = jax.jit(continue_fn)

    def warm(self, md, b, max_itrs: int, minv=None):
        """Compile the segment function ahead of ``run`` (so callers can
        report compile time separately from solve time)."""
        import jax.numpy as jnp

        state = init_state(b, max_itrs, self.trace_rr, minv)
        self._cont.lower(md, state, jnp.int32(0), minv).compile()

    def run(self, md, b, max_itrs: int, resume: bool = False,
            minv=None) -> CGResult:
        import jax.numpy as jnp

        if resume and os.path.exists(self.path):
            state = load_state(self.path, dtype=b.dtype)
            # The snapshot's rr trace is sized for the run that wrote it;
            # resuming with a larger max_itrs must grow it (a short trace
            # would clamp later .at[itr].set writes onto its last entry)
            # and a smaller one keeps the compiled shape consistent.
            tlen = trace_length(max_itrs, self.trace_rr)
            cur = state.trace.shape[0]
            if cur < tlen:
                pad = jnp.full((tlen - cur,), jnp.nan, state.trace.dtype)
                state = state._replace(
                    trace=jnp.concatenate([state.trace, pad]))
            elif cur > tlen:
                state = state._replace(trace=state.trace[:tlen])
            if self.state_put is not None:
                state = state._replace(x=self.state_put(state.x),
                                       r=self.state_put(state.r),
                                       p=self.state_put(state.p))
        else:
            state = init_state(b, max_itrs, self.trace_rr, minv)

        while True:
            itr = int(state.itr)
            if itr >= max_itrs or int(state.stats.errcode) != 0:
                break
            upto = min(itr + self.every, max_itrs)
            # The returned md carries any scrub forward, so a persistent
            # fault classifies exactly once per solve (not per segment)
            # and corrected_count stays exact.
            state, md = self._cont(md, state, jnp.int32(upto), minv)
            new_itr = int(state.itr)  # forces sync; segment finished
            save_state(self.path, state)
            if new_itr < upto or int(state.stats.errcode) != 0:
                break  # converged or fail-stopped mid-segment

        return CGResult(x=state.x, iterations=state.itr, rr=state.rr,
                        stats=state.stats, rr_trace=state.trace, md=md)
