"""Fused BLAS-1 pieces of the CG iteration.

Direct functional equivalents of the reference context ops (reference
CSR/CPUContext.cpp:82-113): ``dot``, the fused ``calc_xr`` (two AXPYs +
residual-norm reduction in one pass) and ``calc_p``.  All trivially
jnp — XLA fuses them into the surrounding while-loop body, so each one
is a single pass over device memory.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["dot", "calc_xr", "calc_p"]


def dot(a, b):
    return jnp.sum(a * b)


def calc_xr(x, r, p, w, alpha):
    """x += alpha*p ; r -= alpha*w ; return (x, r, dot(r, r))."""
    x = x + alpha * p
    r = r - alpha * w
    return x, r, jnp.sum(r * r)


def calc_p(p, r, beta):
    return r + beta * p
