"""(target, mode) backend registry — the framework's extensibility point.

Same machine-readable contract as the reference's self-registration list
(reference CGContext.h:55-63, CGContext.cpp:9-37): backends register a
(target, mode, factory) triple at import time; ``--list`` prints
``\\ttarget-mode`` lines that the black-box test/bench harnesses consume
to enumerate implementations (reference run_tests:7, run_benchmark:10).

Targets here are kernel tiers rather than ISAs:

  ====== =======================================================
  jnp    pure jax.numpy — the correctness oracle; runs on any
         XLA backend (CPU/GPU), single- or multi-device
  pallas live detection every iteration: a Triton kernel for the
         ELL layout on a GPU, plain XLA elsewhere
  cpu    native C++/OpenMP host backend (ctypes), the analogue of
         the reference's cpu target — registered only if built
  ====== =======================================================
"""

from __future__ import annotations

import sys

__all__ = ["register", "create", "list_contexts", "available"]

_REGISTRY = []  # [(target, mode, factory)] in registration order


def register(target: str, mode: str, factory):
    _REGISTRY.append((target, mode, factory))


def available():
    return [(t, m) for t, m, _ in _REGISTRY]


def create(target: str, mode: str):
    for t, m, factory in _REGISTRY:
        if t == target and m == mode:
            return factory()
    # Same message + exit status as the reference (CGContext.cpp:20-23).
    print(f"\nNo implementation found for {target}-{mode}\n", file=sys.stderr)
    raise SystemExit(1)


def list_contexts(file=None):
    out = file or sys.stdout
    print("\nRegistered contexts:", file=out)
    for t, m, _ in _REGISTRY:
        print(f"\t{t}-{m}", file=out)
    print(file=out)
