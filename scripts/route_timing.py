#!/usr/bin/env python3
"""Time the pallas target's routes on a GPU.

For the -b 100 DIA matrix (8,192,000 rows) and the 1,048,576-row RCM-ELL
matrix of chip_smoke.py, modes none and secded, this times

  - the Triton kernel route (``ops.spmv_pallas``, platform "gpu"; ELL
    only — DIA has no kernel), and
  - the plain-XLA live version (``ops.spmv.make_spmv(live=True)``),

three ways: the SpMV with its detection alone, one CG iteration (the
slope between solves of K1 and K2 iterations), and the end-to-end solve
to the CLI's threshold.  Configurations alternate A B B A; every time
is a median over ``--reps`` executions, each ended by
``jax.block_until_ready``, with the quartiles beside it.  One JSON line
per measurement on stdout, after the card's name and power limit.

    python3 scripts/route_timing.py            # measure
    python3 scripts/route_timing.py --check    # compile + compare only
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

K1, K2 = 4, 24          # iteration counts of the slope solves
ROUTES = {"triton": "gpu", "xla-live": "cpu"}   # route -> routing platform


def stats(ts):
    import numpy as np

    q1, med, q3 = np.percentile(np.asarray(ts) * 1e6, [25, 50, 75])
    return {"median_us": float(med), "q1_us": float(q1), "q3_us": float(q3),
            "n": len(ts)}


def timed(fn, args, reps):
    """Per-execution seconds of a compiled ``fn`` (warm)."""
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def routes_of(m):
    """The routes to time for ``m``: both where a kernel exists."""
    from abft_sparse_cg.ops.spmv_pallas import route_for

    if route_for(m, "gpu") == "xla-live":
        return {"xla-live": ROUTES["xla-live"]}
    return ROUTES


def matrices():
    import chip_smoke
    from abft_sparse_cg.formats import build_protected, load_matrix

    a = load_matrix(chip_smoke.ensure_matrix(), chip_smoke.BLOCKS)
    for mode in ("none", "secded"):
        yield "dia-b100", mode, build_protected("csr", a, mode)
        yield "rcm-ell-1M", mode, chip_smoke.rcm_ell(mode)


def programs(m, mode, platform):
    """(spmv, solve_k1, solve_k2, solve_conv) jitted for one route."""
    import jax
    import jax.numpy as jnp

    from abft_sparse_cg.ops.spmv_pallas import make_pallas_spmv
    from abft_sparse_cg.solver.cg import make_cg_solver

    impl = make_pallas_spmv(m, jnp.float32, mode, platform=platform)
    spmv = jax.jit(impl.fast_pw)
    # conv < 0: the loop runs exactly max_itrs iterations.
    k1 = jax.jit(make_cg_solver(impl, K1, -1.0, trace_rr=False))
    k2 = jax.jit(make_cg_solver(impl, K2, -1.0, trace_rr=False))
    conv = jax.jit(make_cg_solver(impl, 5000, 0.001, trace_rr=False))
    return spmv, k1, k2, conv


def check(m, name, mode):
    """Compile each route at its real width, compare it once with the
    plain reference, print the compiled memory analysis."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from abft_sparse_cg.ops.spmv import make_matrix_device, make_spmv

    md = make_matrix_device(m, jnp.float32)
    x = jnp.asarray(np.random.default_rng(1).random(m.R), jnp.float32)
    w0, _ = jax.jit(make_spmv(m, jnp.float32, mode).full)(md, x)
    for route, plat in routes_of(m).items():
        spmv = programs(m, mode, plat)[0]
        t0 = time.perf_counter()
        comp = spmv.lower(md, x).compile()
        w, trig, _ = comp(md, x)
        print(json.dumps({
            "check": name, "mode": mode, "route": route,
            "compile_s": time.perf_counter() - t0,
            "rel_inf": chip_smoke.rel_inf(w, w0), "trigger": bool(trig),
            "memory": str(comp.memory_analysis())}), flush=True)


def measure(m, name, mode, reps):
    import jax.numpy as jnp
    import numpy as np

    from abft_sparse_cg.ops.spmv import make_matrix_device

    md = make_matrix_device(m, jnp.float32)
    b = np.zeros(m.R)
    b[: m.N] = np.random.default_rng(12345).random(m.N)
    b = jnp.asarray(b, jnp.float32)
    routes = routes_of(m)
    progs = {r: programs(m, mode, p) for r, p in routes.items()}
    res = {r: {"spmv": [], "k1": [], "k2": [], "conv": []} for r in routes}
    iters = {}
    order = list(routes)
    for rnd in range(2):                      # A B, then B A
        for r in (order if rnd == 0 else order[::-1]):
            spmv, k1, k2, conv = progs[r]
            res[r]["spmv"] += timed(spmv, (md, b), reps)
            assert int(k1(md, b).iterations) == K1
            assert int(k2(md, b).iterations) == K2
            res[r]["k1"] += timed(k1, (md, b), reps)
            res[r]["k2"] += timed(k2, (md, b), reps)
            res[r]["conv"] += timed(conv, (md, b), reps)
            iters[r] = int(conv(md, b).iterations)
    for r in routes:
        k1m = np.median(res[r]["k1"])
        k2m = np.median(res[r]["k2"])
        print(json.dumps({
            "matrix": name, "mode": mode, "route": r, "R": m.R,
            "spmv": stats(res[r]["spmv"]),
            "per_iter_us": float((k2m - k1m) / (K2 - K1) * 1e6),
            "solve": stats(res[r]["conv"]), "solve_iters": iters[r]}),
            flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    from abft_sparse_cg.utils.platform import configure_compile_cache

    configure_compile_cache()
    import jax

    import chip_smoke

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: default device is {dev.platform}", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    print(f"device: {dev.device_kind} x{len(jax.devices())}, jax "
          f"{jax.__version__}", flush=True)
    for name, mode, m in matrices():
        if args.check:
            check(m, name, mode)
        else:
            measure(m, name, mode, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
