"""Headline benchmark — prints ONE JSON line on stdout.

Metric: full CG solve wall time, cg-csr / secded, `-b 10` scale
(N=819,200, nnz=2,457,580 — the configuration BASELINE.md measured for
the reference: 239.6 ms on a host CPU).  ``vs_baseline`` is the speedup
factor (baseline_ms / ours_ms, higher is better).

Both the jnp and the pallas targets run every mode; a target that fails
fails the run.  The JSON names the device the numbers come from and the
faster target (``tier``).  Diagnostics on stderr: the card's name and
power limit, the per-mode table, and the ABFT overhead vs mode none.

Timing: each solve is one device program, compiled and run once untimed,
then timed over the backend's ``reps`` executions ended by
``jax.block_until_ready``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from chip_smoke import card_line, ensure_matrix

# Reference cg-csr measurements from BASELINE.md (`run_benchmark`, -b 10).
BASELINE_MS = {
    "none": 56.3,
    "constraints": 61.0,
    "sed": 63.8,
    "sec7": 235.6,
    "sec8": 66.1,
    "secded": 239.6,
}
BLOCKS = 10
REPS = 20
ALL_MODES = ("none", "constraints", "sed", "sec7", "sec8", "secded")
TARGETS = ("jnp", "pallas")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_mode(mat, b, mode, target):
    from abft_sparse_cg.backends import create

    res = create(target, mode).solve(mat, b, 1000, 0.001, verbose=False,
                                     reps=REPS)
    assert not res.failed, (mode, target, res.messages)
    ms = res.solve_seconds * 1e3
    log(f"  {target:6s} {mode:12s}: {ms:8.3f} ms/solve  "
        f"({res.iterations} iters, rr={res.rr:.6f}, route {res.route}, "
        f"compile {res.compile_seconds:.1f}s)")
    return ms


def main():
    from abft_sparse_cg.utils.platform import configure_compile_cache

    configure_compile_cache()
    import jax

    from abft_sparse_cg.formats import build_protected, load_matrix

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    log(f"card: {card_line()}")
    a = load_matrix(ensure_matrix(), BLOCKS)
    log(f"matrix: N={a.N:,} nnz={a.nnz:,} (-b {BLOCKS})")

    b = np.random.default_rng(12345).random(a.N)
    times = {}
    for mode in ALL_MODES:
        mat = build_protected("csr", a, mode)
        for t in TARGETS:
            times[t, mode] = bench_mode(mat, b, mode, t)
    tier = min(TARGETS, key=lambda t: times[t, "secded"])
    none, sec = times[tier, "none"], times[tier, "secded"]
    overhead = (sec - none) / none * 100
    log(f"tier: {tier}; ABFT secded overhead vs none: {overhead:+.1f}% "
        f"(reference: +326%)")
    print(json.dumps({
        "metric": f"cg_csr_secded_solve_ms_b10_{tier}",
        "value": round(sec, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS["secded"] / sec, 2),
        "abft_overhead_pct": round(overhead, 1),
        "modes_ms": {f"{t}-{m}": round(v, 3) for (t, m), v in times.items()},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
