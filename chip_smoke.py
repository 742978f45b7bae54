#!/usr/bin/env python3
"""Smoke test of the ABFT-protected CG solver on an NVIDIA GPU.

    python3 chip_smoke.py           # one GPU: phases 1-7
    python3 chip_smoke.py --four    # four GPUs: phase 8 only

Drives the solver's main path through the entry points a user calls
(``bin/cg-csr`` / ``bin/cg-coo`` via ``cli.main``, and the backends) at
the repo's largest documented run, ``-b 100``: 8,192,000 rows and
24,575,800 nonzeros of CSR96 planes, past the card's L2.  Every kernel
of the path runs as compiled for the card and is compared with the
plain-XLA reference at a real width (the DIA layout of -b 100 runs
plain XLA on the pallas target too: its kernel lost end to end).  Phases:

  1. device: the default JAX device is a GPU;
  2. CLI main path at -b 100: clean, corrected (-x), sed and secded
     double-bit fail-stops, the COO binary;
  3. every layout (DIA, RCM-ELL, split, flat) on the pallas target
     against the jnp target, clean and with a corrected fault;
  4. the Triton kernel against the plain reference at >= 1M rows;
  5. an f32 solve against a float64 host CG on the -b 100 problem;
  6. --dtype f64 on the card against the same host CG;
  7. the lazy --check-interval schedule and checkpoint/resume;
  8. (--four) --devices 4 against the one-card solve.

The script exits non-zero and prints no result line when JAX finds no
GPU or any phase fails.  Otherwise its last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Cold and warm compile seconds, the card's name and power limit, the JAX
version and XLA_FLAGS go on earlier lines.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCKS = 100
CONV = 0.001            # the CLI's default convergence threshold (rr)
MAX_ITRS = 1000         # the CLI's default iteration cap
# Kernel vs plain reference, f32: at most 27 products per row summed in
# another order, each partial sum within ~27 * eps_f32 (6e-8) of the
# row's magnitude — relative to the largest entry of w.
KERNEL_RTOL = 2e-6
# Two f32 solves whose reductions run in different orders (Triton vs
# XLA, and the flat layout's atomic segment-sum): rounding differences
# compound over the iterations, and an ill-conditioned family moves an
# iteration or two.  A fault left uncorrected moves the solution by far
# more.
SOLVE_ITERS_SLACK = 2
SOLVE_RTOL = 1e-3
# Phase 3 solves stop at this fraction of the initial rr (a 1e-4 cut of
# the residual norm), well above the f32 floor of every layout's matrix.
LAYOUT_RR_CUT = 1e-8
ELL_SIDE = 1024             # the RCM-ELL grid: 1,048,576 rows
MIN_KERNEL_ROWS = 1_000_000  # phase 4's width floor


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind,
                                              "count": count}})


def rel_inf(a, b) -> float:
    """max|a - b| / max|b|."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = float(np.max(np.abs(b))) or 1.0
    return float(np.max(np.abs(a - b))) / scale


def host_cg(A, b, max_itrs: int, conv: float):
    """Plain float64 CG on the host (scipy CSR ``A``), the reference's
    iteration (cg.cpp:85-118): x0 = 0, stop once rr <= conv.  Returns
    (x, iterations, rr trace)."""
    import numpy as np

    b = np.asarray(b, np.float64)
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rr = float(r @ r)
    trace = []
    itr = 0
    while itr < max_itrs and rr > conv:
        w = A @ p
        alpha = rr / float(p @ w)
        x += alpha * p
        r -= alpha * w
        rr1 = float(r @ r)
        p = r + (rr1 / rr) * p
        rr = rr1
        trace.append(rr)
        itr += 1
    return x, itr, np.asarray(trace)


def csr_of(a):
    """scipy CSR of an AssembledMatrix (both triangles)."""
    import scipy.sparse as sp

    return sp.csr_matrix((a.values, (a.rows, a.cols)), shape=(a.N, a.N))


def true_rr(a, x, b) -> float:
    import numpy as np

    r = np.asarray(b, np.float64) - csr_of(a) @ np.asarray(x, np.float64)
    return float(r @ r)


def run_cli(argv, fmt="csr"):
    """``cg-<fmt> argv`` in this process (a child could not open the
    card while this process holds it): (exit code, stdout)."""
    from abft_sparse_cg import cli

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(list(argv), fmt=fmt)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, buf.getvalue()


def iterations_of(out: str) -> int:
    m = re.search(r"ran for (\d+) iterations", out)
    assert m, out[-2000:]
    return int(m.group(1))


def ensure_matrix() -> str:
    """The CLI's default matrix (a generated stand-in for the
    reference's shallow_water1, matrices/make_matrix.py)."""
    path = os.path.join(REPO, "matrices", "shallow_water1",
                        "shallow_water1.mtx")
    if not os.path.exists(path):
        from abft_sparse_cg.utils.matgen import (spd_tridiagonal,
                                                 write_mm_triangle)

        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_mm_triangle(path, *spd_tridiagonal(81920))
    return path


class Smoke:
    """Shared state: each protected matrix is built once."""

    def __init__(self):
        import numpy as np

        from abft_sparse_cg.formats import load_matrix

        self.mtx = ensure_matrix()
        t0 = time.perf_counter()
        self.a = load_matrix(self.mtx, BLOCKS)
        self.b = np.random.default_rng(7).random(self.a.N)
        self._mats = {}
        log(f"matrix -b {BLOCKS}: N={self.a.N:,} nnz={self.a.nnz:,} "
            f"(load {time.perf_counter() - t0:.1f} s)")

    def mat(self, mode, fmt="csr"):
        from abft_sparse_cg.formats import build_protected

        key = (fmt, mode)
        if key not in self._mats:
            t0 = time.perf_counter()
            self._mats[key] = build_protected(fmt, self.a, mode)
            log(f"  build {fmt}/{mode}: {time.perf_counter() - t0:.1f} s")
        return self._mats[key]

    def solve(self, target, mat, b, **kw):
        from abft_sparse_cg.backends import create

        kw.setdefault("dtype", "f32")
        return create(target, mat.mode).solve(
            mat, b, kw.pop("max_itrs", MAX_ITRS), kw.pop("conv", CONV),
            verbose=False, **kw)


def inject(mat, seed, count=1):
    import numpy as np

    from abft_sparse_cg.inject import inject_bitflips

    return inject_bitflips(mat, "ANY", count, np.random.default_rng(seed),
                           echo=lambda s: None)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_cli(s: Smoke):
    base = ["-f", s.mtx, "-b", str(BLOCKS), "--quiet"]
    t0 = time.perf_counter()
    code, out = run_cli([*base, "-t", "jnp", "-m", "none"])
    assert code == 0 and "spmv route = xla" in out, out[-2000:]
    log(f"  cg-csr -t jnp -m none: {iterations_of(out)} iterations "
        f"({time.perf_counter() - t0:.1f} s with build and compile)")

    code, out = run_cli([*base, "-t", "pallas", "-m", "secded", "--seed",
                         "1"])
    assert code == 0, out[-2000:]
    assert "spmv route = xla-live" in out, out[-2000:]
    clean = iterations_of(out)
    code, out = run_cli([*base, "-t", "pallas", "-m", "secded", "-x",
                         "--seed", "1"])
    assert code == 0, out[-2000:]
    assert re.search(r"\[ECC\] corrected (bit \d+|overall parity bit) "
                     r"at index \d+", out), out[-2000:]
    assert iterations_of(out) == clean, (iterations_of(out), clean)
    log(f"  cg-csr -t pallas -m secded -x --seed 1: corrected, "
        f"{clean} iterations as clean")

    code, out = run_cli([*base, "-t", "pallas", "-m", "sed", "-x",
                         "--seed", "1"])
    assert code == 1 and "[ECC] error detected" in out, out[-2000:]
    code, out = run_cli([*base, "-t", "pallas", "-m", "secded", "-x", "2",
                         "--seed", "1"])
    assert code == 1 and "[ECC] double-bit error detected" in out, \
        out[-2000:]
    log("  sed -x: exit 1 detected; secded -x 2: exit 1 double-bit")

    code, out = run_cli([*base, "-t", "pallas", "-m", "secded"], fmt="coo")
    assert code == 0 and "spmv route = xla-live" in out, out[-2000:]
    log(f"  cg-coo -t pallas -m secded: {iterations_of(out)} iterations")


def rcm_ell(mode):
    """An ELL_SIDE x ELL_SIDE five-point grid (1,048,576 rows) with
    shuffled labels and a diagonal raised to 8 (condition number ~3, so
    CG converges in tens of iterations): RCM recovers a band of ~1024
    with five distinct slots per row, which is ELL, not DIA.  Mode
    constraints never reorders (its checks assert the natural order),
    so there the grid keeps its labels and ELL is forced."""
    from abft_sparse_cg.formats import assemble, build_protected
    from abft_sparse_cg.utils.matgen import shuffle_labels, spd_laplacian_2d

    rows, cols, vals, n = spd_laplacian_2d(ELL_SIDE)
    vals = vals.copy()
    vals[rows == cols] = 8.0
    if mode == "constraints":
        return build_protected("csr", assemble(cols, rows, vals, n, 1),
                               mode, force_exec="ell")
    r, c, v, n = shuffle_labels(rows, cols, vals, n, seed=3)
    m = build_protected("csr", assemble(c, r, v, n, 1), mode)
    assert m.exec_kind == "ell" and m.perm is not None, m.exec_kind
    return m


def _layout_mats():
    """(name, protected matrix, expected pallas route) for the layouts
    other than DIA."""
    from abft_sparse_cg.formats import build_protected
    from abft_sparse_cg.utils import matzoo

    out = [("rcm-ell", rcm_ell("secded"), "triton-ell")]
    # dense-radius-3d (21,952 rows, K=175) leaves a partial last row
    # block for the kernel to mask.
    for name, kind, route in (("periodic-3d", "dia", "xla-live"),
                              ("dense-radius-3d", "ell", "triton-ell"),
                              ("band+random-1pct", "split",
                               "split(triton-ell+xla-live)"),
                              ("powerlaw-graph", "flat", "xla-live")):
        m = build_protected("csr", matzoo.zoo_assembled(name), "secded")
        assert m.exec_kind == kind, (name, m.exec_kind)
        out.append((name, m, route))
    return out


def phase_layouts(s: Smoke):
    import numpy as np

    s.layouts = [("dia", s.mat("secded"), "xla-live")] + _layout_mats()
    for name, m, route in s.layouts:
        b = np.random.default_rng(11).random(m.N)
        conv = LAYOUT_RR_CUT * float(b @ b)
        rp = s.solve("pallas", m, b, conv=conv)
        rj = s.solve("jnp", m, b, conv=conv)
        assert rp.route == route, (name, rp.route)
        assert not rp.failed and not rj.failed, (name, rp.messages)
        assert abs(rp.iterations - rj.iterations) <= SOLVE_ITERS_SLACK, (
            name, rp.iterations, rj.iterations)
        d = rel_inf(rp.x, rj.x)
        assert d <= SOLVE_RTOL, (name, d)
        rf = s.solve("pallas", inject(m, 5), b, conv=conv)
        assert rf.errcode == 0 and rf.corrected_count == 1, (
            name, rf.errcode, rf.messages)
        assert abs(rf.iterations - rp.iterations) <= SOLVE_ITERS_SLACK
        df = rel_inf(rf.x, rp.x)
        assert df <= SOLVE_RTOL, (name, df)
        log(f"  {name:17s} N={m.N:>9,} {rp.route}: {rp.iterations} iters "
            f"(jnp {rj.iterations}), |x-x_jnp|={d:.1e}; corrected "
            f"{rf.messages[0]!r}, |x-x_clean|={df:.1e}")


def phase_kernels(s: Smoke):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from abft_sparse_cg.ops.spmv import make_matrix_device, make_spmv
    from abft_sparse_cg.ops.spmv_pallas import make_pallas_spmv, route_for
    from abft_sparse_cg.solver.cg import make_cg_solver

    name = "rcm-ell"
    for mode in ("none", "constraints", "sed", "sec7", "sec8", "secded"):
        m = rcm_ell(mode)
        assert m.N >= MIN_KERNEL_ROWS
        assert route_for(m, "gpu") == "triton-ell"
        md = make_matrix_device(m, jnp.float32)
        x = jnp.asarray(np.random.default_rng(3).random(m.R),
                        jnp.float32)
        kern = make_pallas_spmv(m, jnp.float32, mode)
        ref = make_spmv(m, jnp.float32, mode)
        t0 = time.perf_counter()
        w, trig, pw = jax.block_until_ready(jax.jit(kern.fast_pw)(md, x))
        cold = time.perf_counter() - t0
        w0, st0 = jax.jit(ref.full)(md, x)
        d = rel_inf(w, w0)
        assert d <= KERNEL_RTOL, (name, mode, d)
        assert not bool(trig) and int(st0.errcode) == 0
        dpw = abs(float(pw) - float(jnp.sum(x * w0))) / abs(float(pw))
        assert dpw <= KERNEL_RTOL, (name, mode, dpw)
        msg = (f"  {name} {mode:11s} R={m.R:,}: |w-w_ref|/|w|={d:.1e}"
               f", p.w {dpw:.1e}, compile+run {cold:.1f} s")
        if mode == "secded":
            # A fault: the kernel triggers, and the solve reports the
            # same event as the reference target's.
            mf = inject(m, 9)
            mdf = make_matrix_device(mf, jnp.float32)
            assert bool(jax.jit(kern.fast_pw)(mdf, x)[1]), name
            b = np.random.default_rng(4).random(m.N)
            rp = s.solve("pallas", mf, b, max_itrs=20)
            rj = s.solve("jnp", mf, b, max_itrs=20)
            for f in ("errcode", "corrected_index", "corrected_bit",
                      "corrected_count"):
                assert getattr(rp, f) == getattr(rj, f), (
                    name, f, getattr(rp, f), getattr(rj, f))
            msg += f"; fault: {rp.messages[0]!r} on both targets"
        log(msg)
    # m, md: the secded RCM-ELL matrix of the last round.
    jaxpr = str(jax.make_jaxpr(make_cg_solver(
        make_pallas_spmv(m, jnp.float32, "secded"), 100, CONV))(
        md, jnp.zeros(m.R, jnp.float32)))
    assert "dot_general" not in jaxpr
    log("  solve jaxpr: no dot_general (no TF32 on the path)")


def phase_f32_vs_host(s: Smoke):
    m = s.mat("secded")
    x64, it64, _ = host_cg(csr_of(s.a), s.b, MAX_ITRS, CONV)
    s.host = (it64, _)
    for target in ("pallas", "jnp"):
        r = s.solve(target, m, s.b)
        assert not r.failed
        assert abs(r.iterations - it64) <= 2, (target, r.iterations, it64)
        rr = true_rr(s.a, r.x, s.b)
        assert rr <= CONV, (target, rr)
        log(f"  {target}: f32 {r.iterations} iterations vs host f64 "
            f"{it64}; true rr {rr:.3e} <= {CONV}; |x-x64|="
            f"{rel_inf(r.x, x64):.1e}")


def phase_f64(s: Smoke):
    import numpy as np

    m = s.mat("secded")
    _, it64, trace64 = host_cg(csr_of(s.a), s.b, MAX_ITRS, CONV)
    for target in ("pallas", "jnp"):
        r = s.solve(target, m, s.b, dtype="f64")
        assert not r.failed
        assert r.iterations == it64, (target, r.iterations, it64)
        got = np.asarray(r.rr_trace)[:it64]
        d = float(np.max(np.abs(got - trace64) / trace64))
        assert d <= 1e-10, (target, d)
        log(f"  {target} --dtype f64: {r.iterations} iterations as the "
            f"host; rr trajectory within {d:.1e} relative")


def phase_lazy_and_restart(s: Smoke):
    m = s.mat("secded")
    clean = s.solve("pallas", m, s.b)
    os.environ["ABFT_CHECK_INTERVAL"] = "8"
    try:
        r = s.solve("pallas", inject(m, 21), s.b)
    finally:
        os.environ.pop("ABFT_CHECK_INTERVAL")
    assert r.errcode == 0 and r.corrected_count >= 1, r.messages
    assert r.iterations == clean.iterations
    d = rel_inf(r.x, clean.x)
    assert d <= KERNEL_RTOL, d
    log(f"  --check-interval 8 with a fault: rolled back, "
        f"{r.messages[0]!r}, {r.iterations} iterations, |x-x_clean|={d:.1e}")

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        r1 = s.solve("pallas", m, s.b, max_itrs=4, checkpoint=ck,
                     checkpoint_every=2)
        assert r1.iterations == 4 and os.path.exists(ck)
        r2 = s.solve("pallas", m, s.b, checkpoint=ck, resume=True)
    assert r2.errcode == 0 and r2.iterations == clean.iterations
    d = rel_inf(r2.x, clean.x)
    assert d <= KERNEL_RTOL, d
    log(f"  --checkpoint -i 4 then --resume: {r2.iterations} iterations "
        f"as the straight solve, |x-x|={d:.1e}")


def phase_four(s: Smoke):
    m = s.mat("secded")
    mf = inject(m, 13)
    base = ["-f", s.mtx, "-b", str(BLOCKS), "--quiet", "-m", "secded",
            "-x", "--seed", "1", "--devices", "4"]
    for target in ("jnp", "pallas"):
        code, out = run_cli([*base, "-t", target])
        assert code == 0 and "corrected" in out, out[-2000:]
        assert "(gspmd)" in out, out[-2000:]
        one = s.solve(target, mf, s.b)
        four = s.solve(target, mf, s.b, devices=4)
        assert one.corrected_count == four.corrected_count == 1
        assert four.iterations == one.iterations, (four.iterations,
                                                   one.iterations)
        d = rel_inf(four.x, one.x)
        assert d <= KERNEL_RTOL, (target, d)
        log(f"  {target} --devices 4 ({four.route}): corrected, "
            f"{four.iterations} iterations as one card, |x4-x1|={d:.1e}")


PHASES_ONE = [("cli", phase_cli), ("layouts", phase_layouts),
              ("kernels", phase_kernels), ("f32-vs-host", phase_f32_vs_host),
              ("f64", phase_f64), ("lazy+restart", phase_lazy_and_restart)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU --devices 4 phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from abft_sparse_cg.utils.platform import configure_compile_cache

    cache = configure_compile_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {devs[0].platform}",
              file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"need {want} GPUs, found {len(devs)}", file=sys.stderr)
        return 1
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache {cache}")

    # Compile seconds of one small program, cold then warm (a second
    # process finds it in the persistent cache; within one process the
    # warm compile is the in-memory hit).
    import jax.numpy as jnp

    def probe(x):
        return jnp.cumsum(jnp.sin(x) * 3.0)

    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        jax.jit(probe).lower(jnp.ones(1 << 20)).compile()
        log(f"{label} compile: {time.perf_counter() - t0:.3f} s")

    s = Smoke()
    phases = ([("four", phase_four)] if args.four
              else [("device", lambda s: None)] + PHASES_ONE)
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}:")
        try:
            fn(s)
        except Exception as e:  # noqa: BLE001 — reported, then exit 1
            import traceback

            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            log(f"phase {name}: FAILED ({type(e).__name__}: "
                f"{str(e)[:300]})")
            continue
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        log(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(result_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
