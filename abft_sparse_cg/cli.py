"""Command-line driver — flag-for-flag port of the reference's cg.cpp.

Two executable personalities (`cg-csr`, `cg-coo`) mirror the reference's
two binaries; each fixes the storage format/codeword layout.  All of the
reference's flags (reference cg.cpp:180-309) are accepted with identical
semantics, defaults (cg.cpp:183-192) and stdout contract — the black-box
harnesses (run_tests, run_benchmark) work unmodified against this driver.

Framework additions (all optional):
  --format F          select csr|coo when invoked as the generic module
  --seed S            seed *both* the b-vector and the injector RNG
                      (the reference's injector is time-seeded and thus
                      unreproducible, cg.cpp:79; this fixes that)
  --dtype {auto,f32,f64}  compute dtype (storage is always the protected
                      binary64 planes); auto = f64 on CPU, f32 on a GPU
  --quiet             suppress per-iteration residual lines
"""

from __future__ import annotations

import os
import sys

import numpy as np

__all__ = ["main", "main_csr", "main_coo"]

_USAGE_OPTIONS = """Options:
  -h  --help                  Print this message
  -b  --num-blocks      B     Number of times to block input matrix
  -c  --convergence     C     Convergence threshold
  -f  --matrix-file     M     Path to matrix-market format file
  -i  --iterations      I     Maximum number of iterations
  -l  --list                  List available implementations
  -m  --mode            MODE  ABFT mode
  -t  --target          TARG  Implementation target
  -x  --inject-bitflip        Inject a random bit-flip into A
      --format          F     Storage format: csr | coo
      --seed            S     Seed b-vector and injector RNGs
      --dtype           D     Compute dtype: auto | f32 | f64
      --quiet                 Suppress per-iteration residual output
      --profile         DIR   Write a jax.profiler trace of the solve
      --devices         N     Row-shard the solve over N devices (GSPMD)
      --solver          S     CG variant: standard | pipelined
      --reps            N     Executions averaged into 'time taken'
                              (default: 1)
      --refine          K     Mixed-precision refinement: up to K
                              rounds of f32 inner CG + binary64
                              true-residual restart (f64-level final
                              accuracy at f32 kernel speed)
      --check-interval  K     Lazy ABFT schedule (pallas target):
                              verify every K-th iteration, snapshot-
                              rollback on a trigger (default 1 = live;
                              'auto' = live until measurement picks
                              another interval)
      --checkpoint      PATH  Segment the solve and snapshot CG state
                              to PATH (.npz) between segments
      --checkpoint-every N    Iterations per segment (default: 100)
      --resume                Resume from --checkpoint PATH if present
  -p  --precond         P     Preconditioner: none | jacobi

  The -l|--list argument will provide a list of tuples that describe
  which implementations are available to be passed to the
  -t|--target and -m|--mode arguments.

  The -x|--inject-bitflip argument optionally takes a number to
  control how many bits to flip, and either INDEX or VALUE to
  restrict the region of bits in the matrix element to target.
"""

DEFAULT_MATRIX = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "..", "matrices", "shallow_water1", "shallow_water1.mtx",
)


def _parse_double(s):
    try:
        return float(s)
    except ValueError:
        return -1.0


def _parse_int(s):
    try:
        v = int(s)
        return v
    except ValueError:
        return -1


def parse_arguments(argv, fmt):
    params = {
        "max_itrs": 1000,
        "conv_threshold": 0.001,
        "num_bit_flips": 0,
        "bitflip_kind": "ANY",
        "num_blocks": 25,
        "matrix_file": os.path.normpath(DEFAULT_MATRIX),
        "target": "jnp",
        "mode": "none",
        "fmt": fmt,
        "seed": None,
        "dtype": "auto",
        "quiet": False,
        "list": False,
        "profile": None,
        "precond": "none",
        "devices": 0,
        "solver": "standard",
        "reps": 0,
        "checkpoint": None,
        "checkpoint_every": 100,
        "resume": False,
    }
    i = 0
    n = len(argv)
    while i < n:
        a = argv[i]
        if a in ("--convergence", "-c"):
            i += 1
            if i >= n or (v := _parse_double(argv[i])) < 0:
                print("Invalid convergence threshold")
                raise SystemExit(1)
            params["conv_threshold"] = v
        elif a in ("--iterations", "-i"):
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 0:
                print("Invalid number of iterations")
                raise SystemExit(1)
            params["max_itrs"] = v
        elif a in ("--list", "-l"):
            params["list"] = True
        elif a in ("--num-blocks", "-b"):
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid number of blocks")
                raise SystemExit(1)
            params["num_blocks"] = v
        elif a in ("--matrix-file", "-f"):
            i += 1
            if i >= n:
                print("Matrix filename required")
                raise SystemExit(1)
            params["matrix_file"] = argv[i]
        elif a in ("--mode", "-m"):
            i += 1
            if i >= n:
                print("ABFT mode required")
                raise SystemExit(1)
            params["mode"] = argv[i]
        elif a in ("--target", "-t"):
            i += 1
            if i >= n:
                print("Implementation target required")
                raise SystemExit(1)
            params["target"] = argv[i]
        elif a in ("--inject-bitflip", "-x"):
            params["num_bit_flips"] = 1
            # Greedy optional sub-args, like the reference (cg.cpp:254-274).
            while i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                if argv[i] == "INDEX":
                    params["bitflip_kind"] = "INDEX"
                elif argv[i] == "VALUE":
                    params["bitflip_kind"] = "VALUE"
                elif (v := _parse_int(argv[i])) >= 1:
                    params["num_bit_flips"] = v
                else:
                    print("Invalid bit-flip parameter")
                    raise SystemExit(1)
        elif a == "--format":
            i += 1
            if i >= n or argv[i] not in ("csr", "coo"):
                print("Invalid format (csr|coo)")
                raise SystemExit(1)
            params["fmt"] = argv[i]
        elif a == "--seed":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 0:
                print("Invalid seed")
                raise SystemExit(1)
            params["seed"] = v
        elif a == "--dtype":
            i += 1
            if i >= n or argv[i] not in ("auto", "f32", "f64"):
                print("Invalid dtype (auto|f32|f64)")
                raise SystemExit(1)
            params["dtype"] = argv[i]
        elif a == "--quiet":
            params["quiet"] = True
        elif a == "--profile":
            i += 1
            if i >= n:
                print("Profile directory required")
                raise SystemExit(1)
            params["profile"] = argv[i]
        elif a == "--devices":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid device count")
                raise SystemExit(1)
            params["devices"] = v
        elif a == "--solver":
            i += 1
            if i >= n or argv[i] not in ("standard", "pipelined"):
                print("Invalid solver (standard|pipelined)")
                raise SystemExit(1)
            params["solver"] = argv[i]
        elif a == "--reps":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid rep count")
                raise SystemExit(1)
            params["reps"] = v
        elif a == "--checkpoint":
            i += 1
            if i >= n:
                print("Checkpoint path required")
                raise SystemExit(1)
            params["checkpoint"] = argv[i]
        elif a == "--checkpoint-every":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid checkpoint interval")
                raise SystemExit(1)
            params["checkpoint_every"] = v
        elif a == "--resume":
            params["resume"] = True
        elif a == "--refine":
            i += 1
            if i >= n or (v := _parse_int(argv[i])) < 0:
                print("Invalid refine count")
                raise SystemExit(1)
            params["refine"] = v
        elif a == "--check-interval":
            i += 1
            if i < n and argv[i] == "auto":
                # Kept symbolic: the backend resolves it
                # (pallas_backend._check_interval).
                params["check_interval"] = "auto"
            elif i >= n or (v := _parse_int(argv[i])) < 1:
                print("Invalid check interval")
                raise SystemExit(1)
            else:
                params["check_interval"] = v
        elif a in ("--precond", "-p"):
            i += 1
            if i >= n or argv[i] not in ("none", "jacobi"):
                print("Invalid preconditioner (none|jacobi)")
                raise SystemExit(1)
            params["precond"] = argv[i]
        elif a in ("--help", "-h"):
            exe = f"cg-{fmt}"
            print(f"\nUsage: {exe} [OPTIONS]\n")
            print(_USAGE_OPTIONS)
            raise SystemExit(0)
        else:
            print(f"Unrecognized argument '{a}' (try '--help')")
            raise SystemExit(1)
        i += 1
    return params


def main(argv=None, fmt="csr"):
    # Die silently when a downstream pipe closes (`--list | head`), like
    # the reference binary; only for real CLI entry, not library use.
    if argv is None:
        import signal

        if hasattr(signal, "SIGPIPE"):
            signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    argv = sys.argv[1:] if argv is None else argv
    params = parse_arguments(argv, fmt)
    ci = params.get("check_interval")
    if ci is None:
        return _main(params, fmt)
    # The backends read the lazy schedule from ABFT_CHECK_INTERVAL (it
    # also serves scripts that never touch the CLI); scope the flag's
    # effect to this invocation so a later in-process main() without
    # --check-interval is not silently lazy.
    prev = os.environ.get("ABFT_CHECK_INTERVAL")
    os.environ["ABFT_CHECK_INTERVAL"] = str(ci)
    try:
        return _main(params, fmt)
    finally:
        if prev is None:
            os.environ.pop("ABFT_CHECK_INTERVAL", None)
        else:
            os.environ["ABFT_CHECK_INTERVAL"] = prev


def _main(params, fmt):
    from .utils.platform import configure_compile_cache

    configure_compile_cache()

    from .backends import create, list_contexts

    if params["list"]:
        list_contexts()
        raise SystemExit(0)

    backend = create(params["target"], params["mode"])

    from .formats import build_protected, load_matrix
    from .inject import inject_bitflips

    try:
        assembled = load_matrix(params["matrix_file"], params["num_blocks"])
    except FileNotFoundError:
        print(f"Failed to open '{params['matrix_file']}'")
        raise SystemExit(1)
    except ValueError as e:
        print(str(e))
        raise SystemExit(1)

    try:
        # --devices N: align the padded row count to the mesh at build
        # time — GSPMD split sharding needs 8 rows per device
        # (parallel.sharded._device_put_sharded).
        ra = None
        if params["devices"] and params["devices"] > 1:
            import math

            ra = math.lcm(8 * params["devices"], 128)  # R pads to 128
        mat = build_protected(params["fmt"], assembled, params["mode"],
                              row_align=ra)
    except ValueError as e:
        print(str(e))
        raise SystemExit(1)

    N, nnz = mat.N, mat.nnz
    block_size = N // params["num_blocks"]
    print()
    print(f"implementation        = {params['target']}-{params['mode']}")
    print(f"storage format        = {params['fmt']}")
    print(f"matrix size           = {N} x {N}")
    print(f"matrix block size     = {block_size} x {block_size}")
    print(f"number of non-zeros   = {nnz} ({nnz / (float(N) * N) * 100:.4f}%)")
    print(f"maximum iterations    = {params['max_itrs']}")
    print(f"convergence threshold = {params['conv_threshold']:g}")
    print()

    # b ~ U[0,1) (reference: rand()/RAND_MAX, cg.cpp:70 — unseeded glibc
    # rand, i.e. a fixed sequence; we use a fixed-seed PCG64 by default).
    seed = params["seed"]
    b_rng = np.random.default_rng(12345 if seed is None else seed)
    b = b_rng.random(N)

    if params["num_bit_flips"]:
        inj_rng = np.random.default_rng(None if seed is None else seed + 1)
        mat = inject_bitflips(
            mat, params["bitflip_kind"], params["num_bit_flips"], inj_rng
        )

    import contextlib

    if params["profile"]:
        import jax

        profile_cm = jax.profiler.trace(params["profile"])
    else:
        profile_cm = contextlib.nullcontext()

    # --refine's inner solves all target the SAME snapshot path and a
    # --resume would replay round 1's converged state against a
    # DIFFERENT rhs (the f64 residual) — a wrong-result path; nor is a
    # mid-round snapshot a valid recovery point (outer accumulated x
    # isn't captured).  Reject the combination outright.
    if params.get("refine") and params["checkpoint"]:
        print("--refine cannot be combined with --checkpoint/--resume")
        raise SystemExit(1)

    # --checkpoint only reaches backends that implement the segmented
    # runner (jnp/pallas); keeping it out of the kwargs otherwise gives
    # the clean unsupported-option error below for cpu/native.
    extra = {}
    if params["checkpoint"]:
        extra = dict(checkpoint=params["checkpoint"],
                     checkpoint_every=params["checkpoint_every"],
                     resume=params["resume"])

    with profile_cm:
        try:
            if params.get("refine"):
                # Mixed-precision iterative refinement: f32 inner CG
                # solves + binary64 true-residual restarts
                # (backends.base.solve_refined; README dtype guidance).
                res = backend.solve_refined(
                    mat, b, params["max_itrs"], params["conv_threshold"],
                    params["refine"],
                    verbose=not params["quiet"], dtype=params["dtype"],
                    precond=params["precond"], devices=params["devices"],
                    solver=params["solver"], **extra,
                )
            else:
                res = backend.solve(
                    mat, b, params["max_itrs"], params["conv_threshold"],
                    verbose=not params["quiet"], dtype=params["dtype"],
                    precond=params["precond"], devices=params["devices"],
                    solver=params["solver"], reps=params["reps"], **extra,
                )
        except (TypeError, ValueError) as e:
            if (params["devices"] or params["solver"] != "standard"
                    or params["checkpoint"]):
                # Targets without a sharded/segmented path (cpu/native)
                # or meshes bigger than the host: fail loudly,
                # reference-style.
                print(f"options unsupported for target "
                      f"'{params['target']}': {e}")
                raise SystemExit(1)
            raise

    # ABFT event messages print FIRST: injection happens pre-loop, so the
    # reference's detection/correction lines appear at iteration 0, before
    # any residual line (its kernels print mid-SpMV; cg.cpp:97 runs before
    # the rr print at cg.cpp:117).
    for msg in res.messages:
        print(msg)

    # Per-iteration residual lines (reference cg.cpp:116-117), printed
    # from the carried trace: one host callback per iteration would
    # stall the device loop.
    if not params["quiet"] and res.rr_trace is not None:
        # The device-side trace is capped (solver._MAX_TRACE); iterations
        # beyond it ran but were not traced.
        shown = min(res.iterations, len(res.rr_trace))
        for i in range(shown):
            print(f"iteration {i:5d} :  rr = {res.rr_trace[i]:12.4f}")
        if shown < res.iterations:
            print(f"... ({res.iterations - shown} further iterations untraced)")

    if res.failed:
        raise SystemExit(1)

    print()
    print(f"ran for {res.iterations} iterations")
    if res.route:
        print(f"spmv route = {res.route}")
    print(f"\ncompile time = {res.compile_seconds * 1e3:7.2f} ms")
    print(f"\ntime taken = {res.solve_seconds * 1e3:7.2f} ms\n")

    # Verification: r = A@x vs b (reference cg.cpp:127-144).  Correction
    # messages are suppressed here — by this point the reference's matrix
    # was already scrubbed in place, so it would not print them again.
    w, errcode, msgs = backend.spmv_once(mat, res.x, dtype=params["dtype"])
    if errcode != 0:
        for msg in msgs:
            if "corrected" not in msg:
                print(msg)
        raise SystemExit(1)
    err = np.abs(b - w)
    print(f"total error = {np.sqrt(np.sum(err * err)):f}")
    print(f"max error   = {np.max(err):f}")
    print()
    raise SystemExit(0)


def main_csr(argv=None):
    main(argv, fmt="csr")


def main_coo(argv=None):
    main(argv, fmt="coo")


if __name__ == "__main__":
    main()
