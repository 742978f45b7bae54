"""The `cpu` target: native C++/OpenMP backend via ctypes.

The host-performance tier and the drop-in analogue of the reference's
cpu context (same target name, so harness invocations written for the
reference work unchanged).  The shared library (native/libabft_cg.so) is
built on demand with make/g++; if no toolchain is available this module
raises ImportError and the target is simply not registered.

Unlike the jnp/pallas targets this backend has the reference's
*write-back* correction semantics: SEC corrections scrub the caller's
planes in place (native/abft_cg.cpp).
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import time

import numpy as np

from ..formats.protected import ProtectedMatrix
from . import registry
from .base import Backend, HostResult

__all__ = ["CppBackend", "load_library"]

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libabft_cg.so")


class _CgResult(ct.Structure):
    _fields_ = [
        ("errcode", ct.c_int),
        ("err_index", ct.c_int64),
        ("corrected_count", ct.c_int64),
        ("first_cor_index", ct.c_int64),
        ("first_cor_bit", ct.c_int),
        ("iterations", ct.c_int),
        ("rr", ct.c_double),
        ("solve_ms", ct.c_double),
    ]


def _build():
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True, capture_output=True, timeout=120,
        )
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        raise ImportError(f"cannot build native backend: {e}")


_LIB = None


def load_library():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO_PATH) or (
        os.path.getmtime(_SO_PATH)
        < os.path.getmtime(os.path.join(_NATIVE_DIR, "abft_cg.cpp"))
    ):
        _build()
    lib = ct.CDLL(_SO_PATH)
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.abft_cg_solve.restype = ct.c_int
    lib.abft_cg_solve.argtypes = [
        ct.c_char_p, ct.c_char_p,
        u32p, u32p, u32p, ct.c_void_p,
        ct.c_void_p, ct.c_int64, ct.c_int64,
        f64p, ct.c_void_p, ct.c_void_p, f64p, ct.c_void_p,
        ct.c_int, ct.c_double, ct.c_int,
        ct.POINTER(_CgResult),
    ]
    lib.abft_spmv.restype = ct.c_int
    lib.abft_spmv.argtypes = [
        ct.c_char_p, ct.c_char_p,
        u32p, u32p, u32p, ct.c_void_p,
        ct.c_void_p, ct.c_int64, ct.c_int64,
        f64p, f64p,
        ct.POINTER(_CgResult),
    ]
    _LIB = lib
    return lib


def _plane_args(mat: ProtectedMatrix):
    """Planes in C-ABI order + row_ptr, as real copies — the native
    kernels write corrections back (reference scrub semantics), and that
    must not mutate the caller's ProtectedMatrix behind its derived
    exec-layout/checksum state."""
    planes = {k: v.copy() for k, v in mat.planes.items()}
    if mat.fmt == "csr":
        w = [planes["value_lo"], planes["value_hi"], planes["col"]]
        w3 = None
        row_ptr = np.ascontiguousarray(mat.row_ptr, dtype=np.int64)
    else:
        w = [planes["col"], planes["row"], planes["value_lo"]]
        w3 = planes["value_hi"]
        row_ptr = None
    return w, w3, row_ptr


def _msgs(mat, res):
    from ..ecc import OVERALL_PARITY_BIT

    # The C backend reports canonical indices directly — no slot mapping.
    msgs = []
    opb = mat.layout.col_word * 32 + OVERALL_PARITY_BIT
    if res.first_cor_index >= 0:
        if res.first_cor_bit == opb:
            msgs.append(
                f"[ECC] corrected overall parity bit at index {res.first_cor_index}"
            )
        else:
            msgs.append(
                f"[ECC] corrected bit {res.first_cor_bit} at index {res.first_cor_index}"
            )
    from ..ops.spmv import ERRCODES, ERR_DOUBLE

    if res.errcode != 0:
        t = ERRCODES[mat.fmt][res.errcode]
        msgs.append(t if res.errcode == ERR_DOUBLE else t.format(index=res.err_index))
    return msgs


class CppBackend(Backend):
    target = "cpu"

    def __init__(self, mode: str):
        self.mode = mode
        self.lib = load_library()

    def solve(self, mat, b, max_itrs, conv_threshold, verbose=True,
              dtype="auto", precond="none", devices: int = 0,
              solver: str = "standard", reps: int = 0) -> HostResult:
        # Native host timing synchronizes, so a single run is exact;
        # reps only matters to the device targets.
        if devices and devices > 1:
            raise ValueError(
                "the native cpu target is single-node (OpenMP threads); "
                "use -t jnp for a mesh-sharded solve"
            )
        if solver != "standard":
            raise ValueError(
                "the native cpu target implements the standard CG loop; "
                "use -t jnp/pallas for --solver pipelined"
            )
        from .jnp_backend import warn_live_schedule

        warn_live_schedule(self.target)
        w, w3, row_ptr = _plane_args(mat)
        x = np.zeros(mat.N, dtype=np.float64)
        trace = np.full(max_itrs, np.nan)
        res = _CgResult()
        b = np.ascontiguousarray(b, dtype=np.float64)
        minv = None
        if precond == "jacobi":
            d = mat.diagonal()
            minv = np.ascontiguousarray(
                np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 1.0))
        elif precond != "none":
            raise ValueError(f"unknown preconditioner: {precond!r}")
        t0 = time.perf_counter()
        self.lib.abft_cg_solve(
            mat.fmt.encode(), self.mode.encode(),
            w[0], w[1], w[2],
            w3.ctypes.data_as(ct.c_void_p) if w3 is not None else None,
            row_ptr.ctypes.data_as(ct.c_void_p) if row_ptr is not None else None,
            mat.N, mat.nnz, b,
            minv.ctypes.data_as(ct.c_void_p) if minv is not None else None,
            np.ascontiguousarray(mat.flat_cksum).ctypes.data_as(ct.c_void_p)
            if mat.flat_cksum is not None else None,
            x,
            trace.ctypes.data_as(ct.c_void_p),
            max_itrs, conv_threshold, 1 if verbose else 0, ct.byref(res),
        )
        dt = time.perf_counter() - t0
        msgs = _msgs(mat, res)
        if verbose:
            # Live mode already streamed the rr lines and the correction
            # event from the solve loop (reference byte order); only
            # detection/fail-stop messages remain for the driver.
            msgs = [m for m in msgs if not m.startswith("[ECC] corrected")]
        return HostResult(
            x=x,
            iterations=res.iterations,
            rr=res.rr,
            errcode=res.errcode,
            err_index=res.err_index,
            corrected_count=res.corrected_count,
            corrected_index=res.first_cor_index,
            corrected_bit=res.first_cor_bit,
            messages=msgs,
            solve_seconds=res.solve_ms / 1e3 if res.solve_ms else dt,
            compile_seconds=0.0,
            rr_trace=None if verbose else trace,
            route="native",
        )

    def spmv_once(self, mat, x, dtype="auto"):
        w, w3, row_ptr = _plane_args(mat)
        y = np.zeros(mat.N, dtype=np.float64)
        res = _CgResult()
        x = np.ascontiguousarray(x, dtype=np.float64)
        self.lib.abft_spmv(
            mat.fmt.encode(), self.mode.encode(),
            w[0], w[1], w[2],
            w3.ctypes.data_as(ct.c_void_p) if w3 is not None else None,
            row_ptr.ctypes.data_as(ct.c_void_p) if row_ptr is not None else None,
            mat.N, mat.nnz, x, y, ct.byref(res),
        )
        return y, res.errcode, _msgs(mat, res)


def _register():
    from ..ecc.codec import MODES

    load_library()  # raises ImportError if unbuildable -> not registered
    for mode in MODES:
        registry.register("cpu", mode, lambda m=mode: CppBackend(m))


_register()
