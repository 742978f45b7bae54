"""Conversions between float64 bit-planes and compute dtypes.

Matrix element values are *stored* as the two 32-bit halves of their IEEE
binary64 representation (so ECC covers the exact bits the reference
protects), but *computed* in a configurable dtype:

  - float64 (``--dtype f64``, and the CPU default): a bitcast of the
    reassembled 64-bit word,
  - float32 (the accelerator default), reconstructed from the binary64
    planes with pure integer ops + a u32->f32 bitcast.

The f64->f32 reconstruction truncates the mantissa (round-toward-zero) and
saturates overflowing exponents to +/-inf, underflowing ones to 0 — enough
to mirror the reference's behaviour for both clean matrices (values far
inside f32 range) and corrupted ones (a flipped exponent bit must still
poison the solve the way the reference's double would).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "f64_to_planes",
    "planes_to_f64_np",
    "planes_to_f32",
    "planes_to_value",
]


def f64_to_planes(values: np.ndarray):
    """Split float64 values into (lo, hi) uint32 planes. Host-side NumPy."""
    bits = np.ascontiguousarray(values, dtype=np.float64).view(np.uint64)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (bits >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def planes_to_f64_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Reassemble float64 values from planes. Host-side NumPy."""
    bits = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return bits.view(np.float64)


def planes_to_f32(lo, hi):
    """Reconstruct float32 from binary64 planes with integer ops (jnp).

    Only uint32 arithmetic plus one u32->f32 bitcast.
    """
    import jax
    import jax.numpy as jnp

    u = np.uint32
    sign = hi >> u(31)
    exp11 = (hi >> u(20)) & u(0x7FF)
    # Top 23 mantissa bits of the 52-bit binary64 mantissa (truncating).
    mant23 = ((hi & u(0xFFFFF)) << u(3)) | (lo >> u(29))

    # Re-bias exponent: binary64 bias 1023 -> binary32 bias 127.
    exp_unb = exp11.astype(jnp.int32) - 1023
    exp8 = exp_unb + 127

    is_zero_or_denorm = exp11 == u(0)
    is_naninf = exp11 == u(0x7FF)
    overflow = exp8 >= 255
    underflow = exp8 <= 0  # f64 normals below f32 range: flush to zero

    exp_field = jnp.clip(exp8, 1, 254).astype(jnp.uint32)
    f32_bits = (sign << u(31)) | (exp_field << u(23)) | mant23

    inf_bits = (sign << u(31)) | u(0x7F800000)
    nan_bits = (sign << u(31)) | u(0x7F800000) | jnp.where(mant23 == u(0),
                                                           u(1), mant23)
    zero_bits = sign << u(31)

    f32_bits = jnp.where(overflow, inf_bits, f32_bits)
    f32_bits = jnp.where(underflow, zero_bits, f32_bits)
    f32_bits = jnp.where(is_zero_or_denorm, zero_bits, f32_bits)
    f32_bits = jnp.where(is_naninf & (mant23 == 0), inf_bits, f32_bits)
    is_nan = is_naninf & ((mant23 != 0) | ((lo & u(0x1FFFFFFF)) != 0))
    f32_bits = jnp.where(is_nan, nan_bits, f32_bits)

    return jax.lax.bitcast_convert_type(f32_bits.astype(jnp.uint32), jnp.float32)


def planes_to_value(lo, hi, dtype):
    """Reconstruct values from planes in the requested compute dtype (jnp)."""
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(dtype)
    if dtype == jnp.float32:
        return planes_to_f32(lo, hi)
    if dtype == jnp.float64:
        bits = lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << np.uint64(32))
        return jax.lax.bitcast_convert_type(bits, jnp.float64)
    raise ValueError(f"unsupported compute dtype: {dtype}")
