"""Software-ECC (ABFT) core: codeword layouts, masks, encode/check/correct.

A data-parallel re-design of the reference's ECC headers (reference COO/ecc.h,
CSR/ecc.h): plane-of-uint32 storage, vectorized mask math, functional
correction.  See `layout` and `codec` for details.
"""

from .layout import (
    COO128,
    CSR96,
    CodewordLayout,
    ECC_COL_MASK,
    NUM_PARITY_BITS,
    OVERALL_PARITY_BIT,
    SED_PARITY_BIT,
)
from .codec import (
    ECC_MODES,
    MODES,
    check_and_correct,
    decode_flipped_bit,
    encode,
    flip_bits,
    overall_parity,
    syndrome,
)
from .values import f64_to_planes, planes_to_f32, planes_to_f64_np, planes_to_value

__all__ = [
    "COO128",
    "CSR96",
    "CodewordLayout",
    "ECC_COL_MASK",
    "NUM_PARITY_BITS",
    "OVERALL_PARITY_BIT",
    "SED_PARITY_BIT",
    "ECC_MODES",
    "MODES",
    "check_and_correct",
    "decode_flipped_bit",
    "encode",
    "flip_bits",
    "overall_parity",
    "syndrome",
    "f64_to_planes",
    "planes_to_f32",
    "planes_to_f64_np",
    "planes_to_value",
]
