"""abft_sparse_cg — ABFT-protected sparse CG framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
DataIntensive-HPC/abft-sparse-cg: a conjugate-gradient solver over sparse
symmetric matrices whose elements are protected by software ECC (parity /
Hamming bits packed into the unused high byte of each 32-bit column
index), with fault injection, detection and in-flight correction fused
into the SpMV compute path.

Subpackages:
  ecc       codeword layouts, mask generation, encode/check/correct
  formats   Matrix Market I/O, loader pipeline, COO/CSR/ELL containers
  ops       SpMV (per target x mode) and fused BLAS-1 kernels
  solver    the CG iteration as a jitted lax.while_loop
  parallel  mesh-sharded (multi-device) solver via GSPMD
  backends  (target, mode) registry — the CLI's extensibility point
  utils     synthetic matrix generation, timing helpers
"""

__version__ = "0.1.0"
