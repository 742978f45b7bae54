#!/usr/bin/env python
"""Generate the bundled test matrix (shallow_water1 stand-in).

The reference downloads shallow_water1.mtx (N=81,920, ~4 nnz/row) from the
UFL sparse collection (reference matrices/Makefile:7-11); that URL is dead,
so — like the measured baseline in BASELINE.md — we generate a synthetic
SPD stand-in at the same scale and path the CLI defaults to.

Usage: python matrices/make_matrix.py [--kind tri|lap2d] [--n N] [--out PATH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from abft_sparse_cg.utils.matgen import (  # noqa: E402
    spd_laplacian_2d,
    spd_tridiagonal,
    write_mm_triangle,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["tri", "lap2d"], default="tri")
    ap.add_argument("--n", type=int, default=81920,
                    help="matrix dimension (lap2d rounds to a square)")
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "shallow_water1",
            "shallow_water1.mtx",
        ),
    )
    args = ap.parse_args()

    if args.kind == "tri":
        rows, cols, vals, n = spd_tridiagonal(args.n)
    else:
        side = max(1, int(round(args.n ** 0.5)))
        rows, cols, vals, n = spd_laplacian_2d(side)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    write_mm_triangle(args.out, rows, cols, vals, n)
    print(f"wrote {args.out}: N={n}, stored entries={len(rows)} ({args.kind})")


if __name__ == "__main__":
    main()
