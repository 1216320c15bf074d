"""Work of K3, the chunk Cholesky solve (``chol_solve_large_kernel``), counted
from what its inputs need, whatever implements it: C cells, each a dense
symmetric positive definite (n, n) system with s right-hand sides.

- operations: C·(n³/3 + 6·n²·s), the factorization, and the two
  triangular solves twice over with the residual between them (the one
  refinement sweep that float32 at these condition numbers needs);
- bytes: each K and F read once and each X written once, float32.
"""

from __future__ import annotations

__all__ = ["flops", "bytes_moved", "bound_seconds"]


def flops(cells: int, n: int, s: int) -> float:
    return cells * (n**3 / 3.0 + 6.0 * n * n * s)


def bytes_moved(cells: int, n: int, s: int, itemsize: int = 4) -> float:
    return cells * itemsize * (n * n + 2.0 * n * s)


def bound_seconds(cells: int, n: int, s: int, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes at the HBM rate."""
    return max(flops(cells, n, s) / peaks["float32_flop_per_s"],
               bytes_moved(cells, n, s) / peaks["hbm_byte_per_s"])
