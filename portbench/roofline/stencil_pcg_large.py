"""Work of K1's large instance (``stencil_pcg_large_kernel``): the chunk PCG
of C scalar cells on the periodic stencil, n unknowns and s right-hand sides
a cell, K stencil offsets, the shared dense (n, n) preconditioner.

The iterations are those that K1's algorithm takes: the reference's
lockstep stop per block of ``cells_per_block`` cells (ROADMAP C, "K1 stops
per block"), read from the counts the kernel writes.  A change to what a
block is therefore changes the count, and needs a change of the benchmark
first.

- operations: Σ over blocks c_b·((it_b + 2)·2n²s + (it_b + 1)·2Kns), c_b
  the block's real cells and it_b its iterations: it_b + 2 products with
  the preconditioner (the first iterate, its residual, one an iteration)
  and it_b + 1 stencil products;
- bytes: 4·(KnC + 2nsC + n²) a launch: the weights and loads read once, X
  written once, the preconditioner read once, float32.
"""

from __future__ import annotations

__all__ = ["flops", "bytes_moved", "bound_seconds"]


def flops(n: int, s: int, K: int, cells: int, cells_per_block: int, iters) -> float:
    """Operations of one launch whose blocks took ``iters`` iterations."""
    return sum(min(cells_per_block, cells - b * cells_per_block)
               * ((it + 2) * 2.0 * n * n * s + (it + 1) * 2.0 * K * n * s)
               for b, it in enumerate(iters))


def bytes_moved(n: int, s: int, K: int, cells: int, itemsize: int = 4) -> float:
    return itemsize * (K * n * cells + 2.0 * n * s * cells + n * n)


def bound_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take for one launch: the larger of its
    operations at the float32 peak and its bytes at the HBM rate."""
    return max(ops / peaks["float32_flop_per_s"], nbytes / peaks["hbm_byte_per_s"])
