"""ELL sparse matrices (torch port of ``hommx_tpu/ops/sparse.py``).

The sparsity pattern is built once on the host from the cell dofmap
(numpy); SpMV is one gather, a multiply and a row sum on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ELLPattern", "build_ell_pattern", "spmv", "ell_to_dense"]


@dataclasses.dataclass(frozen=True)
class ELLPattern:
    """Static sparsity pattern for assembling P1 stiffness matrices.

    Attributes:
        num_dofs: matrix size N.
        row_width: padded entries per row K.
        cols: (N, K) int32 column index per slot (padding slots point at 0;
            their values stay 0 so they never contribute).
        slots: (num_cells, nb, nb) int32 flat index into the (N*K,) value
            array for each element-matrix entry.
        diag_slots: (N,) int32 flat slot of each diagonal entry.
    """

    num_dofs: int
    row_width: int
    cols: np.ndarray
    slots: np.ndarray
    diag_slots: np.ndarray


def build_ell_pattern(cell_dofs: np.ndarray, num_dofs: int) -> ELLPattern:
    """Host-side pattern construction from the (num_cells, nb) dofmap."""
    nc, nb = cell_dofs.shape
    rows = np.repeat(cell_dofs, nb, axis=1).reshape(-1)
    cols = np.tile(cell_dofs, (1, nb)).reshape(-1)
    keys = rows.astype(np.int64) * num_dofs + cols
    uniq, inverse = np.unique(keys, return_inverse=True)
    urows = (uniq // num_dofs).astype(np.int64)
    ucols = (uniq % num_dofs).astype(np.int64)
    counts = np.bincount(urows, minlength=num_dofs)
    K = int(counts.max())
    # position of each unique pair within its row (uniq is sorted row-major)
    row_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_row = np.arange(uniq.shape[0]) - row_starts[urows]
    pair_slot = (urows * K + pos_in_row).astype(np.int64)

    cols_arr = np.zeros((num_dofs, K), dtype=np.int32)
    cols_arr.reshape(-1)[pair_slot] = ucols
    slots = pair_slot[inverse.reshape(-1)].reshape(nc, nb, nb).astype(np.int32)

    diag_mask = urows == ucols
    diag_slots = np.zeros(num_dofs, dtype=np.int64)
    diag_slots[urows[diag_mask]] = pair_slot[diag_mask]
    return ELLPattern(num_dofs, K, cols_arr, slots, diag_slots.astype(np.int32))


def spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL values (N*K,) or (N, K) and column indices (N, K)."""
    N, K = cols.shape
    return (vals.reshape(N, K) * x[cols]).sum(dim=1)


def ell_to_dense(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Materialize the ELL matrix as dense (N, N) (small macro systems)."""
    N, K = cols.shape
    rows = torch.arange(N, device=cols.device)[:, None].expand(N, K)
    dense = torch.zeros((N, N), dtype=vals.dtype, device=vals.device)
    return dense.index_put_((rows, cols.long()), vals.reshape(N, K), accumulate=True)
