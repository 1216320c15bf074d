"""Debug converters (torch port of ``hommx_tpu/utils/debug.py``; the
reference's ``petsc_helper.py`` turns PETSc matrices and vectors into dense
numpy for test comparisons, ``petsc_helper.py:8-24``).  Here the sparse
objects are ELL and DIA arrays and Functions; every converter returns a
numpy array on the host, from tensors on the card too.
"""

from __future__ import annotations

import numpy as np
import torch

from hommx_tpu_torch.ops.sparse import ell_to_dense

__all__ = ["ell_matrix_to_numpy", "dia_matrix_to_numpy", "vector_to_numpy"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ell_matrix_to_numpy(vals, cols) -> np.ndarray:
    """Dense numpy matrix from ELL storage (reference
    ``petsc_matrix_to_numpy``)."""
    return _host(ell_to_dense(torch.as_tensor(vals), torch.as_tensor(cols)))


def dia_matrix_to_numpy(dia_vals, offsets) -> np.ndarray:
    """Dense numpy matrix from DIA storage: ``dia_vals[d, i]`` is the entry
    (i, i + offsets[d])."""
    dv = _host(dia_vals)
    nd, N = dv.shape
    out = np.zeros((N, N), dtype=dv.dtype)
    rows = np.arange(N)
    for d, off in enumerate(np.asarray(offsets).tolist()):
        r = rows[max(0, -off) : min(N, N - off)]
        out[r, r + off] = dv[d, r]
    return out


def vector_to_numpy(vec) -> np.ndarray:
    """Numpy copy of a Function's dof vector or of an array (reference
    ``petsc_vector_to_numpy``)."""
    arr = vec.array if hasattr(vec, "array") else vec
    return np.array(_host(arr), copy=True)
