"""Checkpoint / resume of HMM state (torch port of ``hommx_tpu/utils/io.py``).

The expensive artifact of an HMM solve is the batch of per-cell homogenized
tensors A*(c_T), the whole micro stage's output; checkpointing it makes a
solve resumable and lets users sweep right-hand sides and BCs without
running the micro stage again.  The ``.npz`` keys and dtypes are the JAX
package's (``A_star`` float64, ``macro_vertices``, ``macro_cells``, ``eps``,
``bs``), so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_hmm_state", "load_hmm_state"]


def save_hmm_state(path: str, hmm) -> None:
    """Dump the homogenized tensors (and the mesh fingerprint) of a BaseHMM
    to ``.npz``; runs the micro stage first if it has not run."""
    A_star = hmm.homogenized_tensors()
    np.savez_compressed(
        path,
        A_star=A_star.detach().cpu().numpy().astype(np.float64),
        macro_vertices=hmm._msh.vertices,
        macro_cells=hmm._msh.cells,
        eps=hmm._eps,
        bs=hmm._V_macro.bs,
    )


def load_hmm_state(path: str, hmm) -> None:
    """Restore homogenized tensors into a compatible BaseHMM, on its device
    and in its dtype: its next ``solve()`` skips the micro stage.

    Raises ``ValueError`` if the macro mesh or the block size does not
    match the checkpoint.
    """
    with np.load(path) as data:
        verts, cells = data["macro_vertices"], data["macro_cells"]
        if (
            verts.shape != hmm._msh.vertices.shape
            or cells.shape != hmm._msh.cells.shape
            or not np.allclose(verts, hmm._msh.vertices)
            or not np.array_equal(cells, hmm._msh.cells)
        ):
            raise ValueError("checkpoint macro mesh does not match this solver")
        if int(data["bs"]) != hmm._V_macro.bs:
            raise ValueError("checkpoint block size does not match this solver")
        A_star = data["A_star"]
    hmm._A_star = torch.as_tensor(A_star).to(device=hmm._device, dtype=hmm._dtype)
