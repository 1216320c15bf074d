"""Fused chunk-PCG for the periodic-stencil micro path: the hand-written
CUDA kernel (``csrc/stencil_pcg.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``hommx_tpu/micro/stencil_pcg.py::_pcg_kernel``
(called through ``stencil_pcg_pallas``).  One launch solves the
(pre-scaled) stencil systems K X = F of a whole chunk of cells: every block
of cells runs the complete lockstep block-PCG — per-column breakdown guard,
converged-column freeze, best-iterate tracking with a 1−1e-4 shrink, a
stall cap of 60, and a stop on the block's max relative residual — inside
the kernel, with no host round trip per iteration.  The returned iteration
count is the max over blocks, as on the TPU.

Dispatch is by device alone: a CUDA tensor goes to the kernel, a CPU
tensor to :func:`stencil_pcg_plain`.  The kernel is float32 only, as on the
TPU; a float64 CUDA tensor raises (no float64 kernel yet, ROADMAP C).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from hommx_tpu_torch._cuda import CudaKernel
from hommx_tpu_torch.micro.krylov import _chunk_pcg_raw, shared_prec
from hommx_tpu_torch.micro.stencil import torus_matvec

__all__ = ["stencil_pcg", "stencil_pcg_plain", "stencil_pcg_cuda", "KERNEL", "CELLS_PER_BLOCK"]

# cells per thread block; must equal CB in csrc/stencil_pcg.cu
CELLS_PER_BLOCK = 16

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    Path(__file__).resolve().parent / "csrc" / "stencil_pcg.cu",
    {
        # ws, F, Minv, nbr, work, X_out, iters, K, n, s, Cp, tol, maxiter, stream
        "hommx_stencil_pcg_f32": [
            _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, ctypes.c_float, _i, _vp,
        ],
    },
)


def stencil_pcg_plain(ws, F, Minv, shape, offsets, tol, maxiter):
    """Plain PyTorch version: ``_chunk_pcg_raw`` on the stencil operator
    Σ_k w_k ⊙ roll(P, −Δ_k) with the shared preconditioner Minv.

    Args:
        ws: list of K (n, C) weight tensors (scaling already folded in).
        F: (n, s, C) right-hand sides.
        Minv: (n, n) shared dense preconditioner.
        shape: torus grid dims (prod = n).
        offsets: (K, dim) periodic offsets.
        tol, maxiter: as in ``_chunk_pcg_raw``.
    Returns (bX (n, s, C) best iterate — UNCLAMPED, iterations).
    """
    return _chunk_pcg_raw(
        lambda P: torus_matvec(shape, offsets, ws, P),
        lambda R: shared_prec(Minv, R),
        F, tol, maxiter,
    )


@functools.lru_cache(maxsize=16)
def _neighbour_table(shape: tuple, offsets: tuple, device: str) -> torch.Tensor:
    """(K, n) int32: nbr[k, p] = raster index of grid(p) + Δ_k (mod shape),
    i.e. roll(P, −Δ_k)[p] = P[nbr[k, p]]."""
    n = int(np.prod(shape))
    coords = np.stack(np.unravel_index(np.arange(n), shape), axis=1)
    tab = np.stack(
        [
            np.ravel_multi_index(((coords + np.asarray(off)) % np.asarray(shape)).T, shape)
            for off in offsets
        ]
    ).astype(np.int32)
    return torch.as_tensor(tab, device=device)


def stencil_pcg_cuda(ws, F, Minv, shape, offsets, tol, maxiter):
    """Launch the CUDA kernel; same contract as :func:`stencil_pcg_plain`
    (the iteration count comes back as a 0-d int32 CUDA tensor)."""
    n, s, C = F.shape
    K = len(ws)
    dev = F.device
    for t in (*ws, F, Minv):
        if not t.is_cuda or t.device != dev:
            raise TypeError("stencil_pcg_cuda takes tensors on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(
                "stencil_pcg_cuda takes float32 tensors: the kernel has no "
                "float64 version yet (ROADMAP C); use dtype=torch.float32 on CUDA"
            )
    if Minv.shape != (n, n) or any(w.shape != (n, C) for w in ws) or s > 3:
        raise ValueError("stencil_pcg_cuda: bad shapes")
    Cb = CELLS_PER_BLOCK
    pad = (-C) % Cb
    Cp = C + pad
    Wk = torch.stack(ws, dim=0)  # (K, n, C)
    Ff = F.permute(1, 0, 2)  # (s, n, C)
    if pad:
        # padded columns solve a unit-weight system with zero RHS: X = 0
        # from the first prec apply; their relative residual is 0
        Wk = torch.nn.functional.pad(Wk, (0, pad), value=1.0)
        Ff = torch.nn.functional.pad(Ff, (0, pad))
    Wk = Wk.contiguous()
    Ff = Ff.contiguous()
    Mc = Minv.contiguous()
    nbr = _neighbour_table(
        tuple(int(x) for x in shape),
        tuple(tuple(int(o) for o in off) for off in offsets),
        str(dev),
    )
    nblk = Cp // Cb
    work = torch.empty((4, s, n, Cp), dtype=torch.float32, device=dev)  # X P Z KP
    X = torch.empty((s, n, Cp), dtype=torch.float32, device=dev)
    iters = torch.empty((nblk,), dtype=torch.int32, device=dev)
    KERNEL.launch(
        "hommx_stencil_pcg_f32", dev.index,
        Wk.data_ptr(), Ff.data_ptr(), Mc.data_ptr(), nbr.data_ptr(),
        work.data_ptr(), X.data_ptr(), iters.data_ptr(),
        K, n, s, Cp, float(tol), int(maxiter),
    )
    return X[:, :, :C].permute(1, 0, 2), iters.max()


def stencil_pcg(ws, F, Minv, shape, offsets, tol, maxiter):
    """The fused stencil chunk-PCG: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if F.is_cuda:
        return stencil_pcg_cuda(ws, F, Minv, shape, offsets, tol, maxiter)
    if F.device.type == "cpu":
        return stencil_pcg_plain(ws, F, Minv, shape, offsets, tol, maxiter)
    raise TypeError(f"stencil_pcg: unsupported device {F.device}")
