"""Fused chunk-PCG for the periodic-stencil micro path: the hand-written
CUDA kernel (``csrc/stencil_pcg.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``hommx_tpu/micro/stencil_pcg.py::_pcg_kernel``
(called through ``stencil_pcg_pallas``).  One launch solves the
(pre-scaled) stencil systems K X = F of a whole chunk of cells: every block
of cells runs the complete lockstep block-PCG — per-column breakdown guard,
converged-column freeze, best-iterate tracking with a 1−1e-4 shrink, a
stall cap of 60, and a stop on the block's max relative residual — inside
the kernel, with no host round trip per iteration.  The returned iteration
count is the max over blocks, as on the TPU.  The block size and the rest
of the launch configuration come from :func:`launch_config`; the plain
version with ``block=`` that size computes what the kernel computes.

Dispatch is by device alone: a CUDA tensor goes to the kernel, a CPU
tensor to :func:`stencil_pcg_plain`.  The kernel is float32 only, as on the
TPU; a float64 CUDA tensor raises (no float64 kernel yet, ROADMAP C), and
so does a shape above the kernel's limits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from hommx_tpu_torch._cuda import CudaKernel
from hommx_tpu_torch.micro.krylov import _chunk_pcg_raw, shared_prec
from hommx_tpu_torch.micro.stencil import torus_matvec

__all__ = [
    "stencil_pcg",
    "stencil_pcg_plain",
    "stencil_pcg_cuda",
    "launch_config",
    "K1Config",
    "KERNEL",
]

# the kernel's constants (csrc/stencil_pcg.cu); the launcher recounts the
# shared memory and refuses a configuration that disagrees
MAX_S = 3  # right-hand sides per cell
SLAB_COLS = 16  # BK: Minv columns per k-slab
SLAB_ROW = SLAB_COLS + 4  # BKP: padded slab row, in floats
SLABS = 2  # Minv slab buffers
# dynamic shared memory a block may take: the H100's 227 KB less a margin
# for the kernel's static per-column arrays
SMEM_LIMIT = 232_448 - 2048

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    Path(__file__).resolve().parent / "csrc" / "stencil_pcg.cu",
    {
        # ws, F, Minv, nbr, X_out, iters, K, n, s, Cp, CB, threads, smem,
        # tol, maxiter, stream
        "hommx_stencil_pcg_f32": [
            _vp, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, _i, _i, _i, ctypes.c_float, _i, _vp,
        ],
    },
)


@dataclasses.dataclass(frozen=True)
class K1Config:
    """One launch configuration of the kernel.

    cells_per_block (CB): cells a block solves in lockstep (its stop test
    covers s·CB columns); threads: per block; rows_per_thread (TM): rows of
    the thread's register tile of TM rows × 4 columns; smem_bytes: dynamic
    shared memory, R (n padded to a slab multiple) and P (n) of s·CB
    columns, two Minv slabs and the partial column sums of each warp's
    column groups."""

    cells_per_block: int
    threads: int
    rows_per_thread: int
    smem_bytes: int


def _warp_cols(cg: int) -> int:
    """Column groups (of 4 columns) one warp spans: the largest power of
    two up to 8 that divides the block's ``cg`` groups."""
    return next(w for w in (8, 4, 2, 1) if cg % w == 0)


def _smem_bytes(n: int, s: int, cb: int, threads: int) -> int:
    nc = s * cb
    npad = -(-n // SLAB_COLS) * SLAB_COLS
    wc = _warp_cols(nc // 4)
    return 4 * (npad * nc + n * nc + SLABS * n * SLAB_ROW + (threads // 32) * wc * 2 * 4)


@functools.lru_cache(maxsize=64)
def launch_config(n: int, s: int) -> K1Config:
    """The kernel's launch configuration for n unknowns and s right-hand
    sides per cell (the stencil's K does not enter: weights and neighbour
    table are read from global memory).

    Prefers the most cells per block (each block streams all of Minv on
    every apply, so fewer, wider blocks move less from L2), then the most
    threads.  A warp's 32 lanes hold 32/WC rows
    of WC 4-column groups (``_warp_cols``), so the rows of the block,
    threads/(s·CB/4), are a multiple of 32/WC; a thread holds at most 8
    rows (at most 384 threads with 8).  Raises ValueError,
    naming the limit, where nothing fits."""
    if not 1 <= s <= MAX_S:
        raise ValueError(f"stencil PCG kernel: s = {s} right-hand sides, the kernel takes 1 to {MAX_S}")
    if n < 1:
        raise ValueError(f"stencil PCG kernel: n = {n}")
    for cb in (16, 8, 4):
        cg = s * cb // 4
        for threads in (512, 384, 256, 128):
            if threads % cg or (threads // cg) % (32 // _warp_cols(cg)):
                continue
            rows = -(-n // (threads // cg))
            tm = 1 << max(0, rows - 1).bit_length()
            if tm > 8 or (tm == 8 and threads > 384):
                continue
            smem = _smem_bytes(n, s, cb, threads)
            if smem <= SMEM_LIMIT:
                return K1Config(cb, threads, tm, smem)
    raise ValueError(
        f"stencil PCG kernel: n = {n}, s = {s} exceeds its limits: shared memory "
        f"<= {SMEM_LIMIT} bytes a block (R and P of s·CB columns and two Minv "
        f"slabs of n x {SLAB_ROW} floats, CB >= 4) and 8 rows a thread"
    )


def stencil_pcg_plain(ws, F, Minv, shape, offsets, tol, maxiter, block=None, per_block=False):
    """Plain PyTorch version: ``_chunk_pcg_raw`` on the stencil operator
    Σ_k w_k ⊙ roll(P, −Δ_k) with the shared preconditioner Minv.

    Args:
        ws: list of K (n, C) weight tensors (scaling already folded in).
        F: (n, s, C) right-hand sides.
        Minv: (n, n) shared dense preconditioner.
        shape: torus grid dims (prod = n).
        offsets: (K, dim) periodic offsets.
        tol, maxiter: as in ``_chunk_pcg_raw``.
        block: None solves the chunk in one lockstep loop; a size runs the
            loop on each run of ``block`` cells apart, as the kernel's
            blocks do (its ``launch_config(n, s).cells_per_block``).
        per_block: return the list of per-block counts instead of the max.
    Returns (bX (n, s, C) best iterate — UNCLAMPED, iterations).
    """
    C = F.shape[2]
    block = C if block is None else int(block)
    outs, its = [], []
    for a in range(0, C, block):
        cols = slice(a, min(a + block, C))
        wb = [w[:, cols] for w in ws]
        X, k = _chunk_pcg_raw(
            lambda P, wb=wb: torus_matvec(shape, offsets, wb, P),
            lambda R: shared_prec(Minv, R),
            F[:, :, cols], tol, maxiter,
        )
        outs.append(X)
        its.append(k)
    return torch.cat(outs, dim=2), (its if per_block else max(its))


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte address (the kernel reads float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stencil_pcg_cuda(ws, F, Minv, shape, offsets, tol, maxiter, per_block=False):
    """Launch the CUDA kernel; same contract as :func:`stencil_pcg_plain`
    with ``block=launch_config(n, s).cells_per_block`` (the iteration count
    comes back as a 0-d int32 CUDA tensor, or per block with
    ``per_block``)."""
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
    if Minv.shape != (n, n) or any(w.shape != (n, C) for w in ws) or K < 1:
        raise ValueError("stencil_pcg_cuda: bad shapes")
    cfg = launch_config(n, s)
    Cb = cfg.cells_per_block
    pad = (-C) % Cb
    Cp = C + pad
    Wk = torch.stack(ws, dim=0)  # (K, n, C)
    Ff = F.permute(1, 0, 2)  # (s, n, C)
    if pad:
        # padded columns solve a unit-weight system with zero RHS: X = 0
        # from the first prec apply; their relative residual is 0
        Wk = torch.nn.functional.pad(Wk, (0, pad), value=1.0)
        Ff = torch.nn.functional.pad(Ff, (0, pad))
    Wk, Ff, Mc = _aligned(Wk), _aligned(Ff), _aligned(Minv)
    nbr = _neighbour_table(
        tuple(int(x) for x in shape),
        tuple(tuple(int(o) for o in off) for off in offsets),
        str(dev),
    )
    X = torch.empty((s, n, Cp), dtype=torch.float32, device=dev)
    iters = torch.empty((Cp // Cb,), dtype=torch.int32, device=dev)
    KERNEL.launch(
        "hommx_stencil_pcg_f32", dev.index,
        Wk.data_ptr(), Ff.data_ptr(), Mc.data_ptr(), nbr.data_ptr(),
        X.data_ptr(), iters.data_ptr(),
        K, n, s, Cp, Cb, cfg.threads, cfg.smem_bytes, float(tol), int(maxiter),
    )
    return X[:, :, :C].permute(1, 0, 2), (iters if per_block else iters.max())


def stencil_pcg(ws, F, Minv, shape, offsets, tol, maxiter):
    """The fused stencil chunk-PCG: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if F.is_cuda:
        return stencil_pcg_cuda(ws, F, Minv, shape, offsets, tol, maxiter)
    if F.device.type == "cpu":
        return stencil_pcg_plain(ws, F, Minv, shape, offsets, tol, maxiter)
    raise TypeError(f"stencil_pcg: unsupported device {F.device}")
