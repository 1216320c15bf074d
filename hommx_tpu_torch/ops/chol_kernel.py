"""K3, the batched SPD factor+solve of the elasticity chunk: the
hand-written CUDA kernel (``csrc/chol_solve.cu``) and its plain PyTorch
version (torch port of ``hommx_tpu/ops/chol_kernel.py::fused_chol_solve``).

For each cell c it solves Ks[c] X = Fs[:, :, c] for all s right-hand sides
with a Cholesky factorization whose pivots are clamped to √max(p, eps) (it
never raises; a non-SPD cell gives finite output), then runs ONE
refinement sweep R = Fs − Ks·X against the original (equilibrated) Ks and
returns X + solve(R).  Layouts are the JAX kernel's: Ks (C, n, n)
batch-major, Fs and X (n, s, C) cell-minor.

Dispatch is by device alone: a CUDA float32 tensor goes to the kernel, a
CPU tensor to :func:`fused_chol_solve_plain`; anything else raises.  The
kernel keeps a whole cell in shared memory, which bounds n
(:func:`max_kernel_n`; 234 at s = 6).  There is no autograd rule yet: the
reference differentiates through ``lax.custom_linear_solve`` (ROADMAP A11).
The TPU-only parts of the reference module (``probe_compile``,
``fused_chol_available`` and the VMEM budget) are not ported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from hommx_tpu_torch._cuda import CudaKernel
from hommx_tpu_torch.ops.batched_chol import _pad_spd, blocked_cho_solve, blocked_cholesky

__all__ = [
    "fused_chol_solve",
    "fused_chol_solve_plain",
    "fused_chol_solve_cuda",
    "kernel_smem_bytes",
    "max_kernel_n",
    "KERNEL",
]

# shared memory a block may opt into on the H100 (sm_90), and the most
# right-hand sides the kernel takes (kMaxRhs in csrc/chol_solve.cu)
_MAX_SMEM = 232448
_MAX_RHS = 8

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    Path(__file__).resolve().parent / "csrc" / "chol_solve.cu",
    {
        # K, F, X, C, n, s, eps, stream
        "hommx_chol_solve_f32": [_vp, _vp, _vp, _i, _i, _i, ctypes.c_float, _vp],
    },
)


def kernel_smem_bytes(n: int, s: int) -> int:
    """Dynamic shared memory of one cell's block: the n×n operator, the
    diagonal of L and two (n, s) right-hand-side arrays, in float32."""
    return 4 * (n * n + n + 2 * n * s)


def max_kernel_n(s: int) -> int:
    """The largest n the kernel takes for s right-hand sides."""
    n = 1
    while kernel_smem_bytes(n + 1, s) <= _MAX_SMEM:
        n += 1
    return n


def fused_chol_solve_plain(Ks, Fs, eps: float = 1e-30, nb: int = 32):
    """Plain version: ``_pad_spd``, ``blocked_cholesky`` and
    ``blocked_cho_solve`` with the same clamped pivots, then the same one
    refinement sweep.  Any device and dtype."""
    # the padding is decoupled identity rows with zero right-hand sides, so
    # X and the residual vanish there and the sweep against the padded
    # operator is the sweep against Ks
    Kp, Bp, n = _pad_spd(Ks, Fs.permute(2, 0, 1), nb)  # (C, n_pad, s)
    panels, dinvs = blocked_cholesky(Kp, nb, eps)
    X = blocked_cho_solve(panels, dinvs, Bp, nb)
    X = X + blocked_cho_solve(panels, dinvs, Bp - Kp @ X, nb)
    return X[:, :n].permute(1, 2, 0)


def fused_chol_solve_cuda(Ks, Fs, eps: float = 1e-30):
    """Launch the CUDA kernel: Ks (C, n, n) and Fs (n, s, C), float32 on
    one CUDA device; returns X (n, s, C)."""
    C, n, n2 = Ks.shape
    s = Fs.shape[1]
    if not (Fs.is_cuda and Ks.device == Fs.device):
        raise TypeError("fused_chol_solve_cuda takes CUDA tensors on one device")
    if Ks.dtype != torch.float32 or Fs.dtype != torch.float32:
        raise TypeError(
            "fused_chol_solve_cuda takes float32 tensors: the kernel has no "
            "float64 version (ROADMAP C); use dtype=torch.float32 on CUDA"
        )
    if n2 != n or Fs.shape != (n, s, C) or not 1 <= s <= _MAX_RHS or C < 1:
        raise ValueError(f"fused_chol_solve_cuda: bad shapes {tuple(Ks.shape)}, {tuple(Fs.shape)}")
    if kernel_smem_bytes(n, s) > _MAX_SMEM:
        raise ValueError(
            f"fused_chol_solve_cuda: n = {n} exceeds the kernel's shared-memory "
            f"bound (n <= {max_kernel_n(s)} at s = {s})"
        )
    Kc = Ks.contiguous()
    Fc = Fs.contiguous()
    X = torch.empty((n, s, C), dtype=torch.float32, device=Fs.device)
    KERNEL.launch(
        "hommx_chol_solve_f32", Fs.device.index,
        Kc.data_ptr(), Fc.data_ptr(), X.data_ptr(), C, n, s, float(eps),
    )
    return X


def fused_chol_solve(Ks, Fs, eps: float = 1e-30):
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if Fs.is_cuda:
        return fused_chol_solve_cuda(Ks, Fs, eps)
    if Fs.device.type == "cpu":
        return fused_chol_solve_plain(Ks, Fs, eps)
    raise TypeError(f"fused_chol_solve: unsupported device {Fs.device}")
