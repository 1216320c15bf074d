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
kernel keeps a cell's lower 32 × 32 tiles in shared memory; its launch
configuration comes from :func:`chol_launch_config`, which bounds n
(:func:`max_kernel_n`; 288 at s ≤ 8).  There is no autograd rule yet: the
reference differentiates through ``lax.custom_linear_solve`` (ROADMAP A11).
The TPU-only parts of the reference module (``probe_compile``,
``fused_chol_available`` and the VMEM budget) are not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from hommx_tpu_torch._cuda import CudaKernel
from hommx_tpu_torch.ops.batched_chol import _pad_spd, blocked_cho_solve, blocked_cholesky

__all__ = [
    "fused_chol_solve",
    "fused_chol_solve_plain",
    "fused_chol_solve_cuda",
    "chol_launch_config",
    "K3Config",
    "blocks_per_sm",
    "kernel_smem_bytes",
    "max_kernel_n",
    "KERNEL",
]

# the kernel's constants (csrc/chol_solve.cu); the launcher recounts the
# shared memory and refuses a configuration that disagrees
NB = 32  # panel width and tile side
THREADS = 256
MAX_RHS = 8  # one warp per right-hand side in the substitutions
MAX_PANELS = 9
# shared memory a block may opt into on the H100 (sm_90), and what one SM
# holds for all its blocks, each of which reserves 1 KB more
SMEM_LIMIT = 232_448
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
MAX_BLOCKS_PER_SM = 2  # __launch_bounds__(256, 2)

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    Path(__file__).resolve().parent / "csrc" / "chol_solve.cu",
    {
        # K, F, X, C, n, s, eps, threads, P, tile_stride, smem, stream
        "hommx_chol_solve_f32": [_vp, _vp, _vp, _i, _i, _i, ctypes.c_float, _i, _i, _i, _i, _vp],
        # smem, out: resident blocks per SM (not a launch)
        "hommx_chol_blocks_per_sm": [_i, ctypes.POINTER(ctypes.c_int)],
    },
)


@dataclasses.dataclass(frozen=True)
class K3Config:
    """The kernel's launch configuration for one (n, s).

    threads: per block (one block per cell); panels (P): ⌈n/32⌉, the padded
    operator's 32-wide panels; tile_stride: floats between consecutive
    columns of a stored 32 × 32 tile; smem_bytes: dynamic shared memory
    (:func:`kernel_smem_bytes`);
    blocks_per_sm: cells resident on one SM by shared memory and the
    kernel's launch bounds."""

    threads: int
    panels: int
    tile_stride: int
    smem_bytes: int
    blocks_per_sm: int


def kernel_smem_bytes(n: int, s: int) -> int:
    """Dynamic shared memory of one cell's block, in bytes (float32): the
    packed lower tiles of the padded operator and two (32·P, s)
    right-hand-side arrays.  Defined for any n; :func:`chol_launch_config`
    holds it to the limit."""
    P = -(-n // NB)
    return 4 * (P * (P + 1) // 2 * NB * NB + 2 * P * NB * s)


@functools.lru_cache(maxsize=64)
def chol_launch_config(n: int, s: int) -> K3Config:
    """The kernel's launch configuration for n unknowns and s right-hand
    sides per cell.  Raises ValueError, naming the limit, where the cell
    does not fit one block's shared memory or s is out of range."""
    if not 1 <= s <= MAX_RHS:
        raise ValueError(f"Cholesky kernel: s = {s} right-hand sides, the kernel takes 1 to {MAX_RHS}")
    if n < 1:
        raise ValueError(f"Cholesky kernel: n = {n}")
    smem = kernel_smem_bytes(n, s)
    if smem > SMEM_LIMIT or -(-n // NB) > MAX_PANELS:
        raise ValueError(
            f"Cholesky kernel: n = {n} exceeds its shared-memory limit n <= "
            f"{max_kernel_n(s)} at s = {s} ({SMEM_LIMIT} bytes a block: the lower "
            f"32 x 32 tiles of the padded operator and two (n_pad, s) arrays)"
        )
    blocks = min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVED))
    return K3Config(THREADS, -(-n // NB), NB, smem, blocks)


def max_kernel_n(s: int) -> int:
    """The largest n the kernel takes for s right-hand sides."""
    n = NB * MAX_PANELS
    while kernel_smem_bytes(n, s) > SMEM_LIMIT:
        n -= 1
    return n


def blocks_per_sm(cfg: K3Config) -> int:
    """Resident blocks of the kernel per SM at ``cfg``, as the CUDA runtime's
    occupancy query reports them on the current device (builds the kernel)."""
    out = ctypes.c_int(0)
    rc = KERNEL.library().hommx_chol_blocks_per_sm(cfg.smem_bytes, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"chol_solve.cu: occupancy query failed with cudaError_t {rc}")
    return out.value


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
    if n2 != n or Fs.shape != (n, s, C) or C < 1:
        raise ValueError(f"fused_chol_solve_cuda: bad shapes {tuple(Ks.shape)}, {tuple(Fs.shape)}")
    cfg = chol_launch_config(n, s)
    Kc = Ks.contiguous()
    Fc = Fs.contiguous()
    X = torch.empty((n, s, C), dtype=torch.float32, device=Fs.device)
    KERNEL.launch(
        "hommx_chol_solve_f32", Fs.device.index,
        Kc.data_ptr(), Fc.data_ptr(), X.data_ptr(), C, n, s, float(eps),
        cfg.threads, cfg.panels, cfg.tile_stride, cfg.smem_bytes,
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
