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
source has two instances, and :func:`chol_launch_config` names the one that
runs.  The small one keeps a cell's lower 32 × 32 tiles in shared memory and
takes n up to :func:`max_small_n` (288 at s ≤ 8).  The large one takes every
n above that: the tiles live in a per-cell global workspace that the
wrapper allocates (``K3Config.workspace_bytes`` a cell), the factor runs by
outer panels of ``K3Config.outer`` tile columns (each trailing tile read and
written once an outer panel: :func:`workspace_traffic_bytes`), and a cell of
a chunk smaller than the card is a cluster of CTAs; its only limit is
memory.  The kernel refuses only s outside 1..8.  The kernel has no
backward of its own: the Cholesky route (micro/chunk.py) wraps it in the
implicit-function rule, as the reference wraps it in
``lax.custom_linear_solve``, so the adjoint is one more launch on the
adjoint right-hand sides.
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
    "check_k3_fits",
    "kernel_smem_bytes",
    "large_occupancy",
    "max_small_n",
    "workspace_traffic_bytes",
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
# the large instance: outer panels of 4 tile columns (128 columns), whose
# strip keeps its 10-tile lower diagonal block, 4 rows of 4 tiles and one
# tile of its forward substitution in shared memory at every n (the
# trailing update's 16 + 2 x 4 staged tiles and the substitutions' fit in
# the same 27); at most 8 CTAs a cell
OUTER = 4
LARGE_SMEM = 4 * (OUTER * (OUTER + 1) // 2 + 4 * OUTER + 1) * NB * NB
MAX_CLUSTER = 8
SMS = 132  # streaming multiprocessors of the H100 SXM, for the cluster size

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    Path(__file__).resolve().parent / "csrc" / "chol_solve.cu",
    {
        # K, F, X, C, n, s, eps, threads, P, tile_stride, smem, stream
        "hommx_chol_solve_f32": [_vp, _vp, _vp, _i, _i, _i, ctypes.c_float, _i, _i, _i, _i, _vp],
        # K, F, X, W, V, C, n, s, eps, threads, P, CS, apart, outer, smem, stream
        "hommx_chol_solve_large_f32": [
            _vp, _vp, _vp, _vp, _vp, _i, _i, _i, ctypes.c_float, _i, _i, _i, _i, _i, _i, _vp,
        ],
        # smem, out: resident blocks per SM (not a launch)
        "hommx_chol_blocks_per_sm": [_i, ctypes.POINTER(ctypes.c_int)],
        # CS, smem, out, out: the large instance's CTAs an SM and clusters
        # resident at once (not a launch)
        "hommx_chol_large_occupancy": [_i, _i, ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)],
    },
)


@dataclasses.dataclass(frozen=True)
class K3Config:
    """The kernel's launch configuration for one (n, s).

    threads: per block; panels (P): ⌈n/32⌉, the padded operator's 32-wide
    panels; tile_stride: floats between consecutive columns of a stored
    32 × 32 tile; smem_bytes: dynamic shared memory a block
    (:func:`kernel_smem_bytes` for the small instance, ``LARGE_SMEM`` for
    the large one); blocks_per_sm: blocks resident on one SM by shared
    memory and the kernel's launch bounds.  The small instance runs one
    block a cell (``cluster`` 0).  The large one runs a cluster of
    ``cluster`` CTAs a cell, with ``workspace_bytes`` of global workspace
    a cell (the packed tiles and two (32·P, s) arrays:
    :func:`kernel_smem_bytes`), and factors by outer panels of ``outer``
    tile columns; the CTAs of its first ``apart`` clusters solve a cell
    each, so that a chunk a little over a full wave runs its last cells on
    ``cluster`` CTAs each (:func:`_cluster`)."""

    threads: int
    panels: int
    tile_stride: int
    smem_bytes: int
    blocks_per_sm: int
    cluster: int = 0
    workspace_bytes: int = 0
    outer: int = 0
    apart: int = 0

    @property
    def large(self) -> bool:
        return self.cluster > 0


def kernel_smem_bytes(n: int, s: int) -> int:
    """Dynamic shared memory of one cell's block, in bytes (float32): the
    packed lower tiles of the padded operator and two (32·P, s)
    right-hand-side arrays.  Defined for any n; :func:`chol_launch_config`
    holds it to the limit."""
    P = -(-n // NB)
    return 4 * (P * (P + 1) // 2 * NB * NB + 2 * P * NB * s)


def _cluster(cells: int, blocks: int) -> tuple:
    """(CTAs a cell, clusters whose CTAs solve a cell each) of the large
    instance for a chunk of ``cells`` (0: a chunk that fills the card) at
    ``blocks`` CTAs an SM.  Below one CTA an SM: the fewest of 1, 2, 4, 8
    CTAs a cell that give every SM one.  Above a full wave (``blocks`` ·
    132 slots), where the last wave's cells fit the slots at two CTAs
    each: clusters of 2, the full waves' CTAs a cell each and the last
    wave's cells a cluster each.  Else one CTA a cell.  (Clusters of 4
    and 8 would take the last wave's cells faster, but the H100 holds only
    62 and 30 of them at once, fewer than a full wave's 66 and 33.)"""
    slots = blocks * SMS
    if not cells:
        return 1, 0
    if cells < SMS:
        return next((cs for cs in (1, 2, 4) if cells * cs >= SMS), MAX_CLUSTER), 0
    last = cells % slots  # the full waves' cells, a multiple of the even slots, pair up
    if cells > slots and 0 < 2 * last <= slots:
        return 2, (cells - last) // 2
    return 1, 0


@functools.lru_cache(maxsize=256)
def chol_launch_config(n: int, s: int, cells: int = 0) -> K3Config:
    """The kernel's launch configuration for n unknowns and s right-hand
    sides per cell, in a chunk of ``cells`` cells (0: one that fills the
    card; only the large instance's cluster depends on it).  The small
    instance where a cell fits one block's shared memory (n up to
    :func:`max_small_n`), the large one everywhere else.  Raises
    ValueError where s is out of range."""
    if not 1 <= s <= MAX_RHS:
        raise ValueError(f"Cholesky kernel: s = {s} right-hand sides, the kernel takes 1 to {MAX_RHS}")
    if n < 1:
        raise ValueError(f"Cholesky kernel: n = {n}")
    P = -(-n // NB)
    smem = kernel_smem_bytes(n, s)
    if smem <= SMEM_LIMIT and P <= MAX_PANELS:
        blocks = min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVED))
        return K3Config(THREADS, P, NB, smem, blocks)
    # the large instance's global workspace a cell holds what the small
    # one's shared memory would: the packed tiles and two (32·P, s) arrays
    blocks = min(MAX_BLOCKS_PER_SM, SM_SMEM // (LARGE_SMEM + BLOCK_RESERVED))
    cluster, apart = _cluster(cells, blocks)
    return K3Config(THREADS, P, NB, LARGE_SMEM, blocks, cluster, smem, OUTER, apart)


def workspace_traffic_bytes(n: int, cells: int) -> int:
    """Bytes the large instance's factor reads and writes of its tiles'
    workspace for ``cells`` cells of n unknowns: each lower tile read and
    written once in the strip of its outer panel, and each tile right of
    a strip once more in that strip's trailing update (8 KB a tile each
    time).  Not counted: the strip rows that the trailing products stage
    as operands (tiles just written, read mostly from L2) and the
    substitutions' reads."""
    P = -(-n // NB)
    tiles = P * (P + 1) // 2
    for p0 in range(0, P - OUTER, OUTER):
        m = P - p0 - OUTER
        tiles += m * (m + 1) // 2
    return cells * tiles * 2 * NB * NB * 4


def max_small_n(s: int) -> int:
    """The largest n the small instance takes for s right-hand sides."""
    n = NB * MAX_PANELS
    while kernel_smem_bytes(n, s) > SMEM_LIMIT:
        n -= 1
    return n


def check_k3_fits(n: int, s: int) -> K3Config:
    """K3's launch configuration for n unknowns and s right-hand sides, or
    NotImplementedError where the kernel has none (s outside 1..8).  Host
    data only: the engine calls this when it is built, before any device
    or coefficient work."""
    try:
        return chol_launch_config(n, s)
    except ValueError as err:
        raise NotImplementedError(
            f"the Cholesky kernel K3 takes 1 to {MAX_RHS} right-hand sides a cell and has "
            f"no launch configuration for this cell: {err}"
        ) from None


def blocks_per_sm(cfg: K3Config) -> int:
    """Resident blocks of the kernel per SM at ``cfg``, as the CUDA runtime's
    occupancy query reports them on the current device (builds the kernel)."""
    if cfg.large:
        return large_occupancy(cfg)[0]
    out = ctypes.c_int(0)
    rc = KERNEL.library().hommx_chol_blocks_per_sm(cfg.smem_bytes, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"chol_solve.cu: occupancy query failed with cudaError_t {rc}")
    return out.value


def large_occupancy(cfg: K3Config) -> tuple:
    """(CTAs resident on one SM, clusters of ``cfg.cluster`` CTAs resident
    at once on the current device) of the large instance, by the CUDA
    runtime's occupancy queries (builds the kernel)."""
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = KERNEL.library().hommx_chol_large_occupancy(
        cfg.cluster, cfg.smem_bytes, ctypes.byref(blocks), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"chol_solve.cu: occupancy query failed with cudaError_t {rc}")
    return blocks.value, clusters.value


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
    """Launch the CUDA kernel, the instance that
    ``chol_launch_config(n, s, C)`` names (the large one with its
    workspace from ``torch.empty``): Ks (C, n, n) and Fs (n, s, C), float32
    on one CUDA device; returns X (n, s, C)."""
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
    cfg = chol_launch_config(n, s, C)
    Kc = Ks.contiguous()
    Fc = Fs.contiguous()
    X = torch.empty((n, s, C), dtype=torch.float32, device=Fs.device)
    if cfg.large:
        # the packed tiles, then the right-hand sides and first solutions
        P = cfg.panels
        W = torch.empty(C * P * (P + 1) // 2 * NB * NB, dtype=torch.float32, device=Fs.device)
        V = torch.empty(C * 2 * P * NB * s, dtype=torch.float32, device=Fs.device)
        KERNEL.launch(
            "hommx_chol_solve_large_f32", Fs.device.index,
            Kc.data_ptr(), Fc.data_ptr(), X.data_ptr(), W.data_ptr(), V.data_ptr(),
            C, n, s, float(eps), cfg.threads, P, cfg.cluster, cfg.apart, cfg.outer,
            cfg.smem_bytes,
        )
        return X
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
