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

The source has two instances.  The small one keeps a whole Minv k-slab of
n rows in shared memory and takes n up to 1198, 1024 and 896 at s = 1, 2
and 3.  The large one takes every n above that up to 4096 (the 64² square,
the 16³ cube): one cooperative launch runs the chunk's PCG in phases split
by grid barriers, its preconditioner product one register-tiled GEMM over
the chunk's columns (tiles of whole blocks, :func:`large_schedule`), with
R, P and the iterates in a per-chunk state in global memory.  Above n =
4096 the launch configuration raises (ROADMAP B7).

Dispatch is by device alone: a CUDA tensor goes to the kernel, a CPU
tensor to :func:`stencil_pcg_plain`.  The kernel is float32 only, as on the
TPU; a float64 CUDA tensor raises (no float64 kernel yet, ROADMAP C), and
so does a shape above the kernel's limits.  The kernel has no backward of
its own: the chunk route runs it inside the implicit-function rule
(micro/krylov.py::_solve_linear), whose adjoint is one more launch.
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
from hommx_tpu_torch.utils.profiling import _profiler_enabled

__all__ = [
    "stencil_pcg",
    "stencil_pcg_plain",
    "stencil_pcg_cuda",
    "launch_config",
    "check_k1_fits",
    "K1Config",
    "KERNEL",
    "BLOCK_ITERS",
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
# the large instance: one cooperative launch whose product tiles (LBM rows
# of Minv x tile_cols columns of whole blocks, k in ring stages of LBK)
# span the chunk's blocks; product and vector passes split evenly over the
# CTAs (large_schedule)
LARGE_MAX_N = 4096
LBM = 128  # rows of a product tile
LBK = 16  # k of a ring stage (a Minv tile of LBK x LBM floats, 8 KB)
STAGES = 3  # ring stages
MAX_STAGES = 8
MAX_COL_TILES = 1024
PIECES = 8  # k pieces a product tile at most: its CTAs (at most 6 a tile)
SEGMENTS = 32  # segments of a block in the vector passes at most (30 a block slot)
STATE_CTL = 16 + 2048  # control words and the grid barrier's flags (one a CTA, 2048 at most)
SMS = 132  # streaming multiprocessors of the H100 SXM
SMEM_SM = 233_472  # shared memory of an SM; a CTA's static arrays and reserve take < 4 KB
LARGE_CELLS = 2048  # the chunk routes' cap: the chunk assumed when none is given
# CTAs an SM that the kernel's __launch_bounds__ asks of the registers, by tile_cols
LARGE_MIN_BLOCKS = {128: 1, 48: 4}

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
        # ws, F, Mt, nbr, X_out, iters, state, K, n, s, Cp, CB, tile_cols,
        # stages, threads, smem, grid, state_floats, tol, maxiter, stream
        "hommx_stencil_pcg_large_f32": [
            _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, ctypes.c_longlong,
            ctypes.c_float, _i, _vp,
        ],
        # tile_cols, smem: the CTAs of the large instance the card holds
        "hommx_stencil_pcg_large_grid": [_i, _i],
    },
)

#: K1's per-block iteration counts while a ``torch.profiler`` session
#: records, one entry a launch (nothing otherwise; no kernel, no sync):
#: ``launcher``, ``n``, ``s``, ``K``, ``cells`` (the real cells C),
#: ``cells_per_block`` and ``iters``, the (blocks,) int32 device tensor the
#: kernel writes.  Whoever reads the trace drains it.
BLOCK_ITERS: list = []


@dataclasses.dataclass(frozen=True)
class K1Config:
    """One launch configuration of the kernel.

    cells_per_block (B): cells that share one stop test (their s·B
    columns; the plain version's ``block``); threads: per CTA; smem_bytes:
    dynamic shared memory a CTA.  The small instance (``stages == 0``, one
    CTA a block): rows_per_thread (TM) rows of a thread's register tile of TM
    rows × 4 columns; shared memory R (n padded to a slab multiple) and P
    (n) of s·B columns, two Minv slabs of n rows and the partial column
    sums of each warp's column groups.  The large instance (``stages`` >
    0): one cooperative launch of ``grid`` CTAs (as many as the H100 holds
    at once; the launcher cuts it to what the card holds) of 2 ×
    ``tile_cols`` threads; a product tile is LBM rows × ``tile_cols``
    columns (whole blocks) of Minv R, its k tiles split over up to PIECES
    CTAs (:func:`large_schedule`), with rows_per_thread (8) × 8
    accumulators a thread; shared memory a ring of ``stages`` stages (an
    LBK × LBM Minv tile and LBK rows of R) and the column sums;
    ``state_bytes`` of global memory for the chunk's state."""

    cells_per_block: int
    threads: int
    rows_per_thread: int
    smem_bytes: int
    stages: int = 0
    tile_cols: int = 0
    grid: int = 0
    state_bytes: int = 0

    @property
    def large(self) -> bool:
        return self.stages > 0


def _warp_cols(cg: int) -> int:
    """Column groups (of 4 columns) one warp spans: the largest power of
    two up to 8 that divides the block's ``cg`` groups."""
    return next(w for w in (8, 4, 2, 1) if cg % w == 0)


def _smem_bytes(n: int, s: int, cb: int, threads: int) -> int:
    nc = s * cb
    npad = -(-n // SLAB_COLS) * SLAB_COLS
    wc = _warp_cols(nc // 4)
    return 4 * (npad * nc + n * nc + SLABS * n * SLAB_ROW + (threads // 32) * wc * 2 * 4)


def _large_smem_bytes(tile_cols: int, stages: int) -> int:
    """The ring (``stages`` × an LBK × LBM Minv tile and LBK × tile_cols of
    R) and the column sums of 16 thread rows × 2 quantities × tile_cols."""
    return 4 * (stages * LBK * (LBM + tile_cols) + 32 * tile_cols)


def _large_grid(tile_cols: int, smem: int) -> int:
    """CTAs that the H100 holds at once: the fewer of the CTAs an SM that
    the registers allow (``__launch_bounds__``) and that shared memory
    allows, on every SM."""
    return SMS * min(LARGE_MIN_BLOCKS[tile_cols], SMEM_SM // (smem + 4096))


def _large_dims(n: int, s: int, cells: int, tile_cols: int) -> dict:
    """The kernel's sizes for a chunk of ``cells`` cells."""
    cb = {1: 16, 2: 8, 3: 4}[s]
    nc = s * cb
    nb = -(-cells // cb)
    bpt = tile_cols // nc
    ct = -(-nb // bpt)
    npad = -(-n // LBK) * LBK
    return {"cb": cb, "nc": nc, "nb": nb, "bpt": bpt, "ct": ct, "nct": ct * tile_cols,
            "npad": npad, "kt": npad // LBK, "rt": -(-n // LBM)}


def _large_state_floats(n: int, s: int, cells: int, tile_cols: int) -> int:
    """STATE_CTL control words (the grid barrier's generation and flags);
    R, P, X and PIECES product arrays, each column tiles × npad ×
    tile_cols; the column sums of the product (2 × row tiles) and of the
    passes (2 × SEGMENTS), their totals (4 a column); fnorm and rz, best rel
    by parity (5 a column); stopped, stall, iterations and the rows done (4
    a block slot), the row tiles done (1 a column tile) and the k tiles
    done (1 a product tile) — as the launcher counts them."""
    d = _large_dims(n, s, cells, tile_cols)
    nct = d["nct"]
    return (STATE_CTL + (3 + PIECES) * d["ct"] * d["npad"] * tile_cols + 2 * d["rt"] * nct
            + 2 * SEGMENTS * nct + 9 * nct + 4 * d["ct"] * d["bpt"] + d["ct"] + d["rt"] * d["ct"])


def large_candidate(n: int, s: int, cells: int, stages: int = STAGES) -> K1Config | None:
    """The large instance's configuration for a chunk of ``cells`` cells
    with ``stages`` ring stages: 8 blocks a product tile (128 columns; 4
    blocks, 48 columns at s = 3); None where it cannot run."""
    cb = {1: 16, 2: 8, 3: 4}[s]
    tile_cols = 48 if s == 3 else 128
    if not 2 <= stages <= MAX_STAGES or _large_dims(n, s, cells, tile_cols)["ct"] > MAX_COL_TILES:
        return None  # more column tiles than the kernel lists
    smem = _large_smem_bytes(tile_cols, stages)
    if smem > SMEM_LIMIT:
        return None
    return K1Config(cb, 2 * tile_cols, 8, smem, stages, tile_cols,
                    _large_grid(tile_cols, smem), 4 * _large_state_floats(n, s, cells, tile_cols))


def _large_config(n: int, s: int, cells: int) -> K1Config:
    """The large instance's configuration for a chunk of ``cells`` cells
    (0: LARGE_CELLS); raises where the chunk needs more column tiles than
    the kernel lists."""
    cfg = large_candidate(n, s, cells or LARGE_CELLS)
    if cfg is None:
        raise ValueError(
            f"stencil PCG kernel: a chunk of {cells} cells needs more than {MAX_COL_TILES} "
            f"column tiles; use a smaller chunk"
        )
    return cfg


def _even_split(units: int, grid: int, per: int) -> list:
    """The kernel's split of ``units`` (items of ``per`` units each, end to
    end) over ``grid`` CTAs: CTA c takes [c·units // grid, (c+1)·units //
    grid); its pieces as (c, item, first unit, end unit, place among the
    item's CTAs)."""

    def owner(u):
        return ((u + 1) * grid - 1) // units

    out = []
    for c in range(grid):
        u, hi = c * units // grid, (c + 1) * units // grid
        while u < hi:
            item, u0 = divmod(u, per)
            u1 = min(per, u0 + hi - u)
            out.append((c, item, u0, u1, c - owner(item * per)))
            u += u1 - u0
    return out


def large_schedule(n: int, s: int, cells: int, cfg: K1Config, grid: int | None = None) -> tuple:
    """The large instance's work as the kernel divides it, every block
    running, on ``grid`` CTAs (``cfg.grid``).  The product: its 128-row
    tiles tau = rt·CT + ct of KT k tiles each, split end to end over the
    first min(grid, 6·tiles) CTAs (stream-K); a piece is (CTA, row range,
    column range, k-tile range, place among the tile's CTAs).  The vector
    passes: the block slots' n rows each, split the same way over the first
    min(grid, 30·slots) CTAs; a segment is (CTA, block, row range, place).
    Columns are the chunk's column slots: block b holds b·s·B .. (b+1)·s·B
    − 1; slots past the chunk's blocks are skipped by the passes."""
    d = _large_dims(n, s, cells, cfg.tile_cols)
    grid = grid or cfg.grid
    tiles, slots = d["rt"] * d["ct"], d["ct"] * d["bpt"]
    product = [(c, (rt * LBM, min(n, (rt + 1) * LBM)),
                (ct * cfg.tile_cols, (ct + 1) * cfg.tile_cols), (k0, k1), pc)
               for c, tau, k0, k1, pc in _even_split(tiles * d["kt"], min(grid, 6 * tiles),
                                                     d["kt"])
               for rt, ct in [divmod(tau, d["ct"])]]
    passes = [(c, b, (r0, r1), pc)
              for c, b, r0, r1, pc in _even_split(slots * n, min(grid, 30 * slots), n)]
    return product, passes


def large_grid_on_card(cfg: K1Config) -> int:
    """The CTAs of ``cfg`` that the current card holds at once (the grid a
    launch is cut to), from the CUDA occupancy query; builds the kernel."""
    got = KERNEL.library().hommx_stencil_pcg_large_grid(cfg.tile_cols, cfg.smem_bytes)
    if got < 0:
        raise RuntimeError(f"stencil_pcg.cu: occupancy query failed with cudaError_t {-got}")
    return got


@functools.lru_cache(maxsize=256)
def launch_config(n: int, s: int, cells: int = 0) -> K1Config:
    """The kernel's launch configuration for n unknowns and s right-hand
    sides per cell, in a chunk of ``cells`` cells (0: LARGE_CELLS; only the
    large instance's tiles, grid and state depend on it, not the cells a
    block).  The stencil's K does not enter: weights and neighbour table
    are read from global memory.

    The small instance where it fits: it prefers the most cells per block
    (each block streams all of Minv on every apply, so fewer, wider blocks
    move less from L2), then the most threads.  A warp's 32 lanes hold
    32/WC rows of WC 4-column groups (``_warp_cols``), so the rows of the
    block, threads/(s·CB/4), are a multiple of 32/WC; a thread holds at
    most 8 rows (at most 384 threads with 8).  Above its reach, up to
    n = 4096, the large instance (:func:`_large_config`).  Raises
    ValueError, naming the limit, above that."""
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
    if n <= LARGE_MAX_N:
        return _large_config(n, s, cells)
    raise ValueError(
        f"stencil PCG kernel: n = {n} unknowns exceeds its limit n <= {LARGE_MAX_N}, the "
        f"sizes held against its plain version on the card (ROADMAP B7)"
    )


def check_k1_fits(n: int, s: int) -> K1Config:
    """K1's launch configuration for n unknowns and s right-hand sides, or
    NotImplementedError naming ROADMAP B7 where the kernel has none (the
    engine calls this when it is built, before any coefficient work)."""
    try:
        return launch_config(n, s)
    except ValueError as err:
        raise NotImplementedError(
            f"the stencil PCG kernel K1 takes scalar cells up to n = {LARGE_MAX_N} unknowns "
            f"(the 64² square, the 16³ cube) and has no launch configuration for this "
            f"cell: {err} (cell_prec='mg' takes such cells without K1)"
        ) from None


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


def _tiled(Minv: torch.Tensor) -> torch.Tensor:
    """Minv in the large instance's tile order, zero-padded:
    ``[row tile][k tile][k][row]`` with tiles of LBM rows and LBK columns,
    so each tile is one contiguous 8 KB copy laid out as the product reads
    it (a thread's float4 holds 4 rows of one k)."""
    n = Minv.shape[0]
    rt, kt = -(-n // LBM), -(-n // LBK)
    M = Minv.new_zeros((rt * LBM, kt * LBK))
    M[:n, :n] = Minv
    return M.view(rt, LBM, kt, LBK).permute(0, 2, 3, 1).contiguous()


def stencil_pcg_cuda(ws, F, Minv, shape, offsets, tol, maxiter, per_block=False):
    """Launch the CUDA kernel; same contract as :func:`stencil_pcg_plain`
    with ``block=launch_config(n, s).cells_per_block`` (the iteration count
    comes back as a 0-d int32 CUDA tensor, or per block with
    ``per_block``).  While a profiler records, the per-block counts are
    also appended to :data:`BLOCK_ITERS`."""
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
    cfg = launch_config(n, s, C)
    B = cfg.cells_per_block
    pad = (-C) % B
    Cp = C + pad
    Wk = torch.stack(ws, dim=0)  # (K, n, C)
    Ff = F.permute(1, 0, 2)  # (s, n, C)
    if pad:
        # padded columns solve a unit-weight system with zero RHS: X = 0
        # from the first prec apply; their relative residual is 0
        Wk = torch.nn.functional.pad(Wk, (0, pad), value=1.0)
        Ff = torch.nn.functional.pad(Ff, (0, pad))
    Wk, Ff = _aligned(Wk), _aligned(Ff)
    nbr = _neighbour_table(
        tuple(int(x) for x in shape),
        tuple(tuple(int(o) for o in off) for off in offsets),
        str(dev),
    )
    X = torch.empty((s, n, Cp), dtype=torch.float32, device=dev)
    iters = torch.empty((Cp // B,), dtype=torch.int32, device=dev)
    launcher = "hommx_stencil_pcg_large_f32" if cfg.large else "hommx_stencil_pcg_f32"
    if cfg.large:
        state = torch.empty(cfg.state_bytes // 4, dtype=torch.float32, device=dev)
        KERNEL.launch(
            launcher, dev.index,
            Wk.data_ptr(), Ff.data_ptr(), _tiled(Minv).data_ptr(), nbr.data_ptr(),
            X.data_ptr(), iters.data_ptr(), state.data_ptr(),
            K, n, s, Cp, B, cfg.tile_cols, cfg.stages, cfg.threads, cfg.smem_bytes,
            cfg.grid, state.numel(), float(tol), int(maxiter),
        )
    else:
        KERNEL.launch(
            launcher, dev.index,
            Wk.data_ptr(), Ff.data_ptr(), _aligned(Minv).data_ptr(), nbr.data_ptr(),
            X.data_ptr(), iters.data_ptr(),
            K, n, s, Cp, B, cfg.threads, cfg.smem_bytes, float(tol), int(maxiter),
        )
    if _profiler_enabled():
        BLOCK_ITERS.append({"launcher": launcher, "n": n, "s": s, "K": K, "cells": C,
                            "cells_per_block": B, "iters": iters})
    return X[:, :, :C].permute(1, 0, 2), (iters if per_block else iters.max())


def stencil_pcg(ws, F, Minv, shape, offsets, tol, maxiter):
    """The fused stencil chunk-PCG: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if F.is_cuda:
        return stencil_pcg_cuda(ws, F, Minv, shape, offsets, tol, maxiter)
    if F.device.type == "cpu":
        return stencil_pcg_plain(ws, F, Minv, shape, offsets, tol, maxiter)
    raise TypeError(f"stencil_pcg: unsupported device {F.device}")
