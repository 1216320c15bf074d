"""DIA (diagonal) sparse format and the DIA SpMV kernel (torch port of
``hommx_tpu/ops/dia.py``).

P1 stiffness matrices on structured meshes have a small, fixed set of
column offsets (7 in 2D, 15 in 3D), so SpMV collapses to
y = Σ_d vals_d ∘ shift(x, offset_d) with static offsets.  ``dia_spmv`` is
the plain PyTorch version.  ``DIAOperator`` is one matrix prepared for
many products, as the macro CG makes them: it dispatches by device alone,
a CUDA tensor to the hand-written kernel ``csrc/dia_spmv.cu`` (which
replaces the TPU kernel ``dia_spmv_pallas``; float32 only, a float64 CUDA
tensor raises), a CPU tensor to ``dia_spmv``.  ``dia_spmv_cuda`` and
``dia_spmv_op`` are one-product wrappers over it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hommx_tpu_torch._cuda import CudaKernel
from hommx_tpu_torch.ops.sparse import ELLPattern

__all__ = [
    "DIAPattern",
    "build_dia_from_ell",
    "ell_vals_to_dia",
    "gather_cols",
    "dia_spmv",
    "DIAOperator",
    "dia_spmv_cuda",
    "dia_spmv_op",
    "KERNEL",
]

# P1 block stencils stay well under this; unstructured meshes blow past it
# and stay on the ELL gather path.  Must equal MAX_DIAGONALS in the kernel.
_MAX_DIAGONALS = 96

KERNEL = CudaKernel(
    Path(__file__).resolve().parent / "csrc" / "dia_spmv.cu",
    {
        # vals, offsets (host int32[nd]), nd, x, y, N, stream
        "hommx_dia_spmv_f32": [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ],
    },
)


@dataclasses.dataclass(frozen=True)
class DIAPattern:
    """Static DIA conversion data derived from an ELLPattern.

    Attributes:
        offsets: (nd,) sorted distinct column offsets (col - row).
        ell_to_dia: (N*K,) flat index into the (nd, N) DIA value array for
            every ELL slot (padding slots point at a scratch slot nd*N).
        ell_off_index: (N, K) diagonal index of every ELL slot (-1 padding).
        num_dofs: N.
    """

    offsets: tuple
    ell_to_dia: np.ndarray
    ell_off_index: np.ndarray
    num_dofs: int
    _dev: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)

    def tensor(self, name: str, device) -> torch.Tensor:
        """Cached int64 device copy of ``ell_to_dia`` / ``ell_off_index``."""
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(
                np.asarray(getattr(self, name), dtype=np.int64), device=device
            )
        return self._dev[key]


def build_dia_from_ell(pattern: ELLPattern) -> Optional[DIAPattern]:
    """DIA conversion for an ELL pattern; None if too many distinct offsets
    (unstructured mesh) for the format to pay off."""
    N, K = pattern.num_dofs, pattern.row_width
    rows = np.repeat(np.arange(N), K)
    cols = pattern.cols.reshape(-1).astype(np.int64)
    # real slots are exactly those the assembly scatters into; everything
    # else is ELL padding (zero values) and goes to a scratch cell
    used = np.unique(pattern.slots)
    offs_used = cols[used] - rows[used]
    uniq = np.unique(offs_used)
    if len(uniq) > _MAX_DIAGONALS:
        return None
    scratch = len(uniq) * N
    out = np.full(N * K, scratch, dtype=np.int64)
    oidx = np.searchsorted(uniq, offs_used).astype(np.int64)
    out[used] = oidx * N + rows[used]
    ell_off = np.full(N * K, -1, dtype=np.int8)
    ell_off[used] = oidx
    return DIAPattern(
        tuple(int(o) for o in uniq),
        out.astype(np.int32),
        ell_off.reshape(N, K),
        N,
    )


def ell_vals_to_dia(dia: DIAPattern, ell_vals: torch.Tensor) -> torch.Tensor:
    """Scatter the flat ELL value array into (nd, N) DIA storage."""
    nd, N = dia.num_diagonals, dia.num_dofs
    out = torch.zeros(nd * N + 1, dtype=ell_vals.dtype, device=ell_vals.device)
    out.index_add_(0, dia.tensor("ell_to_dia", ell_vals.device), ell_vals.reshape(-1))
    return out[: nd * N].reshape(nd, N)


def _padded(x: torch.Tensor, offsets):
    """(x zero-padded by P = max |offset| on both sides, P)."""
    P = max(max(abs(o) for o in offsets), 1)
    return torch.nn.functional.pad(x, (P, P)), P


def gather_cols(dia: DIAPattern, row_vec: torch.Tensor) -> torch.Tensor:
    """(N, K) tensor with entry [i, k] = row_vec[cols[i, k]], computed by
    static shifts of ``row_vec`` selected per slot by its diagonal index."""
    N = dia.num_dofs
    rp, P = _padded(row_vec, dia.offsets)
    off_index = dia.tensor("ell_off_index", row_vec.device)
    out = torch.zeros(off_index.shape, dtype=row_vec.dtype, device=row_vec.device)
    for d, off in enumerate(dia.offsets):
        out = torch.where(off_index == d, rp[P + off : P + off + N, None], out)
    return out


def dia_spmv(dia_vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """Plain DIA SpMV: y[i] = Σ_d vals[d, i] * x[i + off_d]."""
    N = x.shape[0]
    xp, P = _padded(x, offsets)
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + dia_vals[d] * xp[P + off : P + off + N]
    return y


class DIAOperator:
    """The DIA SpMV x ↦ A x with one matrix, prepared once for many
    products (the macro CG makes one per iteration).

    It holds the contiguous values, the offsets, N and a reusable output
    buffer ``out``; on CUDA also the offsets packed for the launcher and the
    resolved launch function (building the kernel at first use), so that a
    product is a few cheap checks and one ctypes call.  A CUDA operator
    takes float32 only and raises ``TypeError`` otherwise; a CPU operator
    runs the plain :func:`dia_spmv`.

    Args:
        dia_vals: (nd, N) diagonal values.
        offsets: the nd column offsets (col − row) of the diagonals.
    """

    def __init__(self, dia_vals: torch.Tensor, offsets):
        self.offsets = tuple(int(o) for o in offsets)
        nd = len(self.offsets)
        if dia_vals.ndim != 2 or dia_vals.shape[0] != nd or not 1 <= nd <= _MAX_DIAGONALS:
            raise ValueError(f"DIAOperator: bad shapes {tuple(dia_vals.shape)}, {nd} offsets")
        self.N = dia_vals.shape[1]
        self.device = dia_vals.device
        self.vals = dia_vals.contiguous()
        self.out = torch.empty(self.N, dtype=dia_vals.dtype, device=self.device)
        self._launch = None
        if self.device.type == "cuda":
            if dia_vals.dtype != torch.float32:
                raise TypeError(
                    "the DIA kernel takes float32 tensors: it has no float64 "
                    "version yet (ROADMAP C); use dtype=torch.float32 on CUDA"
                )
            self._index = self.device.index
            self._vals_ptr = self.vals.data_ptr()
            self._offsets_c = (ctypes.c_int * nd)(*self.offsets)
            self._launch = KERNEL.launcher("hommx_dia_spmv_f32")
        elif self.device.type != "cpu":
            raise TypeError(f"DIAOperator: unsupported device {self.device}")

    def __call__(self, x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A x, written into ``out`` when given (and returned), else into a
        new tensor.  ``out`` must not be ``x``."""
        if self._launch is None:
            y = dia_spmv(self.vals, self.offsets, x)
            return y if out is None else out.copy_(y)
        if x.dtype != torch.float32 or x.get_device() != self._index:
            raise TypeError(
                f"DIAOperator on {self.device} takes float32 tensors there, got "
                f"{x.dtype} on {x.device}"
            )
        if x.shape != self.out.shape or not x.is_contiguous():
            raise ValueError(f"DIAOperator: x must be contiguous of shape ({self.N},)")
        if out is None:
            out = torch.empty_like(x)
        elif out is not self.out and (
            out.dtype != torch.float32 or out.get_device() != self._index
            or out.shape != self.out.shape or not out.is_contiguous()
        ):
            raise ValueError(
                f"DIAOperator: out must be a contiguous float32 ({self.N},) on {self.device}"
            )
        x_ptr, y_ptr = x.data_ptr(), out.data_ptr()
        if x_ptr == y_ptr:
            raise ValueError("DIAOperator: out must not be x")
        self._launch(self._index, self._vals_ptr, self._offsets_c, len(self._offsets_c),
                     x_ptr, y_ptr, self.N)
        return out


def dia_spmv_cuda(dia_vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA DIA kernel once (float32 tensors on one CUDA device)."""
    if not (x.is_cuda and dia_vals.device == x.device):
        raise TypeError("dia_spmv_cuda takes CUDA tensors on one device")
    op = DIAOperator(dia_vals, offsets)
    return op(x.contiguous(), out=op.out)


def dia_spmv_op(dia_vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """The DIA SpMV: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return dia_spmv_cuda(dia_vals, offsets, x)
    if x.device.type == "cpu":
        return dia_spmv(dia_vals, offsets, x)
    raise TypeError(f"dia_spmv_op: unsupported device {x.device}")
