"""The batched micro cell-problem engine (torch port of
``hommx_tpu/micro/engine.py``; scalar P1 problems on structured box cells).

For every macro cell center c_T:

    ā_e   = Σ_q w_eq A(c_T, y_eq)          # coefficient per micro element
    K_c X = F_c                             # periodic cell problems, s = d
    A*_c  = (1/|Y|) Σ_e ā_e (E + D_e X)ᵀ(E + D_e X)

Periodicity is eliminated through the reduced vertex index
(micro/periodic.py); the constant nullspace is removed by pinning the dof of
reduced vertex 0.  The only route in this slice is the periodic-stencil
chunk block-PCG (micro/chunk.py).  Other routes — per-cell dense and
Cholesky solves, vector (elasticity) problems, P2 micro elements, FFT and
multigrid cell preconditioners — raise ``NotImplementedError``
(ROADMAP A6, A7, A9).

Coefficients are torch callables ``A(x, y)`` on 1-D points, evaluated with
nested ``torch.func.vmap``; quadrature coordinates stay float64 whatever
the compute dtype.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype
from hommx_tpu_torch.meshes.simplex import SimplexMesh
from hommx_tpu_torch.micro.krylov import _map_chunked
from hommx_tpu_torch.micro.periodic import build_periodic_map

__all__ = ["MicroEngine"]


class MicroEngine:
    """Batched periodic cell-problem solver on one replicated micro mesh.

    Args:
        micro_mesh: the unit-cell mesh Y (a structured box mesh).
        bs: block size; only 1 (scalar diffusion) is ported.
        coeff_kind: shape of A(x, y); only 'scalar' is ported.
        quad_degree: micro quadrature degree.
        dtype: compute dtype (default: float64 on CPU, float32 on CUDA).
        device: torch device every tensor of the engine lives on.
        assembly: 'auto' | 'dense' | 'scatter' — build of the unit-coefficient
            operator K0 that the preconditioner inverts.
        solver: 'auto' | 'pcg'.  The reference resolves 'auto' to a Cholesky
            route in float64; the port has only the stencil PCG, so 'auto'
            is 'pcg' for every dtype.
        pcg_tol, pcg_maxiter: chunk-PCG stopping rule (tol defaults to 1e-5
            in float32 and 1e-11 in float64).
        diag_scale: symmetric per-dof diagonal scaling of the PCG system.
        cell_prec: only 'k0inv' (the shared K0^-1) is ported.
    """

    def __init__(
        self,
        micro_mesh: SimplexMesh,
        bs: int = 1,
        coeff_kind: str = "scalar",
        quad_degree: int = 2,
        dtype: Optional[torch.dtype] = None,
        device="cpu",
        assembly: str = "auto",
        solver: str = "auto",
        pcg_tol: Optional[float] = None,
        pcg_maxiter: int = 1500,
        diag_scale: bool = True,
        micro_degree: int = 1,
        cell_prec: str = "k0inv",
    ):
        d = micro_mesh.dim
        if int(bs) not in (1, d):
            raise ValueError("bs must be 1 (scalar) or dim (vector)")
        if int(bs) != 1 or coeff_kind != "scalar":
            raise NotImplementedError(
                "only scalar coefficients on scalar problems are ported "
                "(matrix/tensor coefficients and elasticity: ROADMAP A6/A7)"
            )
        if micro_degree != 1:
            raise NotImplementedError("P2 micro elements: ROADMAP A9")
        if solver not in ("auto", "pcg"):
            raise NotImplementedError(
                f"micro solver {solver!r}: only the stencil chunk PCG is ported "
                "(Cholesky and per-cell routes: ROADMAP A7/A9)"
            )
        if cell_prec != "k0inv":
            raise NotImplementedError(
                f"cell_prec={cell_prec!r}: only 'k0inv' is ported (ROADMAP A9)"
            )
        self.mesh = micro_mesh
        self.device = as_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.bs = 1
        self.coeff_kind = coeff_kind
        self.quad_degree = int(quad_degree)
        self.d = d
        self.r = d  # gradient components per element
        self.s = d  # generator problems per cell
        self.pmap = build_periodic_map(micro_mesh)
        self.n_reduced = self.pmap.n_reduced
        self.volume_Y = micro_mesh.volume()
        if assembly == "auto":
            assembly = "dense" if self.n_reduced <= 512 else "scatter"
        self.assembly = assembly
        self.solver = "pcg"
        if pcg_tol is None:
            pcg_tol = 1e-5 if self.dtype == torch.float32 else 1e-11
        self.pcg_tol = float(pcg_tol)
        self.pcg_maxiter = int(pcg_maxiter)
        self.diag_scale = bool(diag_scale)
        self.cell_prec = cell_prec
        self._K0inv = None
        self._K0diag = None
        self._stencil = None
        from hommx_tpu_torch.micro.percell import build_operators

        build_operators(self)
        if self._get_stencil() is None:
            raise NotImplementedError(
                "the micro mesh is not a raster-ordered structured box; the "
                "matrix-free gather route is not ported yet (ROADMAP A9)"
            )

    # -- static operators (host, once) ---------------------------------------
    def _get_K0inv(self) -> torch.Tensor:
        if self._K0inv is None:
            # unit-coefficient reduced operator, pinned, inverted once in f64
            Ae0 = torch.einsum(
                "e,rt->ert",
                torch.as_tensor(self.wq, dtype=self.dtype).sum(dim=1),
                torch.eye(self.r, dtype=self.dtype),
            )
            K0 = (
                self._assemble_dense(Ae0)
                if self.assembly == "dense"
                else self._assemble_scatter(Ae0)
            )
            keep = torch.as_tensor(~self.pin_np, dtype=self.dtype)
            K0 = K0 * keep[:, None] * keep[None, :] + torch.diag(
                torch.as_tensor(self.pin_np, dtype=self.dtype)
            )
            K0_64 = K0.numpy().astype(np.float64)
            self._K0inv = torch.as_tensor(
                np.linalg.inv(K0_64), dtype=self.dtype, device=self.device
            )
            self._K0diag = torch.as_tensor(
                np.diag(K0_64).copy(), dtype=self.dtype, device=self.device
            )
        return self._K0inv

    def _get_K0diag(self) -> torch.Tensor:
        if self._K0diag is None:
            self._get_K0inv()
        return self._K0diag

    def _assemble_dense(self, A_K: torch.Tensor) -> torch.Tensor:
        """K = D_flatᵀ (A_K D)_flat over (nE·r, nred), on the host."""
        D = torch.as_tensor(self.D_np, dtype=A_K.dtype)
        Z = torch.einsum("ert,etn->ern", A_K, D)
        nE, r, nred = Z.shape
        return D.reshape(nE * r, nred).T @ Z.reshape(nE * r, nred)

    def _assemble_scatter(self, A_K: torch.Tensor) -> torch.Tensor:
        """Per-element (nbl, nbl) blocks scattered into the dense reduced
        operator, on the host."""
        Draw = torch.as_tensor(self.Draw_np, dtype=A_K.dtype)
        vals = torch.einsum("erl,ert,etm->elm", Draw, A_K, Draw)
        l2r = torch.as_tensor(self.loc2red_np)
        flat = (l2r[:, :, None] * self.n_reduced + l2r[:, None, :]).reshape(-1)
        K = torch.zeros(self.n_reduced * self.n_reduced, dtype=A_K.dtype)
        K.index_add_(0, flat, vals.reshape(-1))
        return K.reshape(self.n_reduced, self.n_reduced)

    def _get_stencil(self):
        from hommx_tpu_torch.micro.chunk import _get_stencil

        return _get_stencil(self)

    # -- coefficients --------------------------------------------------------
    def _raw_coeff(self, coeff: Callable, x_center: torch.Tensor) -> torch.Tensor:
        """Per-element reduced scalar coefficient ā_e (nE,) at one center."""

        def at_point(y):
            return torch.as_tensor(coeff(x_center, y), device=y.device).to(self.dtype)

        vals = torch.func.vmap(torch.func.vmap(at_point))(self.yq_dev)  # (nE, nq)
        # a product and a sum over q, not an einsum: under the batching vmap
        # the einsum became a train of cuBLAS gemv calls, about half of the
        # micro stage's device time outside K1 (profiled on an H100)
        return (self.wq_dev * vals.reshape(self.nE, self.nq)).sum(dim=1)

    def nocorrector_tensors(self, coeff, centers, chunk: int = 0):
        """A⁰(c_T) = (1/|Y|) Σ_e Eᵀ Ā_e E (nc, s, s), the zero-corrector
        tensors, and the within-cell coefficient contrast (nc,).  By energy
        minimization diag(A*) <= diag(A⁰), which the solve's divergence
        guard checks.  Computed in chunks to bound memory."""
        centers = torch.as_tensor(centers, device=self.device).to(self.dtype)
        chunk = chunk or self._auto_chunk(centers.shape[0])
        EtE = self.E.T @ self.E

        def one_chunk(cs):
            a = torch.func.vmap(lambda x: self._raw_coeff(coeff, x))(cs)  # (C, nE)
            A0 = a.sum(dim=1)[:, None, None] * EtE[None] / self.volume_Y
            contrast = a.max(dim=1).values / torch.clamp(a.min(dim=1).values, min=1e-30)
            return torch.cat([A0.reshape(a.shape[0], -1), contrast[:, None]], dim=1)

        out = _map_chunked(one_chunk, centers, chunk)
        return out[:, :-1].reshape(-1, self.s, self.s), out[:, -1]

    # -- batched over macro quadrature points --------------------------------
    def tensors_for_centers(self, coeff: Callable, centers, chunk: int = 0):
        """A*(c_T) (nc, s, s) for a batch of macro cell centers (nc, d)."""
        from hommx_tpu_torch.micro.chunk import tensors_chunk_pcg

        centers = torch.as_tensor(centers, device=self.device).to(self.dtype)
        chunk = chunk or self._auto_chunk(centers.shape[0])
        return _map_chunked(
            lambda cs: tensors_chunk_pcg(self, coeff, cs), centers, chunk
        )

    def _auto_chunk(self, nc: int) -> int:
        """Chunk size: per-cell work arrays under ~1 GB, capped at 2048 (the
        lockstep PCG iterates until a chunk's worst cell converges), equal
        chunks.  The reference doubles the itemsize of float64 for the
        TPU's emulated float64; native float64 here takes its real size."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_cell = (16 * self.nE * self.r * self.s + 10 * self.n_reduced * self.s) * itemsize
        limit = int(np.clip((1 << 30) // max(per_cell, 1), 1, min(nc, 2048)))
        if nc > limit:
            limit = int(np.ceil(nc / np.ceil(nc / limit)))
        return limit
