"""The batched micro cell-problem engine (torch port of
``hommx_tpu/micro/engine.py``; P1 problems on structured box cells).

For every macro cell center c_T:

    Ā_e   = Σ_q w_eq A(c_T, y_eq)          # coefficient per micro element
    K_c X = F_c                             # periodic cell problems
    A*_c  = (1/|Y|) Σ_e (E + T D_e X)ᵀ Ā_e (E + T D_e X)

Periodicity is eliminated through the reduced vertex index
(micro/periodic.py); the nullspace is removed by pinning the dofs of reduced
vertex 0.  Two routes are ported (micro/chunk.py):

- scalar problems with a scalar coefficient: the periodic-stencil chunk
  block-PCG, whose Krylov loop is the CUDA kernel K1;
- vector problems (elasticity, s = d(d+1)/2 Voigt generators, T the
  symmetrized or stratified strain map): the chunk Cholesky route, whose
  batched direct solve is the CUDA kernel K3.  The reference takes it in float32 only (float64 runs the
  per-cell route); the port takes it in every dtype.

Other routes — per-cell dense solves (and with them matrix coefficients),
PCG on vector problems, P2 micro
elements, FFT and multigrid cell preconditioners, low-rank coefficients —
raise ``NotImplementedError`` (ROADMAP A6, A9).

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


def _sym_map(M: torch.Tensor) -> torch.Tensor:
    """(d², d²) map taking a flattened gradient H_pq = ∂u_p/∂y_q to the
    deformed strain e_D(u)_ij = ½ Σ_k (M_ik H_jk + M_jk H_ik).

    With M = I this is plain symmetrization H → e(u); with M = Dθᵀ(c_T) it
    is the stratified strain of the reference.  M may carry leading batch
    axes."""
    d = M.shape[-1]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    # T[(i,j),(p,q)] = ½ (M[i,q] δ[p,j] + M[j,q] δ[p,i])
    T = 0.5 * (
        torch.einsum("...iq,pj->...ijpq", M, eye) + torch.einsum("...jq,pi->...ijpq", M, eye)
    )
    return T.reshape(*M.shape[:-2], d * d, d * d)


class MicroEngine:
    """Batched periodic cell-problem solver on one replicated micro mesh.

    Args:
        micro_mesh: the unit-cell mesh Y (a structured box mesh).
        bs: block size — 1 for scalar diffusion, d for elasticity.
        coeff_kind: 'scalar' (bs = 1) | 'tensor4' (bs = d, A(x, y) of shape
            (d, d, d, d)); 'matrix' takes the per-cell route, not ported.
        quad_degree: micro quadrature degree.
        dtype: compute dtype (default: float64 on CPU, float32 on CUDA).
        device: torch device every tensor of the engine lives on.
        assembly: 'auto' | 'dense' | 'scatter' — build of the unit-coefficient
            operator K0 (the PCG's preconditioner, the Cholesky route's
            equilibration scale).
        solver: 'auto' | 'pcg' | 'cholesky'.  'auto' is the stencil PCG for
            scalar problems (the reference picks a Cholesky route there in
            float64) and the chunk Cholesky for vector ones, as in the
            reference.
        pcg_tol, pcg_maxiter: chunk-PCG stopping rule (tol defaults to 1e-5
            in float32 and 1e-11 in float64).
        diag_scale: symmetric per-dof diagonal scaling (PCG) or
            equilibration (Cholesky) of the cell systems.
        cell_prec: only 'k0inv' (the shared K0^-1) is ported.
    """

    def __init__(
        self,
        micro_mesh: SimplexMesh,
        bs: int = 1,
        coeff_kind: str = "scalar",
        quad_degree: int = 2,
        dtype: Optional[torch.dtype] = None,
        device="cuda",
        assembly: str = "auto",
        solver: str = "auto",
        pcg_tol: Optional[float] = None,
        pcg_maxiter: int = 1500,
        diag_scale: bool = True,
        micro_degree: int = 1,
        cell_prec: str = "k0inv",
    ):
        d = micro_mesh.dim
        bs = int(bs)
        if bs not in (1, d):
            raise ValueError("bs must be 1 (scalar) or dim (vector)")
        if coeff_kind != ("tensor4" if bs > 1 else "scalar"):
            raise NotImplementedError(
                f"coeff_kind={coeff_kind!r} with bs={bs}: the port takes scalar "
                "coefficients on scalar problems and tensor4 on vector ones (matrix "
                "coefficients take the per-cell route, ROADMAP A9)"
            )
        if micro_degree != 1:
            raise NotImplementedError("P2 micro elements: ROADMAP A9")
        if cell_prec != "k0inv":
            raise NotImplementedError(
                f"cell_prec={cell_prec!r}: only 'k0inv' is ported (ROADMAP A9)"
            )
        if solver == "auto":
            solver = "pcg" if bs == 1 else "cholesky"
        if solver == "pcg" and bs > 1:
            raise NotImplementedError(
                "PCG on vector problems is not ported (ROADMAP A9); "
                "solver='cholesky' takes them"
            )
        if solver == "cholesky" and bs == 1:
            raise NotImplementedError(
                "the Cholesky route for scalar coefficients is the per-cell "
                "route, not ported yet (ROADMAP A9); solver='pcg' takes them"
            )
        if solver not in ("pcg", "cholesky"):
            raise ValueError("solver must be 'auto', 'pcg' or 'cholesky'")
        self.mesh = micro_mesh
        self.device = as_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.bs = bs
        self.coeff_kind = coeff_kind
        self.quad_degree = int(quad_degree)
        self.d = d
        self.r = d if bs == 1 else d * d  # gradient components per element
        # generator problems SOLVED per cell: d for scalar, the Voigt set
        # d(d+1)/2 for elasticity, expanded back to d² on output
        self.s = d if bs == 1 else d * (d + 1) // 2
        self.s_full = d if bs == 1 else d * d
        self.pmap = build_periodic_map(micro_mesh)
        self.n_reduced = self.pmap.n_reduced * bs
        self.volume_Y = micro_mesh.volume()
        if assembly == "auto":
            if bs > 1 and self.dtype == torch.float32:
                assembly = "scatter"
            else:
                assembly = "dense" if self.n_reduced <= 512 else "scatter"
        self.assembly = assembly
        self.solver = solver
        if solver == "cholesky" and self.device.type == "cuda" and self.dtype == torch.float32:
            from hommx_tpu_torch.ops.chol_kernel import max_kernel_n

            if self.n_reduced > max_kernel_n(self.s):
                raise NotImplementedError(
                    f"the Cholesky kernel K3 holds a cell in shared memory: n = "
                    f"{self.n_reduced} exceeds its limit n <= {max_kernel_n(self.s)} "
                    f"at s = {self.s} (ROADMAP B5)"
                )
        if pcg_tol is None:
            pcg_tol = 1e-5 if self.dtype == torch.float32 else 1e-11
        self.pcg_tol = float(pcg_tol)
        self.pcg_maxiter = int(pcg_maxiter)
        self.diag_scale = bool(diag_scale)
        self.cell_prec = cell_prec
        self._K0inv = None
        self._K0diag = None
        self._stencil = None
        self._kron_M = None
        from hommx_tpu_torch.micro.percell import build_operators

        build_operators(self)
        if solver == "pcg" and self._get_stencil() is None:
            raise NotImplementedError(
                "the micro mesh is not a raster-ordered structured box; the "
                "matrix-free gather route is not ported yet (ROADMAP A9)"
            )

    # -- static operators (host, once) ---------------------------------------
    def _grad_map(self, G: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """(r, r) map applied to corrector-side gradients: None (scalar,
        unmapped), G = Dθᵀ (scalar problem), symmetrization (elasticity),
        or the deformed-strain map (stratified elasticity)."""
        if self.bs == 1:
            return G
        return self._eye_sym if G is None else _sym_map(G)

    def _unit_operator_blocks(self) -> torch.Tensor:
        """(nE, r, r) unit-coefficient blocks TᵀĀ⁰T on the host, float64."""
        Ae0 = torch.einsum(
            "e,rt->ert",
            torch.as_tensor(self.wq, dtype=torch.float64).sum(dim=1),
            torch.eye(self.r, dtype=torch.float64),
        )
        if self.bs == 1:
            return Ae0
        T = _sym_map(torch.eye(self.d, dtype=torch.float64))
        return torch.einsum("mr,emt,tn->ern", T, Ae0, T)

    def _get_K0inv(self) -> torch.Tensor:
        if self._K0inv is None:
            # unit-coefficient reduced operator, pinned, inverted once in f64
            A_K = self._unit_operator_blocks().to(self.dtype)
            K0 = (
                self._assemble_dense(A_K)
                if self.assembly == "dense"
                else self._assemble_scatter(A_K)
            )
            keep = torch.as_tensor(~self.pin_np, dtype=self.dtype)
            K0 = K0 * keep[:, None] * keep[None, :] + torch.diag(
                torch.as_tensor(self.pin_np, dtype=self.dtype)
            )
            self._K0inv = torch.as_tensor(
                np.linalg.inv(K0.numpy().astype(np.float64)), dtype=self.dtype, device=self.device
            )
        return self._K0inv

    def _get_K0diag(self) -> torch.Tensor:
        """Exact diag(K0) of the unit-coefficient pinned operator, by the
        per-element scatter formula in float64 (no dense K0 is built)."""
        if self._K0diag is None:
            Draw = self.Draw_np
            AD = np.einsum("ert,etl->erl", self._unit_operator_blocks().numpy(), Draw)
            l2r = self.loc2red_np
            d0 = np.zeros(self.n_reduced)
            # per-(element, local dof) self terms cover the diagonal unless
            # an element has two local dofs folded onto one reduced dof (a
            # 1-element-wide periodic mesh); then the intra-element cross
            # terms land there too
            if any(np.unique(row).size != row.size for row in l2r):
                vals = np.einsum("erl,erm->elm", Draw, AD)
                same = l2r[:, :, None] == l2r[:, None, :]
                np.add.at(d0, np.broadcast_to(l2r[:, :, None], same.shape)[same], vals[same])
            else:
                dl = np.einsum("erl,erl->el", Draw, AD)
                np.add.at(d0, l2r.reshape(-1), dl.reshape(-1))
            d0[self.pin_np] = 1.0
            self._K0diag = torch.as_tensor(d0, dtype=self.dtype, device=self.device)
        return self._K0diag

    def _scale_from_diag(self, d: torch.Tensor) -> torch.Tensor:
        """S = √(d₀/d) per reduced dof; pinned dofs and non-positive or
        non-finite entries are left unscaled.  ``d`` may carry trailing
        batch axes after the dof axis."""
        d0 = self._get_K0diag().reshape((-1,) + (1,) * (d.ndim - 1))
        pin = self.pin_mask.reshape(d0.shape)
        bad = pin | (d <= 0) | ~torch.isfinite(d)
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return torch.where(bad, one, torch.sqrt(d0 / torch.where(bad, one, d))).to(self.dtype)

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

    def _expand_astar(self, A: torch.Tensor) -> torch.Tensor:
        """Voigt (…, s, s) → full (…, d², d²) tensor layout (exact: the
        expanded entries are duplicates by minor symmetry)."""
        if self.sym_expand is None:
            return A
        e = torch.as_tensor(self.sym_expand, device=A.device)
        return A[..., e[:, None], e[None, :]]

    # -- coefficients --------------------------------------------------------
    def _raw_coeff(self, coeff: Callable, x_center: torch.Tensor) -> torch.Tensor:
        """Per-element reduced coefficient at one center in compact form:
        (nE,) for scalar coefficients, (nE, r, r) canonical blocks for
        tensor4 (test rows (ij), trial columns (kl))."""

        def at_point(y):
            return torch.as_tensor(coeff(x_center, y), device=y.device).to(self.dtype)

        vals = torch.func.vmap(torch.func.vmap(at_point))(self.yq_dev)  # (nE, nq, ...)
        # a product and a sum over q, not an einsum: under the batching vmap
        # the einsum became a train of cuBLAS gemv calls, about half of the
        # micro stage's device time outside K1 (profiled on an H100)
        if self.coeff_kind == "scalar":
            return (self.wq_dev * vals.reshape(self.nE, self.nq)).sum(dim=1)
        vals = vals.reshape(self.nE, self.nq, self.r, self.r)
        return (self.wq_dev[:, :, None, None] * vals).sum(dim=1)

    def nocorrector_tensors(self, coeff, centers, G_fn=None, chunk: int = 0):
        """A⁰(c_T) = (1/|Y|) Σ_e Eᵀ Ā_e E (nc, s_full, s_full), the
        zero-corrector tensors, and the within-cell coefficient contrast
        (nc,) (largest over smallest canonical-block diagonal entry).  By
        energy minimization diag(A*) <= diag(A⁰), which the solve's
        divergence guard checks.  ``G_fn`` is accepted for the reference's
        signature: the zero corrector does not see the map.  Computed in
        chunks to bound memory."""
        centers = torch.as_tensor(centers, device=self.device).to(self.dtype)
        chunk = chunk or self._auto_chunk(centers.shape[0])
        E = self.E
        sf = self.s_full

        def one_chunk(cs):
            Ae = torch.func.vmap(lambda x: self._raw_coeff(coeff, x))(cs)
            C = Ae.shape[0]
            if self.coeff_kind == "scalar":
                A0 = Ae.sum(dim=1)[:, None, None] * (E.T @ E)[None]
                dg = Ae
            else:
                A0 = torch.einsum("rn,crt,tm->cnm", E, Ae.sum(dim=1), E)
                dg = torch.diagonal(Ae, dim1=-2, dim2=-1).reshape(C, -1)
            A0 = self._expand_astar(A0 / self.volume_Y)
            contrast = dg.amax(dim=1) / torch.clamp(dg.amin(dim=1), min=1e-30)
            return torch.cat([A0.reshape(C, -1), contrast[:, None]], dim=1)

        out = _map_chunked(one_chunk, centers, chunk)
        return out[:, :-1].reshape(-1, sf, sf), out[:, -1]

    # -- batched over macro quadrature points --------------------------------
    def tensors_for_centers(self, coeff: Callable, centers, G_fn=None, chunk: int = 0):
        """A*(c_T) (nc, s_full, s_full) for a batch of macro cell centers
        (nc, d); ``G_fn`` is the optional Dθᵀ(x) map of the stratified
        variants."""
        from hommx_tpu_torch.micro.chunk import tensors_chunk_chol, tensors_chunk_pcg

        centers = torch.as_tensor(centers, device=self.device).to(self.dtype)
        chunk = chunk or self._auto_chunk(centers.shape[0])
        if self.solver == "cholesky":
            fn = lambda cs: tensors_chunk_chol(self, coeff, cs, G_fn)
        elif G_fn is not None:
            raise NotImplementedError(
                "stratified scalar problems (PoissonStratifiedHMM) are ROADMAP A6"
            )
        else:
            fn = lambda cs: tensors_chunk_pcg(self, coeff, cs)
        return _map_chunked(fn, centers, chunk)

    def _auto_chunk(self, nc: int) -> int:
        """Chunk size: per-cell work arrays under a memory budget, equal
        chunks.  The lockstep PCG keeps 1 GB and a cap of 2048 (a chunk
        iterates until its worst cell converges); the Cholesky route also
        holds the per-cell operator, its equilibrated copy and the element
        blocks, and wants large chunks: 4 GB, cap 4096.  The reference
        doubles the itemsize of float64 for the TPU's emulated float64;
        native float64 here takes its real size."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        chol = self.solver == "cholesky"
        n = self.n_reduced
        per_cell = (16 * self.nE * self.r * self.s + 10 * n * self.s) * itemsize
        if chol:
            per_cell += (4 * n * n + self.nE * self.nbl * self.nbl) * itemsize
        budget, cap = ((4 << 30), 4096) if chol else ((1 << 30), 2048)
        limit = int(np.clip(budget // max(per_cell, 1), 1, min(nc, cap)))
        if nc > limit:
            limit = int(np.ceil(nc / np.ceil(nc / limit)))
        return limit
