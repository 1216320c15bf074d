"""The batched micro cell-problem engine (torch port of
``hommx_tpu/micro/engine.py``; P1 and P2 cell problems).

For every macro cell center c_T:

    Ā_e   = Σ_q w_eq A(c_T, y_eq)          # coefficient per micro element
    K_c X = F_c                             # periodic cell problems
    A*_c  = (1/|Y|) Σ_e (E + T D_e X)ᵀ Ā_e (E + T D_e X)

Periodicity is eliminated through the reduced node index
(micro/periodic.py); the nullspace is removed by pinning the dofs of reduced
node 0.  P2 cell problems (``micro_degree=2``) fold the edge midpoints by
the vertices' rule and turn every (element, quadrature point) pair into an
"effective element" with constant gradients, so nE = ne·nq and every
downstream stage runs unchanged (micro/percell.py::build_operators).
``tensors_for_centers`` picks a route by the reference's rule:

- the chunk PCG (micro/chunk.py::tensors_chunk_pcg) for ``solver='pcg'``
  with ``pcg_strategy='matfree'``, ``cell_prec`` 'fft' or 'mg', or a
  declared ``coeff_rank``: the scalar periodic stencil with the shared
  K0⁻¹, whose Krylov loop is the CUDA kernel K1; otherwise the stencil,
  the block stencil (micro/block_stencil.py), the matrix-free gather, the
  low-rank or the dense-K matvec, preconditioned by K0⁻¹, the FFT symbol
  of the cell's mean coefficient (``torch.fft``) or the torus multigrid
  (micro/mg_prec.py), in plain torch;
- the chunk Cholesky (vector problems on ``solver='cholesky'``, s =
  d(d+1)/2 Voigt generators), whose batched direct solve is the CUDA
  kernel K3.  The reference takes it in float32 only (float64 runs the
  per-cell route); the port takes it in every dtype;
- the per-cell route (micro/percell.py) for the rest — the float64 scalar
  default, matrix coefficients, ``pcg_strategy='densek'`` — dense K and
  Cholesky or a block-PCG, batched over a chunk with ``torch.linalg``.

Coefficients are torch callables ``A(x, y)`` on 1-D points, evaluated with
nested ``torch.func.vmap``; quadrature coordinates stay float64 whatever
the compute dtype.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype, same_device
from hommx_tpu_torch.meshes.simplex import SimplexMesh
from hommx_tpu_torch.micro.krylov import _map_chunked
from hommx_tpu_torch.micro.periodic import build_periodic_map, build_periodic_map_points
from hommx_tpu_torch.micro.stencil import micro_matvec_mode, torus_coords
from hommx_tpu_torch.micro.stencil_pcg import check_k1_fits
from hommx_tpu_torch.ops.chol_kernel import chol_launch_config, check_k3_fits
from hommx_tpu_torch.ops.assembly import gather_sum
from hommx_tpu_torch.ops.function_space import FunctionSpace

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
    """Batched periodic cell-problem solver on one replicated micro mesh
    (the reference's constructor arguments and defaults).

    Args:
        micro_mesh: the unit-cell mesh Y.
        bs: block size — 1 for scalar diffusion, d for elasticity.
        coeff_kind: 'scalar' | 'matrix' (bs = 1, A(x, y) of shape (d, d)) |
            'tensor4' (bs = d, A(x, y) of shape (d, d, d, d)).
        quad_degree: micro quadrature degree.
        dtype: compute dtype (default: float64 on CPU, float32 on CUDA).
        device: torch device every tensor of the engine lives on.
        assembly: 'auto' | 'dense' | 'scatter' — build of the dense reduced
            operators (K0, and the per-cell route's K).
        solver: 'auto' | 'pcg' | 'cholesky'.  'auto' is the chunk PCG for
            scalar float32 problems and Cholesky otherwise, as in the
            reference.
        pcg_strategy: 'densek' | 'matfree' (None: matfree for scalar
            coefficients on scalar problems, densek otherwise).
        pcg_tol, pcg_maxiter: PCG stopping rule (tol defaults to 1e-5 in
            float32 and 1e-11 otherwise).
        diag_scale: symmetric per-dof diagonal scaling (PCG) or
            equilibration (Cholesky) of the cell systems.
        matmul_precision: accepted for the reference's signature; the port
            computes float32 matmuls in full float32 whatever it says
            (TF32 stays off).
        micro_degree: 1 (P1) or 2 (P2 micro elements: no periodic stencil,
            so no K1 and no 'fft' or 'mg' cell preconditioner).
        coeff_rank: declared rank of a low-rank scalar coefficient
            Σ_k f_k(x) g_k(y) (0: off); see :meth:`check_coeff_rank`.
        cell_prec: 'k0inv' (the shared K0⁻¹) | 'fft' (the DFT symbol of
            the cell's volume-mean coefficient, exact for a constant
            coefficient; structured box meshes, P1; weak on strongly
            heterogeneous elasticity) | 'mg' (the torus multigrid V-cycle,
            structured box meshes, P1).
        chol_backend: 'auto' | 'xla' | 'blocked', accepted for the
            reference's signature: on every backend the port's chunk
            Cholesky is the kernel K3 on the card (float32) and the plain
            blocked solve elsewhere, the per-cell Cholesky ``torch.linalg``.
        mg_nu: Chebyshev smoothing degree of ``cell_prec='mg'`` (0: 2 for
            scalar problems, 4 for vector ones).

    Routes (``tensors_for_centers``): the chunk PCG (micro/chunk.py) for
    ``solver='pcg'`` with a matrix-free strategy, an FFT or MG cell
    preconditioner or a declared coefficient rank — the scalar stencil
    PCG (kernel K1 on the card, K0⁻¹ only), the block stencil or
    matrix-free gather matvec, the dense-K matvec, with the K0⁻¹, FFT or
    multigrid preconditioner; the chunk Cholesky (kernel K3 on the card)
    for vector problems on ``solver='cholesky'``; the per-cell route
    (micro/percell.py, ``torch.linalg``) for the rest.
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
        pcg_strategy: Optional[str] = None,
        pcg_tol: Optional[float] = None,
        pcg_maxiter: int = 1500,
        diag_scale: bool = True,
        matmul_precision: Optional[str] = None,
        micro_degree: int = 1,
        coeff_rank: int = 0,
        cell_prec: str = "k0inv",
        chol_backend: str = "auto",
        mg_nu: int = 0,
    ):
        # the constructor's arguments, for the replicas on other devices
        self._ctor = {k: v for k, v in locals().items() if k != "self"}
        self._replicas: dict = {}
        d = micro_mesh.dim
        bs = int(bs)
        if bs not in (1, d):
            raise ValueError("bs must be 1 (scalar) or dim (vector)")
        if micro_degree not in (1, 2):
            raise ValueError("micro_degree must be 1 or 2")
        if coeff_kind not in ("scalar", "matrix", "tensor4"):
            raise ValueError("coeff_kind must be 'scalar', 'matrix' or 'tensor4'")
        if coeff_kind not in (("scalar", "matrix") if bs == 1 else ("tensor4",)):
            raise NotImplementedError(
                f"coeff_kind={coeff_kind!r} with bs={bs}: the port takes scalar and (d, d) "
                "coefficients on scalar problems and (d, d, d, d) ones on vector problems"
            )
        if cell_prec not in ("k0inv", "fft", "mg"):
            raise ValueError("cell_prec must be 'k0inv', 'fft' or 'mg'")
        if chol_backend not in ("auto", "xla", "blocked"):
            raise ValueError("chol_backend must be 'auto'|'xla'|'blocked'")
        self.mesh = micro_mesh
        self.device = as_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.bs = bs
        self.coeff_kind = coeff_kind
        self.quad_degree = int(quad_degree)
        self.micro_degree = int(micro_degree)
        self.d = d
        self.r = d if bs == 1 else d * d  # gradient components per element
        # generator problems SOLVED per cell: d for scalar, the Voigt set
        # d(d+1)/2 for elasticity, expanded back to d² on output
        self.s = d if bs == 1 else d * (d + 1) // 2
        self.s_full = d if bs == 1 else d * d
        if self.micro_degree == 2:
            # the P2 nodes (vertices, then edge midpoints) fold by the
            # vertices' rule
            V = FunctionSpace(micro_mesh, 1, degree=2)
            self._node_cells = V.cell_nodes()
            self.pmap = build_periodic_map_points(V.tabulate_dof_coordinates())
        else:
            self._node_cells = micro_mesh.cells
            self.pmap = build_periodic_map(micro_mesh)
        self.n_reduced = self.pmap.n_reduced * bs
        self.volume_Y = micro_mesh.volume()
        if assembly == "auto":
            if bs > 1 and self.dtype == torch.float32:
                assembly = "scatter"
            else:
                assembly = "dense" if self.n_reduced <= 512 else "scatter"
        self.assembly = assembly
        if solver == "auto":
            # scalar float32: the chunk PCG; everything else, float64
            # included: Cholesky (the reference's rule)
            scalar_f32 = self.dtype == torch.float32 and coeff_kind == "scalar" and bs == 1
            solver = "pcg" if scalar_f32 else "cholesky"
        if solver not in ("pcg", "cholesky"):
            raise ValueError("solver must be 'auto', 'pcg' or 'cholesky'")
        self.solver = solver
        if pcg_strategy is None:
            pcg_strategy = "matfree" if coeff_kind == "scalar" and bs == 1 else "densek"
        if pcg_strategy not in ("densek", "matfree"):
            raise ValueError("pcg_strategy must be 'densek' or 'matfree'")
        self.pcg_strategy = pcg_strategy
        if pcg_tol is None:
            pcg_tol = 1e-5 if self.dtype == torch.float32 else 1e-11
        self.pcg_tol = float(pcg_tol)
        self.pcg_maxiter = int(pcg_maxiter)
        self.diag_scale = bool(diag_scale)
        if matmul_precision is None and (bs > 1 or coeff_kind != "scalar"):
            matmul_precision = "highest"
        self.matmul_precision = matmul_precision
        self.chol_backend = chol_backend
        self.coeff_rank = int(coeff_rank)
        self.cell_prec = cell_prec
        self.mg_nu = int(mg_nu)
        self._K0inv = None
        self._K0diag = None
        self._kron_M = None
        self._fft_syms = None
        self._sym_expand_dev: dict = {}  # the Voigt index's copy on each device
        # the kernels' size limits, checked before any device or coefficient work
        on_card_f32 = self.device.type == "cuda" and self.dtype == torch.float32
        if on_card_f32 and self._chol_route():
            check_k3_fits(self.n_reduced, self.s)
        if on_card_f32 and self._k1_route():
            check_k1_fits(self.n_reduced, self.s)
        from hommx_tpu_torch.micro.percell import build_operators

        build_operators(self)

    def replica(self, device) -> "MicroEngine":
        """This engine on ``device``: itself where ``device`` is its own,
        else an engine built with the same arguments there, once per
        device (a shard of a multi-device solve holds its own copy of the
        operators, the stencil weights and the gather tables)."""
        device = as_device(device)
        if same_device(device, self.device):
            return self
        key = str(device)
        if key not in self._replicas:
            self._replicas[key] = MicroEngine(**{**self._ctor, "device": device,
                                                 "dtype": self.dtype})
        return self._replicas[key]

    # -- routes ----------------------------------------------------------------
    def _use_chunk(self) -> bool:
        """Whether ``solver='pcg'`` runs the chunk PCG (the per-cell route
        takes the rest): a matrix-free strategy, an FFT or MG cell
        preconditioner, or a declared rank of a scalar coefficient."""
        return (
            self.pcg_strategy == "matfree"
            or self.cell_prec in ("fft", "mg")
            or (self.coeff_rank > 0 and self.coeff_kind == "scalar")
        )

    def _chol_route(self) -> bool:
        """The chunk Cholesky route: vector problems on ``solver='cholesky'``
        (in every dtype; the reference takes it in float32 only)."""
        return self.solver == "cholesky" and self.bs > 1

    def _k1_route(self) -> bool:
        """Whether ``tensors_for_centers`` launches K1: the chunk PCG of a
        scalar coefficient on a scalar problem with the shared K0⁻¹
        preconditioner on the periodic stencil (a structured box mesh, and
        ``HOMMX_MICRO_MATVEC`` not 'matfree').  Host data only: the engine
        asks before it builds its operators."""
        return (
            self.solver == "pcg"
            and self._use_chunk()
            and self.coeff_kind == "scalar"
            and self.bs == 1
            and self.cell_prec == "k0inv"
            and micro_matvec_mode() == "auto"
            and torus_coords(self) is not None
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

    def _static(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The engine's static operator ``name`` ('Draw' or 'D') in the
        dtype and on the device of ``like``."""
        t = getattr(self, name)
        if t.dtype == like.dtype and t.device == like.device:
            return t
        return torch.as_tensor(getattr(self, name + "_np"), dtype=like.dtype, device=like.device)

    def _assemble_dense(self, A_K: torch.Tensor) -> torch.Tensor:
        """K = D_flatᵀ (A_K D)_flat over (nE·r, nred) for element blocks
        A_K (..., nE, r, r), on A_K's device: (..., n, n)."""
        D = self._static("D", A_K)
        Z = torch.einsum("...ert,etn->...ern", A_K, D)
        nE, r, nred = D.shape
        return D.reshape(nE * r, nred).T @ Z.reshape(*Z.shape[:-3], nE * r, nred)

    def _assemble_scatter(self, A_K: torch.Tensor) -> torch.Tensor:
        """Per-element (nbl, nbl) blocks of A_K (..., nE, r, r) summed into
        the dense reduced operators (..., n, n) on A_K's device: a
        scatter-add, or on an engine whose Kc assembly is the gather
        (micro/chunk.py::kc_assembly_mode, the CUDA default) the same sum in
        a fixed order."""
        from hommx_tpu_torch.micro.chunk import _get_kc_gather

        Draw = self._static("Draw", A_K)
        lead = A_K.shape[:-3]
        vals = torch.einsum("erl,...ert,etm->...elm", Draw, A_K, Draw).reshape(*lead, -1)
        n = self.n_reduced
        # the host build of K0 takes the scatter, which is in order there
        kcg = _get_kc_gather(self) if A_K.device.type == self.device.type else None
        if kcg is not None:
            return kcg.pattern.place(gather_sum(vals, kcg.plan))
        l2r = torch.as_tensor(self.loc2red_np, device=A_K.device)
        flat = (l2r[:, :, None] * n + l2r[:, None, :]).reshape(-1)
        K = torch.zeros(*lead, n * n, dtype=A_K.dtype, device=A_K.device)
        return K.index_add(-1, flat, vals).reshape(*lead, n, n)

    def _get_stencil(self):
        from hommx_tpu_torch.micro.chunk import _get_stencil

        return _get_stencil(self)

    def _sym_index(self, device: torch.device) -> torch.Tensor:
        """The Voigt index ``sym_expand`` on ``device``, copied there at its
        first use only: a copy from the host to a card waits for the card,
        and a chunk loop that made one a chunk would stall it."""
        e = self._sym_expand_dev.get(device)
        if e is None:
            e = self._sym_expand_dev[device] = torch.as_tensor(self.sym_expand, device=device)
        return e

    def _expand_astar(self, A: torch.Tensor) -> torch.Tensor:
        """Voigt (…, s, s) → full (…, d², d²) tensor layout (exact: the
        expanded entries are duplicates by minor symmetry)."""
        if self.sym_expand is None:
            return A
        e = self._sym_index(A.device)
        return A[..., e[:, None], e[None, :]]

    def _expand_cols(self, X: torch.Tensor) -> torch.Tensor:
        """Voigt (…, s) correctors → full (…, d²) column layout."""
        if self.sym_expand is None:
            return X
        return X[..., self._sym_index(X.device)]

    # -- the per-cell route (micro/percell.py) -------------------------------
    def element_coeff(self, coeff: Callable, x_center) -> torch.Tensor:
        """Ā_e = Σ_q w_eq A(c_T, y_eq) in canonical (nE, r, r) matrix form
        (a scalar coefficient becomes ā_e·I)."""
        x_center = torch.as_tensor(x_center, device=self.device)
        if not x_center.is_floating_point():
            x_center = x_center.to(torch.float64)
        a = self._raw_coeff(coeff, x_center)
        if self.coeff_kind == "scalar":
            return a[:, None, None] * torch.eye(self.r, dtype=self.dtype, device=self.device)
        return a

    def cell_tensor(self, Ae: torch.Tensor, G: Optional[torch.Tensor] = None):
        """A* (s_full, s_full) and the generator correctors X (n, s_full)
        of one macro point by the per-cell route: dense K, then Cholesky
        or block-PCG (micro/percell.py::cell_tensor)."""
        from hommx_tpu_torch.micro.percell import cell_tensor

        return cell_tensor(self, Ae, G)

    def solve_periodic(self, coeff, rhs=None, grad_rhs=None, x_center=None) -> torch.Tensor:
        """The general periodic variational solve a(u, v) = L(v) on the
        unit cell (micro/percell.py::solve_periodic)."""
        from hommx_tpu_torch.micro.percell import solve_periodic

        return solve_periodic(self, coeff, rhs, grad_rhs, x_center)

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
    def tensors_for_centers(
        self,
        coeff: Callable,
        centers,
        G_fn=None,
        chunk: int = 0,
        with_correctors: bool = False,
        implicit_diff: bool = True,
    ):
        """A*(c_T) (nc, s_full, s_full) for a batch of macro cell centers
        (nc, d); ``G_fn`` is the optional Dθᵀ(x) map of the stratified
        variants.  With ``with_correctors`` also the correctors (nc, n,
        s_full), the solves of the (unscaled) cell systems in the full
        generator layout.

        The route follows the reference's rule: the chunk Cholesky for
        vector problems on ``solver='cholesky'`` (with
        ``HOMMX_CHOL_SOLVE_BATCH=1``, one solve over the whole batch), the
        chunk PCG where :meth:`_use_chunk` says so, the per-cell route for
        the rest.  Centers on another device of the engine's device type (a
        shard's block) are solved there, by :meth:`replica`.

        The result is differentiable in every tensor the coefficient (or
        ``G_fn``) closes over, and in ``centers``.  The chunk routes' solves
        run under the implicit-function rule, whose adjoint is one more
        solve by the same route (K1 or K3 on the card); the per-cell route
        is differentiated by autograd through ``torch.linalg`` or its
        unrolled PCG.  With ``implicit_diff=False`` the solves carry no
        gradient (the reference's shard_map micro stage)."""
        from hommx_tpu_torch.micro.chunk import (
            tensors_chol_batched,
            tensors_chunk_chol,
            tensors_chunk_pcg,
        )
        from hommx_tpu_torch.micro.percell import tensors_percell

        if (isinstance(centers, torch.Tensor) and centers.device.type == self.device.type
                and not same_device(centers.device, self.device)):
            # a shard's block runs on the block's own device
            return self.replica(centers.device).tensors_for_centers(
                coeff, centers, G_fn, chunk, with_correctors, implicit_diff)
        centers = torch.as_tensor(centers, device=self.device).to(self.dtype)
        nc = centers.shape[0]
        chunk = chunk or self._auto_chunk(nc)
        if self._chol_route():
            if (
                not with_correctors
                and os.environ.get("HOMMX_CHOL_SOLVE_BATCH", "0") == "1"
                and self._chol_batch_fits(nc)
            ):
                return tensors_chol_batched(self, coeff, centers, G_fn, chunk, implicit_diff)
            route = tensors_chunk_chol
        elif self.solver == "pcg" and self._use_chunk():
            route = tensors_chunk_pcg
        else:
            route = tensors_percell
        if not with_correctors:
            return _map_chunked(
                lambda cs: route(self, coeff, cs, G_fn, implicit_diff=implicit_diff), centers, chunk
            )

        def fn(cs):
            A, X = route(self, coeff, cs, G_fn, with_correctors=True, implicit_diff=implicit_diff)
            return A, self._expand_cols(X.permute(2, 0, 1))

        return _map_chunked(fn, centers, chunk)

    def tensors_chunk_pcg(self, coeff, centers, G_fn=None, with_correctors=False,
                          with_iters=False, implicit_diff=True):
        """A*(c_T) (C, s_full, s_full) of one chunk by the chunk PCG
        (micro/chunk.py::tensors_chunk_pcg), whatever ``_use_chunk`` says;
        with ``with_correctors`` also X (C, n, s_full), with ``with_iters``
        the lockstep iteration count (the whole chunk iterates until its
        worst column converges)."""
        from hommx_tpu_torch.micro.chunk import tensors_chunk_pcg

        centers = torch.as_tensor(centers, device=self.device).to(self.dtype)
        out = tensors_chunk_pcg(self, coeff, centers, G_fn, with_correctors=with_correctors,
                                implicit_diff=implicit_diff, with_iters=with_iters)
        if not isinstance(out, tuple):
            return out
        out = list(out)
        if with_correctors:
            out[1] = self._expand_cols(out[1].permute(2, 0, 1))
        return tuple(out)

    def check_coeff_rank(self, coeff, centers, rank: Optional[int] = None) -> float:
        """Host-side residual of the rank-R interpolative factorization of
        the reduced coefficient a(c, e) over the given centers, relative to
        max |a| (the reference's check, float64).  A residual at rounding
        level means the declared rank covers the coefficient and the
        low-rank path (``coeff_rank``) is exact; a large one means it must
        not be used."""
        rank = rank or self.coeff_rank or 1
        centers = torch.as_tensor(centers, device=self.device).to(self.dtype)
        with torch.no_grad():
            a = torch.func.vmap(lambda x: self._raw_coeff(coeff, x))(centers)
        a = a.detach().cpu().numpy().astype(np.float64)
        if a.ndim != 2:
            raise ValueError("coeff_rank applies to scalar coefficients only")
        nc = a.shape[0]
        anchors = np.linspace(0, nc - 1, min(rank, nc)).astype(int)
        V = a[anchors]
        U = np.linalg.pinv(V @ V.T, rcond=1e-12) @ (V @ a.T)
        return float(np.abs(a - U.T @ V).max() / max(np.abs(a).max(), 1e-300))

    def _get_fft_symbols(self):
        from hommx_tpu_torch.micro.chunk import _get_fft_symbols

        return _get_fft_symbols(self)

    def _get_block_stencil(self):
        from hommx_tpu_torch.micro.chunk import _get_block_stencil

        return _get_block_stencil(self)

    def _get_mg_levels(self, offsets, shape):
        from hommx_tpu_torch.micro.chunk import _get_mg_levels

        return _get_mg_levels(self, offsets, shape)

    def _k3_workspace_bytes(self) -> int:
        """Global workspace a cell of K3's large instance takes (its packed
        lower tiles and right-hand sides), where this engine's solves run
        it (a float32 CUDA engine on the Cholesky route above the small
        instance's reach); else 0."""
        if not (self.device.type == "cuda" and self.dtype == torch.float32
                and self._chol_route()):
            return 0
        return chol_launch_config(self.n_reduced, self.s).workspace_bytes

    def _chol_batch_fits(self, nc: int) -> bool:
        """Whether ``HOMMX_CHOL_SOLVE_BATCH=1`` may solve ``nc`` cells in one
        batch: the resident operators and the solve's panels, 2·nc·n²
        values, and the workspace of K3's large instance, within 6 GB (past
        it the in-chunk route takes the batch)."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_cell = 2 * self.n_reduced**2 * itemsize + self._k3_workspace_bytes()
        return nc * per_cell <= (6 << 30)

    def _auto_chunk(self, nc: int) -> int:
        """Chunk size by the reference's rules: per-cell work arrays under
        a memory budget, equal chunks.  The chunk routes keep 1 GB and a cap
        of 2048 (the lockstep PCG iterates until a chunk's worst cell
        converges), the chunk Cholesky 4 GB and 4096, and count the dense
        per-cell operators where they hold them; the per-cell route counts
        its dense K and the dense-D intermediate.  Where K3's large instance
        runs, its per-cell workspace counts too.  The reference doubles the
        itemsize of float64 for the TPU's emulated float64; native float64
        here takes its real size."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        n = self.n_reduced
        chol = self._chol_route()
        if self.solver == "pcg" or chol:
            per_cell = (16 * self.nE * self.r * self.s + 10 * n * self.s) * itemsize
            if (self.pcg_strategy == "densek" or chol) and self.coeff_kind != "scalar":
                per_cell += ((4 if chol else 2) * n * n + self.nE * self.nbl * self.nbl) * itemsize
            if chol:
                per_cell += self._k3_workspace_bytes()
            budget, cap = ((4 << 30), 4096) if chol else ((1 << 30), 2048)
            limit = int(np.clip(budget // max(per_cell, 1), 1, min(nc, cap)))
            if nc > limit:
                limit = int(np.ceil(nc / np.ceil(nc / limit)))
            return limit
        z_term = self.nE * self.r * n if self.D is not None and self.assembly == "dense" else 0
        per_cell = (2 * n * n + 2 * z_term + 4 * self.nE * self.r * max(self.r, self.nbl)) * itemsize
        return int(np.clip((1 << 30) // max(per_cell, 1), 1, max(nc, 1)))
