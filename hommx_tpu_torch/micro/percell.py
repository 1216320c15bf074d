"""Static operator construction and the per-cell solve route of the micro
engine (torch port of ``hommx_tpu/micro/percell.py``, P1 and P2, scalar
and vector dofs).

``build_operators`` runs once at engine construction on the host: the
per-element gradient operators, the reduced dof map, the generator fields
(the Voigt set for elasticity) and the nullspace pinning, then K0⁻¹ where a
PCG with the shared K0⁻¹ preconditioner needs it and diag(K0) elsewhere
(at 16³ elasticity, n = 12,288, a dense K0⁻¹ must not be built).

``tensors_percell`` is the reference's per-cell (vmapped) route, batched
over a chunk of macro points: the dense reduced operators K (C, n, n) and a
Cholesky factorization (float32: equilibrated, plus one refinement sweep),
or the block-PCG preconditioned by K0⁻¹ on the assembled K
(``pcg_strategy='densek'``) or on the matrix-free operator.  The reference
runs it with ``jax.scipy.linalg`` and no Pallas kernel; ``torch.linalg``
runs it here, on either device.  ``cell_tensor`` is the same route for one
point.  ``solve_periodic`` is the general periodic variational solve a(u, v)
= L(v) on the unit cell: a dense Cholesky up to 4096 reduced dofs, above it
the one-cell PCG on the block stencil with the torus multigrid on
structured meshes (micro/block_stencil.py, micro/mg_prec.py) and on the
matrix-free operator with Jacobi otherwise.  Scatters onto the reduced dofs
run in a fixed order where the engine's Kc assembly is the gather (the CUDA
default).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hommx_tpu_torch.micro.engine import _sym_map
from hommx_tpu_torch.micro.krylov import _block_pcg_matfree, _chunk_pcg_raw
from hommx_tpu_torch.ops.assembly import gather_sum
from hommx_tpu_torch.ops.elements import cell_geometry, quad_points_physical

__all__ = ["build_operators", "cell_tensor", "solve_periodic"]

#: largest reduced space ``solve_periodic`` factorizes densely
_DENSE_MAX = 4096


def build_operators(eng):
    mesh, d, bs = eng.mesh, eng.d, eng.bs
    # geometry in f64 regardless of the compute dtype: quadrature-point
    # coordinates feed the user coefficient, and discontinuous
    # coefficients are knife-edge sensitive to point placement
    verts = torch.as_tensor(mesh.vertices, dtype=torch.float64)
    cells = torch.as_tensor(mesh.cells)
    grads, _ = cell_geometry(verts, cells)  # (ne, d+1, d)
    quad_degree = eng.quad_degree
    if eng.micro_degree == 2:
        quad_degree = max(quad_degree, 2)  # ∇P2·∇P2 integrands are quadratic
    xq, wq, lam_q = quad_points_physical(verts, cells, quad_degree)
    ne, nq = wq.shape
    grads_np = grads.numpy()

    red = eng.pmap.reduced_index  # (n_nodes,)
    node_cells = eng._node_cells  # (ne, nnd): P1 vertices or P2 nodes
    nnd = node_cells.shape[1]
    nbl = nnd * bs  # local dofs per micro element
    eng.nbl = nbl

    if eng.micro_degree == 2:
        # P2 gradients vary over an element, so quadrature cannot fold into
        # the element coefficient; each (element, q) pair becomes an
        # effective element with the constant gradients ∇φ_k(x_q) =
        # Σ_i c[q,k,i]·∇λ_i and weight w_eq, and every later stage runs
        # unchanged with nE = ne·nq
        from hommx_tpu_torch.ops.p2 import p2_basis

        phi, dlam = p2_basis(lam_q[:, 1:], d)  # (nq, nnd), (nq, nnd, d+1)
        node_grads = np.einsum("qki,eid->eqkd", dlam.numpy(), grads_np).reshape(ne * nq, nnd, d)
        node_cells = np.repeat(node_cells, nq, axis=0)  # (ne·nq, nnd)
        eng.yq = xq.numpy().reshape(ne * nq, 1, d)
        eng.wq = wq.numpy().reshape(ne * nq, 1)
        # P2 basis values at the points, one row per effective element
        eng.phi_q = np.tile(phi.numpy(), (ne, 1)).reshape(ne * nq, 1, nnd)
        ne, nq = ne * nq, 1
    else:
        # P1 gradients are elementwise constant, so quadrature folds into
        # the element coefficient
        node_grads = grads_np
        eng.yq = xq.numpy()  # (ne, nq, d) quadrature points (f64)
        eng.wq = wq.numpy()  # (ne, nq) weights, sum = |Y|
        # P1 basis values at the quadrature points (the barycentric
        # coordinates, shared by the elements) for solve_periodic's loads
        eng.phi_q = np.broadcast_to(lam_q.numpy()[None], (ne, nq, d + 1)).copy()
    # local gradient operator Draw: (ne, r, nbl)
    Draw = np.zeros((ne, eng.r, nbl), dtype=np.float64)
    for a in range(nnd):
        if bs == 1:
            Draw[:, :, a] = node_grads[:, a, :]
        else:
            for i in range(bs):
                # component i of vector dof (a, i) contributes grad_a[j] to
                # gradient entry H_ij (row i*d + j)
                Draw[:, i * d : (i + 1) * d, a * bs + i] = node_grads[:, a, :]
    eng.nE, eng.nq = ne, nq
    eng.Draw_np = Draw
    eng.Draw = torch.as_tensor(Draw, dtype=eng.dtype, device=eng.device)

    # local -> reduced dof map (ne, nbl)
    red_cells = red[node_cells]  # (ne, nnd)
    if bs == 1:
        loc2red = red_cells
    else:
        comp = np.arange(bs)
        loc2red = (red_cells[:, :, None] * bs + comp[None, None, :]).reshape(ne, nbl)
    eng.loc2red_np = loc2red
    eng.loc2red = torch.as_tensor(loc2red, device=eng.device)

    nred = eng.n_reduced
    # dense reduced gradient operator D (ne, r, nred), shared by all cells
    if ne * eng.r * nred <= 5e7:
        D = np.zeros((ne, eng.r, nred), dtype=np.float64)
        e_idx = np.arange(ne)[:, None, None]
        r_idx = np.arange(eng.r)[None, :, None]
        np.add.at(D, (e_idx, r_idx, loc2red[:, None, :]), Draw)
        eng.D_np = D
        eng.D = torch.as_tensor(D, dtype=eng.dtype, device=eng.device)
    else:
        eng.D_np = eng.D = None
    if eng.assembly == "dense" and eng.D is None:
        raise ValueError("dense assembly requested but operator too large")

    # generator fields E: (r, s) — the Voigt set for elasticity (the
    # distinct symmetrized generators), with the map back to the full
    # (k·d + l) column layout
    if bs == 1:
        E = np.eye(d)
        eng.sym_expand = None
    else:
        pairs = [(k, l) for k in range(d) for l in range(k, d)]
        E = np.zeros((d * d, len(pairs)))
        for j, (k, l) in enumerate(pairs):
            Ekl = np.zeros((d, d))
            Ekl[k, l] += 0.5
            Ekl[l, k] += 0.5
            E[:, j] = Ekl.reshape(-1)
        eng.sym_expand = np.asarray(
            [pairs.index((min(k, l), max(k, l))) for k in range(d) for l in range(d)]
        )
    eng.E_np = E
    eng.E = torch.as_tensor(E, dtype=eng.dtype, device=eng.device)

    # nullspace pinning: the bs dofs of reduced node 0
    pin = np.zeros(nred, dtype=bool)
    pin[:bs] = True
    eng.pin_np = pin
    eng.pin_mask = torch.as_tensor(pin, device=eng.device)
    # quadrature COORDINATES stay f64; everything downstream of coefficient
    # VALUES uses the compute dtype
    eng.yq_dev = torch.as_tensor(eng.yq, dtype=torch.float64, device=eng.device)
    eng.wq_dev = torch.as_tensor(eng.wq, dtype=eng.dtype, device=eng.device)
    eng._eye_sym = (
        _sym_map(torch.eye(d, dtype=eng.dtype, device=eng.device)) if bs > 1 else None
    )
    # built eagerly on the host: K0⁻¹ for a PCG preconditioned by it; else
    # diag(K0) alone, the reference scale of the diagonal scaling (a dense
    # K0 of a 16³ elasticity cell is infeasible); the FFT symbols
    if eng.solver == "pcg" and eng.cell_prec == "k0inv":
        eng._get_K0inv()
    elif eng.solver == "pcg" or eng.diag_scale:
        eng._get_K0diag()
    if eng.cell_prec == "fft":
        eng._get_fft_symbols()


def _to_reduced(eng, vals: torch.Tensor) -> torch.Tensor:
    """Σ over local dofs onto reduced dofs: (nE·nbl, k) -> (n, k), in the
    gather's fixed order where the engine has the gather tables."""
    from hommx_tpu_torch.micro.chunk import _get_kc_gather

    kcg = _get_kc_gather(eng)
    if kcg is not None:
        return gather_sum(vals.T, kcg.fc_plan).T
    out = vals.new_zeros((eng.n_reduced, vals.shape[1]))
    return out.index_add_(0, eng.loc2red.reshape(-1), vals)


def _expand(eng, cols: torch.Tensor) -> torch.Tensor:
    """Gradient fields of reduced-dof columns: (n, s, C) -> (nE, r, s, C),
    through the dense D, or (large cells) a gather of the local dofs and the
    element blocks Draw."""
    n, s, C = cols.shape
    if eng.D is not None:
        return (eng.D.reshape(-1, n) @ cols.reshape(n, s * C)).reshape(eng.nE, eng.r, s, C)
    return torch.einsum("erl,elsc->ersc", eng.Draw, cols[eng.loc2red])


def _reduce(eng, fields: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`_expand`: (nE, r, s, C) -> (n, s, C)."""
    nE, r, s, C = fields.shape
    if eng.D is not None:
        return (eng.D.reshape(nE * r, -1).T @ fields.reshape(nE * r, s * C)).reshape(-1, s, C)
    wl = torch.einsum("erl,ersc->elsc", eng.Draw, fields)
    return _to_reduced(eng, wl.reshape(nE * eng.nbl, s * C)).reshape(-1, s, C)


def _exact_diag(eng, A_K: torch.Tensor) -> torch.Tensor:
    """diag(K) (n, C) of the element blocks A_K (C, nE, r, r), K never
    formed."""
    if eng.D is not None:
        return torch.einsum("ern,cert,etn->nc", eng.D, A_K, eng.D)
    dl = torch.einsum("erl,cert,etl->elc", eng.Draw, A_K, eng.Draw)
    return _to_reduced(eng, dl.reshape(eng.nE * eng.nbl, -1))


def _gather_matvec(eng, A_K: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """K·P per cell with K = D̃ᵀ(A_K ∘ D̃·) never formed: A_K (C, nE, r, r),
    P (n, s, C); the pinned dofs carry the identity."""
    keep = (~eng.pin_mask).to(P.dtype)[:, None, None]
    pinf = eng.pin_mask.to(P.dtype)[:, None, None]
    Kp = _reduce(eng, torch.einsum("cert,etsc->ersc", A_K, _expand(eng, P * keep)))
    return Kp * keep + pinf * P


def _pinned_dense(eng, A_K: torch.Tensor, dense: bool) -> torch.Tensor:
    """The reduced operators of the element blocks A_K (..., nE, r, r),
    (..., n, n), with the identity on the pinned dofs."""
    K = eng._assemble_dense(A_K) if dense else eng._assemble_scatter(A_K)
    keep = (~eng.pin_mask).to(K.dtype)
    return K * keep[:, None] * keep[None, :] + torch.diag(eng.pin_mask.to(K.dtype))


def tensors_percell(eng, coeff, centers, G_fn=None, with_correctors=False, implicit_diff=True):
    """A*(c_T) (C, s_full, s_full) of one chunk of centers (C, d) by the
    per-cell route, and with ``with_correctors`` the solves X (n, s, C).
    Autograd differentiates it (``torch.linalg`` or the unrolled PCG);
    with ``implicit_diff=False`` the solves carry no gradient."""
    a = torch.func.vmap(lambda x: eng._raw_coeff(coeff, x))(centers)
    if eng.coeff_kind == "scalar":
        a = a[..., None, None] * torch.eye(eng.r, dtype=eng.dtype, device=eng.device)
    G = None
    if G_fn is not None:
        G = torch.func.vmap(lambda x: torch.as_tensor(G_fn(x), device=x.device).to(eng.dtype))(
            centers)
    A, X = _percell(eng, a, G, implicit_diff)
    return (A, X.permute(1, 2, 0)) if with_correctors else A


def cell_tensor(eng, Ae: torch.Tensor, G: Optional[torch.Tensor] = None):
    """Homogenized tensor A* (s_full, s_full) and generator correctors X
    (n, s_full) of one macro point (``hommx_tpu/micro/percell.py:191-325``).

    Ae: (nE, r, r) per-element reduced coefficient (``element_coeff``).
    G:  optional Dθᵀ(c_T) gradient map (stratified variants).
    """
    Ae = torch.as_tensor(Ae, device=eng.device).to(eng.dtype)
    if G is not None:
        G = torch.as_tensor(G, device=eng.device).to(eng.dtype)[None]
    A, X = _percell(eng, Ae[None], G)
    return A[0], eng._expand_cols(X[0])


def _percell(eng, Ae: torch.Tensor, G: Optional[torch.Tensor], implicit_diff: bool = True):
    """(A* (C, s_full, s_full), X (C, n, s)) of the element coefficients Ae
    (C, nE, r, r) and the maps G (C, d, d) or None."""
    C, nE, r, _ = Ae.shape
    s, n = eng.s, eng.n_reduced
    T = eng._grad_map(G)
    if T is not None and T.ndim == 2:
        T = T.expand(C, r, r)
    # test/trial-mapped element blocks: K-side TᵀĀT, F-side TᵀĀ
    if T is None:
        A_K = A_F = Ae
    else:
        A_K = torch.einsum("cmr,cemt,ctn->cern", T, Ae, T)
        A_F = torch.einsum("cmr,cemt->cert", T, Ae)
    # loads F = −Σ_e D_eᵀ (TᵀĀ_e) E, the pinned dofs zeroed: (C, n, s)
    F_loc = -torch.einsum("erl,cert,ts->elcs", eng.Draw, A_F, eng.E)
    F = _to_reduced(eng, F_loc.reshape(nE * eng.nbl, C * s)).reshape(n, C, s).transpose(0, 1)
    keep = (~eng.pin_mask).to(eng.dtype)
    F = F * keep[:, None]

    with torch.set_grad_enabled(torch.is_grad_enabled() and implicit_diff):
        if eng.solver == "cholesky":
            K = _pinned_dense(eng, A_K, eng.assembly == "dense")
            if eng.dtype == torch.float32 and eng.diag_scale:
                # float32: symmetric equilibration Ks = S K S and one
                # refinement sweep against K
                sc = eng._scale_from_diag(torch.diagonal(K, dim1=1, dim2=2).T).T[:, :, None]
                L = torch.linalg.cholesky_ex(sc * K * sc.transpose(1, 2)).L
                X = sc * torch.cholesky_solve(sc * F, L)
                X = X + sc * torch.cholesky_solve(sc * (F - K @ X), L)
            else:
                X = torch.cholesky_solve(F, torch.linalg.cholesky_ex(K).L)
        else:
            # block-PCG with K0⁻¹ per cell, in the chunk loop's (n, s, C)
            # layout: on the assembled K (densek) or matrix-free
            if eng.pcg_strategy == "densek":
                K = _pinned_dense(eng, A_K, eng.assembly == "dense")
                matvec = lambda P: torch.einsum("cnm,msc->nsc", K, P)  # noqa: E731
                dg = torch.diagonal(K, dim1=1, dim2=2).T
            else:
                matvec = lambda P: _gather_matvec(eng, A_K, P)  # noqa: E731
                dg = _exact_diag(eng, A_K)
            Fp = F.permute(1, 2, 0)
            Minv = eng._get_K0inv()
            if eng.diag_scale:
                sc = eng._scale_from_diag(dg)[:, None, :]
                Xp = sc * _block_pcg_matfree(lambda P: sc * matvec(sc * P), sc * Fp, Minv,
                                             eng.pcg_tol, eng.pcg_maxiter)
            else:
                Xp = _block_pcg_matfree(matvec, Fp, Minv, eng.pcg_tol, eng.pcg_maxiter)
            X = Xp.permute(2, 0, 1)

    # corrected element fields Φ_e = E + T D_e X_loc, then
    # A*[n, m] = (1/|Y|) Σ_e Φ[:, n]ᵀ Ā_e Φ[:, m]
    DX = torch.einsum("erl,cels->cers", eng.Draw, X[:, eng.loc2red])
    if T is not None:
        DX = torch.einsum("crt,cets->cers", T, DX)
    Phi = eng.E + DX
    Astar = torch.einsum("cern,cert,cetm->cnm", Phi, Ae, Phi) / eng.volume_Y
    return eng._expand_astar(Astar), X


def _at_quad_points(eng, fn) -> torch.Tensor:
    """``fn(y)`` at every micro quadrature point, (nE, nq, ...) in the
    engine's dtype."""
    def one(y):
        return torch.as_tensor(fn(y), device=y.device).to(eng.dtype)

    return torch.func.vmap(torch.func.vmap(one))(eng.yq_dev)


def solve_periodic(eng, coeff, rhs=None, grad_rhs=None, x_center=None) -> torch.Tensor:
    """Periodic variational solve on the unit cell Y
    (``hommx_tpu/micro/percell.py:326-477``):

        ∫_Y ∇v · A(x₀, y) ∇u dy = ∫_Y f(y)·v dy + ∫_Y g(y)·∇v dy

    on the reduced periodic space with the nullspace pinned (the bs dofs of
    reduced vertex 0); as in the reference, the f term must be compatible
    (zero total force per component).

    Args:
        coeff: the engine's coefficient A(x, y) (scalar or (d,d,d,d),
            matching ``coeff_kind``).
        rhs: optional load f(y) -> scalar (bs = 1) or (bs,).
        grad_rhs: optional gradient-weighted load g(y) -> (r,) (r = d, or
            the d² flattened gradient rows of a vector problem).
        x_center: the macro point x₀ passed to the coefficient (default 0).

    Returns:
        u on the FULL periodic node set, (n_nodes·bs,).
    """
    if rhs is None and grad_rhs is None:
        raise ValueError("solve_periodic needs rhs and/or grad_rhs")
    x0 = (
        torch.zeros(eng.d, dtype=torch.float64, device=eng.device)
        if x_center is None
        else torch.as_tensor(x_center, dtype=torch.float64, device=eng.device)
    )
    Ae = eng.element_coeff(coeff, x0)  # (nE, r, r)
    n, bs = eng.n_reduced, eng.bs
    wq = eng.wq_dev  # (nE, nq)
    b = torch.zeros(n, dtype=eng.dtype, device=eng.device)
    if rhs is not None:
        fv = _at_quad_points(eng, rhs).reshape(eng.nE, eng.nq, bs)
        phi = torch.as_tensor(eng.phi_q, dtype=eng.dtype, device=eng.device)
        # (nE, nnd·bs) in (a, i) dof order, the order of loc2red
        b_loc = torch.einsum("eq,eqi,eqa->eai", wq, fv, phi).reshape(-1, 1)
        b = b + _to_reduced(eng, b_loc)[:, 0]
    if grad_rhs is not None:
        ge = torch.einsum("eq,eqr->er", wq, _at_quad_points(eng, grad_rhs))
        b = b + _to_reduced(eng, torch.einsum("er,erl->el", ge, eng.Draw).reshape(-1, 1))[:, 0]
    keep = (~eng.pin_mask).to(eng.dtype)
    b = b * keep

    T = eng._grad_map(None)
    A_K = Ae if T is None else torch.einsum("mr,emt,tn->ern", T, Ae, T)
    if n <= _DENSE_MAX:
        K = _pinned_dense(eng, A_K, eng.assembly == "dense" and eng.D is not None)
        u = torch.cholesky_solve(b[:, None], torch.linalg.cholesky_ex(K).L)[:, 0]
    else:
        # one-cell PCG: on the block stencil with the torus multigrid where
        # the mesh is structured, on the matrix-free operator with Jacobi
        # otherwise
        from hommx_tpu_torch.micro.block_stencil import (
            block_stencil_matvec,
            block_stencil_weights,
        )
        from hommx_tpu_torch.micro.chunk import _mg_nu
        from hommx_tpu_torch.micro.mg_prec import MAX_COARSE, mg_prec, mg_setup

        A_K1 = A_K[None]
        bst = eng._get_block_stencil()
        levels = None
        if bst is not None:
            Wb = block_stencil_weights(bst, eng, A_K1)
            matvec = lambda P: block_stencil_matvec(bst, Wb, P)  # noqa: E731
            levels = eng._get_mg_levels(bst.offsets, bst.shape)
            if levels is not None and levels[-1].n * bs > MAX_COARSE:
                levels = None  # the hierarchy stops at an odd side: Jacobi
        else:
            matvec = lambda P: _gather_matvec(eng, A_K1, P)  # noqa: E731
        if levels is not None:
            prec = mg_prec(levels, mg_setup(levels, Wb), nu=_mg_nu(eng))
        else:
            dg = _exact_diag(eng, A_K1)[:, 0]
            dg = torch.where(eng.pin_mask | (dg <= 0), torch.ones_like(dg), dg)
            prec = lambda R: R / dg[:, None, None]  # noqa: E731
        u3, _ = _chunk_pcg_raw(matvec, prec, b[:, None, None], eng.pcg_tol, eng.pcg_maxiter)
        u = u3[:, 0, 0]
    red = np.asarray(eng.pmap.reduced_index)
    idx = (red[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
    return u[torch.as_tensor(idx, device=u.device)]
