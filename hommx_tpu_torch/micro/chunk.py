"""Chunk-level micro routes (torch port of ``hommx_tpu/micro/chunk.py``).

Scalar stencil route (K1's): for one chunk of macro cell centers, reduce
the coefficient per micro element (and map it by B_K = GᵀG and GᵀE when the
stratified variant supplies a gradient map G = Dθᵀ), assemble the stencil
weights and the generator loads, scale the system symmetrically by its
diagonal, run the lockstep block-PCG with the shared K0⁻¹ on the scaled
system, and contract A* by the exact bilinear expansion.  The PCG is
:func:`~hommx_tpu_torch.micro.stencil_pcg.stencil_pcg`, dispatched by
device alone: the fused CUDA kernel K1 on the card (float32 only), its
plain version on the CPU.

The other PCG configurations (:func:`_tensors_chunk_general`, plain torch
as in the reference): the dense per-cell Kc (``pcg_strategy='densek'``),
the periodic stencil, the block stencil of vector and matrix-coefficient
problems (micro/block_stencil.py), the low-rank shared Grams
(``coeff_rank``), and the matrix-free gather matvec (P2 cells, unstructured
meshes); preconditioned by K0⁻¹, the FFT symbol of the cell's mean
coefficient (``cell_prec='fft'``, :func:`_fft_prec`, ``torch.fft``) or the
torus-multigrid V-cycle (``cell_prec='mg'``, micro/mg_prec.py).  The cell
axis C is minor: Krylov state (n, s, C).

Cholesky route (elasticity): map the coefficient blocks by the per-cell
strain map T, assemble the per-cell reduced operators Kc by the Kron fast
path and a scatter (dense, (C, n, n)) or the gather (their nonzeros, (C,
nnz)), build the loads F = −Σ_e D_eᵀ(TᵀĀ_e)E, equilibrate with S =
√(d₀/d), solve with
:func:`~hommx_tpu_torch.ops.chol_kernel.fused_chol_solve` (the CUDA kernel
K3 on the card, its plain version on the CPU) and contract A* bilinearly
in the scaled quantities.  On the gather route the equilibration and the
contraction run on the nonzeros, and the dense layout is written once, as
the equilibrated Ks that the solve reads.

The Kc assembly (and the block stencil's weights) honour the reference's
``HOMMX_KC_ASSEMBLY`` switch (``scatter`` | ``gather``) with another
default: gather on CUDA, scatter on the CPU (the reference's default
everywhere).  The gather form inverts the scatter map on the host once
(:func:`_get_kc_gather`), so every sum is added in one fixed order;
``index_add_`` on CUDA adds in the order its atomics land, and two
identical float32 runs then differ.  ``HOMMX_MICRO_MATVEC=matfree`` (the
reference's switch) drops the periodic stencils for the matrix-free gather
matvec, except under ``cell_prec='mg'``.  ``HOMMX_CHOL_SOLVE_BATCH=1``
takes :func:`tensors_chol_batched`: the chunks are assembled and
equilibrated, one K3 launch solves the whole batch, and A* is contracted
per chunk.  The other opt-in switches (``HOMMX_ASTAR``,
``HOMMX_CHOL_REFINE``, ``HOMMX_CHOL_KERNEL``, ``HOMMX_CHOL_BODY``,
``HOMMX_STENCIL_PCG``) are not ported: the port takes their defaults
(bilinear, refinement on, the kernels).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hommx_tpu_torch.micro.block_stencil import (
    block_stencil_weights,
    build_block_stencil,
    mm_weights,
    torus_apply,
)
from hommx_tpu_torch.micro.krylov import _clamp, _solve_unclamped, shared_prec
from hommx_tpu_torch.micro.mg_prec import (
    _signed_offsets,
    build_mg_levels,
    check_coarsest,
    mg_prec,
    mg_setup,
)
from hommx_tpu_torch.micro.percell import (
    _exact_diag,
    _expand,
    _gather_matvec,
    _reduce,
    _to_reduced,
)
from hommx_tpu_torch.micro.stencil import (
    MicroStencil,
    torus_matvec,
    build_stencil,
    micro_matvec_mode,
    scale_weights,
    stencil_astar,
    stencil_matvec,
    stencil_rhs,
    stencil_weights,
)
from hommx_tpu_torch.micro.stencil_pcg import stencil_pcg, stencil_pcg_plain
from hommx_tpu_torch.ops.assembly import GatherPlan, gather_sum, invert_scatter
from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve, fused_chol_solve_plain
from hommx_tpu_torch.ops.elements import _inv_and_det
from hommx_tpu_torch.ops.solvers import implicit_linear_solve
from hommx_tpu_torch.utils.profiling import span

__all__ = [
    "tensors_chunk_pcg",
    "tensors_chunk_plain",
    "chunk_system",
    "ChunkSystem",
    "tensors_chunk_chol",
    "tensors_chunk_chol_plain",
    "chol_system",
    "CholSystem",
    "tensors_chol_batched",
    "chol_batched_system",
]


@dataclass
class ChunkSystem:
    """The stencil cell problems of one chunk, before the Krylov solve."""

    st: MicroStencil
    a: torch.Tensor  # (C, nE) reduced coefficient
    ws: list  # K (n, C) stencil weights
    F: torch.Tensor  # (n, s, C) generator loads
    sc: torch.Tensor  # (n, 1, C) symmetric diagonal scaling (ones if off)
    Minv: torch.Tensor  # (n, n) shared preconditioner K0^-1

    def matvec(self, P):
        return stencil_matvec(self.st, self.ws, P)

    def prec(self, R):
        return shared_prec(self.Minv, R)

    def scaled(self):
        """(ws_s, Fs): the weights and loads of the scaled system
        S K S Y = S F, the scaling folded into the weights so that the PCG
        loop carries none."""
        return scale_weights(self.st, self.ws, self.sc[:, 0, :]), self.sc * self.F

    def _matvec_s(self, P):
        """The scaled operator's product S K S P."""
        return self.sc * self.matvec(self.sc * P)

    def corrected(self, eng, Y, iters):
        """(A* (C, s, s), X (n, s, C)) from a given unclamped solve Y
        (n, s, C) of the scaled system (``iters`` its count): the
        zero-corrector energy clamp, the unscaling X = S Y and the bilinear
        contraction, divided by |Y|.  Y is taken as it is: no implicit rule
        (see :meth:`solve`)."""
        return self._contract(eng, _clamp(self._matvec_s, self.prec, self.sc * self.F, Y))

    def astar(self, eng, Y, iters):
        """A* (C, s, s) from an unclamped solve Y of the scaled system."""
        return self.corrected(eng, Y, iters)[0]

    def _contract(self, eng, Yc):
        X = self.sc * Yc
        return stencil_astar(self.st, self.ws, self.a, eng.E, self.F, X) / eng.volume_Y, X

    def solve(self, eng, pcg, with_correctors=False, implicit_diff=True, with_iters=False,
              scaled=None):
        """A* of the chunk with ``pcg`` as the Krylov solve of the scaled
        system (the signature of ``stencil_pcg``); with ``with_correctors``
        also the correctors X (n, s, C), with ``with_iters`` the iteration
        count.  The solve runs inside the implicit-function rule: the
        scaled weights ``ws_s`` and loads ``Fs`` (``scaled``, or
        :meth:`scaled`) are its inputs and its adjoint is one more ``pcg``
        solve (a second K1 launch on the card).  With
        ``implicit_diff=False`` (or ``with_iters``) the solve carries no
        gradient.  The clamp, unscaling and contraction are the span
        ``hommx.micro.astar``."""
        ws_s, Fs = self.scaled() if scaled is None else scaled
        st = self.st
        raw = lambda B: pcg(  # noqa: E731
            ws_s, B, self.Minv, st.shape, st.offsets, eng.pcg_tol, eng.pcg_maxiter
        )
        operator = (lambda ws, P: torus_matvec(st.shape, st.offsets, ws, P), tuple(ws_s))
        Y, iters = _solve_unclamped(self._matvec_s, self.prec, Fs, eng.pcg_tol,
                                    eng.pcg_maxiter, with_iters, implicit_diff, raw=raw,
                                    operator=operator)
        with span("hommx.micro.astar"):
            A, X = self._contract(eng, _clamp(self._matvec_s, self.prec, Fs, Y))
        return _outputs(A, X, iters, with_correctors, with_iters)


def chunk_system(eng, coeff, centers: torch.Tensor, G_fn=None) -> ChunkSystem:
    """Coefficient mapping, stencil weights, loads and diagonal scaling for
    one chunk of centers (C, d).  A gradient map ``G_fn`` (Dθᵀ(x), the
    stratified variants) enters through the weights (B_K = GᵀG) and the
    loads (GᵀE) alone: the stencil's offsets and the PCG are those of the
    unmapped problem."""
    st = eng._get_stencil()
    a = torch.func.vmap(lambda x: eng._raw_coeff(coeff, x))(centers)  # (C, nE)
    B_K = GE = None
    if G_fn is not None:
        G = _map_G(eng, G_fn, centers)  # (C, d, d)
        B_K = torch.einsum("cmr,cmt->crt", G, G)
        GE = torch.einsum("ctr,ts->crs", G, eng.E)  # Gᵀ E
    ws = stencil_weights(st, a, B_K)
    F = stencil_rhs(st, a, eng.E, TE=GE)
    return ChunkSystem(st, a, ws, F, _proxy_scale(eng, a, B_K), eng._get_K0inv())


def _proxy_scale(eng, a, B_K) -> torch.Tensor:
    """The symmetric diagonal scaling S = √(d₀/d) (n, 1, C) of scalar-
    coefficient cell systems (ones when ``diag_scale`` is off), from the
    per-dof proxy d[n, c] = Σ_e t[c, e]·Σ_r D[e, r, n]² with t =
    a·tr(B_K)/r (exact for unmapped scalar coefficients); the reference
    scale d₀ takes the unit coefficient through the same formula."""
    n, C = eng.n_reduced, a.shape[0]
    if not eng.diag_scale:
        return torch.ones((n, 1, C), dtype=eng.dtype, device=eng.device)
    t = a if B_K is None else a * (torch.einsum("crr->c", B_K) / eng.r)[:, None]
    wsum = eng.wq_dev.sum(dim=1)
    if eng.D is not None:
        dD = torch.einsum("ern,ern->en", eng.D, eng.D)
        dp = torch.einsum("ce,en->nc", t, dD)
        d0p = torch.einsum("e,en->n", wsum, dD)
    else:
        dDl = torch.einsum("erl,erl->el", eng.Draw, eng.Draw)  # (nE, nbl)
        dp = _to_reduced(eng, torch.einsum("ce,el->elc", t, dDl).reshape(-1, C))
        d0p = _to_reduced(eng, (wsum[:, None] * dDl).reshape(-1, 1))[:, 0]
    return _scale(eng, dp, d0p)


def _scale(eng, dp, d0p) -> torch.Tensor:
    """S = √(d₀/d) (n, 1, C) from the diagonal dp (n, C) and the reference
    scale d0p (n,); pinned dofs and non-positive or non-finite entries are
    left unscaled."""
    bad = eng.pin_mask[:, None] | (dp <= 0) | ~torch.isfinite(dp)
    one = torch.ones((), dtype=eng.dtype, device=eng.device)
    return torch.where(bad, one, torch.sqrt(d0p[:, None] / torch.where(bad, one, dp))).to(
        eng.dtype)[:, None, :]


def _map_G(eng, G_fn, centers):
    """Dθᵀ(c_T) per center, (C, d, d) in the engine's dtype."""
    return torch.func.vmap(
        lambda x: torch.as_tensor(G_fn(x), device=x.device).to(eng.dtype)
    )(centers)


def _outputs(A, X, iters, with_correctors, with_iters):
    out = (A,) + ((X,) if with_correctors else ()) + ((iters,) if with_iters else ())
    return out[0] if len(out) == 1 else out


def tensors_chunk_pcg(eng, coeff, centers, G_fn=None, with_correctors=False,
                      implicit_diff=True, with_iters=False):
    """A*(c_T) (C, s_full, s_full) for one chunk of centers by the chunk
    PCG, and with ``with_correctors`` the correctors X (n, s, C), with
    ``with_iters`` the lockstep iteration count; the solve runs under the
    implicit rule unless ``implicit_diff=False`` (or ``with_iters``).

    A scalar coefficient on a scalar problem with the shared K0⁻¹ on the
    periodic stencil is K1's route: the fused kernel on CUDA tensors, its
    plain version on CPU tensors.  Every other configuration takes
    :func:`_tensors_chunk_general`."""
    if eng._k1_route():
        with span("hommx.micro.prepare"):
            system = chunk_system(eng, coeff, centers, G_fn)
            scaled = system.scaled()
        return system.solve(eng, stencil_pcg, with_correctors, implicit_diff, with_iters,
                            scaled)
    return _tensors_chunk_general(eng, coeff, centers, G_fn, with_correctors, implicit_diff,
                                  with_iters)


def _tensors_chunk_general(eng, coeff, centers, G_fn, with_correctors, implicit_diff,
                           with_iters):
    """The chunk PCG in plain torch (``hommx_tpu/micro/chunk.py::
    tensors_chunk_pcg`` but K1's branch), the Krylov state (n, s, C) with
    the cell axis minor.  The matvec is, in the
    reference's order of precedence:

    - the dense per-cell Kc (``pcg_strategy='densek'``, non-scalar
      coefficients; A* by the bilinear expansion);
    - the periodic stencil (scalar coefficients, structured meshes; A* by
      the stencil's bilinear expansion);
    - the block stencil (non-scalar coefficients, structured meshes);
    - the low-rank shared Grams (a declared ``coeff_rank``, a scalar
      unmapped coefficient and no stencil);
    - the matrix-free gather D̃ᵀ(A_K ∘ D̃·) (``HOMMX_MICRO_MATVEC=matfree``
      or an unstructured mesh).

    The preconditioner is the shared K0⁻¹, the FFT symbol of the cell's
    mean coefficient (:func:`_fft_prec`), or the torus multigrid V-cycle
    built on the unscaled stencil weights; the last two approximate the
    unscaled K⁻¹ and go onto the scaled system by the congruence
    S⁻¹P(S⁻¹·).  The operator is given to the implicit rule as a function
    of its tensors, so the gradient reaches the coefficient through it."""
    with span("hommx.micro.prepare"):
        C = centers.shape[0]
        nE, r, s, n = eng.nE, eng.r, eng.s, eng.n_reduced
        raw = torch.func.vmap(lambda x: eng._raw_coeff(coeff, x))(centers)
        G = None if G_fn is None else _map_G(eng, G_fn, centers)
        scalar_sep = eng.coeff_kind == "scalar"
        densek = eng.pcg_strategy == "densek" and not scalar_sep
        mg = eng.cell_prec == "mg"
        fft = eng.cell_prec == "fft"
        keep = (~eng.pin_mask).to(eng.dtype)[:, None, None]
        pinf = eng.pin_mask.to(eng.dtype)[:, None, None]
        E = eng.E
        Ae = A_K = B_K = B_Phi = None
        if scalar_sep:
            a = raw  # (C, nE): canonical Ā_e = a[c, e]·I, kept separable
            a_w = a.T[:, None, None, :]  # (nE, 1, 1, C)
            if G is not None:
                B_K = torch.einsum("cmr,cmt->crt", G, G)  # GᵀG
                B_Phi = G
        else:
            Ae = raw  # (C, nE, r, r)
            T = eng._grad_map(G)
            if T is not None and T.ndim == 2:
                T = T.expand(C, r, r)
            B_Phi = T
            # the FFT symbol reads A_K's mean, so the Kron fast path keeps it too
            if not densek or mg or fft:
                A_K = Ae if T is None else torch.einsum("cmr,cemt,ctn->cern", T, Ae, T)

        stencil = eng._get_stencil() if scalar_sep else None
        bst = eng._get_block_stencil() if not scalar_sep and (not densek or mg) else None
        lowrank = (eng.coeff_rank > 0 and scalar_sep and B_K is None and eng.D is not None
                   and stencil is None)
        W_mg = None  # the unscaled fine weights the V-cycle coarsens
        dp = None  # the exact diag(K) (n, C) where the route has it
        if densek:
            chol = _chol_system_of(eng, Ae, T)
            op = lambda p, P: torch.einsum("cnm,msc->nsc", p[0], P)  # noqa: E731
            params, F = (chol.dense(),), chol.F
            dp = torch.diagonal(params[0], dim1=1, dim2=2).T
            if mg:
                W_mg = block_stencil_weights(bst, eng, A_K) if bst is not None else None
        elif stencil is not None:
            ws = stencil_weights(stencil, a, B_K)
            shape, offsets = stencil.shape, stencil.offsets
            op = lambda p, P: torus_matvec(shape, offsets, p, P)  # noqa: E731
            params = tuple(ws)
            if mg:
                W_mg = torch.stack(ws)[:, :, None, None, :]
        elif bst is not None:
            Wb = block_stencil_weights(bst, eng, A_K)
            nbr, bsz = bst.neighbours(eng.device), bst.bs

            def op(p, P):
                X = P.reshape(-1, bsz, s, C).permute(3, 0, 1, 2)
                return torus_apply(nbr, p[0], X).permute(1, 2, 3, 0).reshape(n, s, C)

            params, W_mg = (mm_weights(Wb),), Wb
            dp = torch.einsum("niic->nic", Wb[bst.self_k]).reshape(n, C)
        elif lowrank:
            # a ≈ U V through R anchor cells (float64, interpolative: exact when
            # the declared rank covers the coefficient), K p = Σ_k u_k (K_k p)
            R = min(eng.coeff_rank, C)
            anchors = torch.as_tensor(np.linspace(0, C - 1, R).astype(np.int64), device=eng.device)
            a64 = a.to(torch.float64)
            V = a64[anchors]  # (R, nE)
            U = torch.linalg.pinv(V @ V.T, rtol=1e-12) @ (V @ a64.T)  # (R, C)
            keepn = keep[:, 0, 0].to(torch.float64)
            D2 = eng.D.reshape(nE * r, n).to(torch.float64)
            w = torch.repeat_interleave(V, r, dim=1)  # (R, nE·r)
            Kb = (torch.einsum("kz,zn,zm->knm", w, D2, D2) * keepn[None, :, None]
                  * keepn[None, None, :])

            def op(p, P):
                KP = torch.einsum("knm,msc->knsc", p[0], P * keep)
                return torch.einsum("kc,knsc->nsc", p[1], KP) * keep + pinf * P

            params = (Kb.to(eng.dtype), U.to(eng.dtype))
        elif scalar_sep:
            def op(p, P):
                Dp = _expand(eng, P * keep)
                if len(p) > 1:
                    Dp = torch.einsum("crt,etsc->ersc", p[1], Dp)
                return _reduce(eng, Dp * p[0].T[:, None, None, :]) * keep + pinf * P

            params = (a,) if B_K is None else (a, B_K)
        else:
            op = lambda p, P: _gather_matvec(eng, p[0], P)  # noqa: E731
            params = (A_K,)

        # loads F = −Σ_e D_eᵀ (TᵀĀ_e) E, keep-masked (densek: from its system)
        if stencil is not None:
            GE = None if G is None else torch.einsum("ctr,ts->crs", G, E)
            F = stencil_rhs(stencil, a, E, TE=GE)
        elif scalar_sep:
            GE = E[None] if G is None else torch.einsum("ctr,ts->crs", G, E)
            F = -_reduce(eng, a_w * GE.expand(C, r, s).permute(1, 2, 0)[None]) * keep
        elif not densek:
            F = _loads(eng, Ae if T is None else torch.einsum("cmr,cemt->cert", T, Ae)) * keep

        if not eng.diag_scale:
            sc = None
        elif scalar_sep:
            sc = _proxy_scale(eng, a, B_K)
        else:
            sc = _scale(eng, dp if dp is not None else _exact_diag(eng, A_K), eng._get_K0diag())

        if fft:
            base = _fft_prec(eng, a if scalar_sep else None, B_K, A_K)
            if sc is None:
                prec = base
            else:
                inv_sc = 1.0 / sc.detach()
                prec = lambda R: inv_sc * base(inv_sc * R)  # noqa: E731
        elif mg:
            src = stencil if scalar_sep else bst
            levels = eng._get_mg_levels(src.offsets, src.shape) if src is not None else None
            if levels is None:
                raise ValueError(
                    "cell_prec='mg' requires a structured box micro mesh whose reduced dofs form "
                    "the torus grid (P1 micro elements) and a nearest-neighbour stencil; use "
                    "cell_prec='k0inv' on this configuration"
                )
            check_coarsest(levels, 1 if scalar_sep else eng.bs)
            vcycle = mg_prec(levels, mg_setup(levels, W_mg.detach()), nu=_mg_nu(eng))
            if sc is None:
                prec = vcycle
            else:
                # the V-cycle is built on the unscaled operator and applied to
                # the scaled system by congruence (the scaling distorts the
                # smooth modes that the interpolation must capture)
                inv_sc = 1.0 / sc.detach()
                prec = lambda R: inv_sc * vcycle(inv_sc * R)  # noqa: E731
        else:
            Minv = eng._get_K0inv()
            prec = lambda R: shared_prec(Minv, R)  # noqa: E731

        if sc is None:
            op_s, params_s, Fs = op, params, F
        else:
            k = len(params)
            op_s = lambda p, P: p[k] * op(p[:k], p[k] * P)  # noqa: E731
            params_s, Fs = (*params, sc), sc * F
    matvec_s = lambda P: op_s(params_s, P)  # noqa: E731
    Y, iters = _solve_unclamped(matvec_s, prec, Fs, eng.pcg_tol, eng.pcg_maxiter, with_iters,
                                implicit_diff, operator=(op_s, params_s))
    with span("hommx.micro.astar"):
        Y = _clamp(matvec_s, prec, Fs, Y)
        X = Y if sc is None else sc * Y

        # A* = (1/|Y|) Φᵀ Ā Φ with Φ = E + T·(D X): by the bilinear expansion
        # on the stencil and dense-K routes, as the quadratic form otherwise
        if densek:
            A = chol.astar(eng, X, chol.K, F)  # unscaled: S = 1 in the scaled form
        elif stencil is not None:
            A = stencil_astar(stencil, params, a, E, F, X) / eng.volume_Y
        else:
            Phi = _expand(eng, X)
            if B_Phi is not None:
                Phi = torch.einsum("crt,etsc->ersc", B_Phi, Phi)
            Phi = E[None, :, :, None] + Phi
            APhi = Phi * a_w if scalar_sep else torch.einsum("cert,etsc->ersc", Ae, Phi)
            A = eng._expand_astar(torch.einsum("ernc,ermc->cnm", Phi, APhi) / eng.volume_Y)
    return _outputs(A, X, iters, with_correctors, with_iters)


def _fft_prec(eng, a, B_K, A_K):
    """The FFT cell preconditioner R (n, s, C) -> (n, s, C): the exact
    inverse of the cell operator at its volume-mean coefficient, from the
    DFT symbols of :func:`_get_fft_symbols` (``torch.fft``; approximates
    the unscaled K⁻¹).

    Scalar coefficients: the symbol of ā·B_K per cell (ā the mean of the
    reduced coefficient ``a`` (C, nE), B_K = GᵀG or the identity), its
    zero frequency (exactly 0: the constant nullspace, pinned) replaced by
    its largest magnitude.  Block problems: the (bs, bs) complex Hermitian
    symbol per frequency of the symmetrized mean of ``A_K`` (C, nE, r, r),
    inverted in closed form; a frequency whose determinant is below 1e-10
    of (tr/bs)^bs (the rigid translations at frequency 0) takes (tr/bs)·I,
    tr the largest trace over the frequencies."""
    syms, grid = eng._get_fft_symbols()
    d, n = eng.d, eng.n_reduced
    C = A_K.shape[0] if a is None else a.shape[0]
    dims = tuple(range(d))
    if a is not None:
        nsym = syms.shape[0]
        if B_K is None:
            coords = torch.cat([torch.ones((C, d), dtype=eng.dtype, device=eng.device),
                                torch.zeros((C, nsym - d), dtype=eng.dtype, device=eng.device)],
                               dim=1)
        else:
            iu = torch.triu_indices(d, d, 1, device=B_K.device)
            coords = torch.cat([torch.diagonal(B_K, dim1=1, dim2=2), B_K[:, iu[0], iu[1]]], dim=1)
        abar = a.detach().sum(dim=1) / eng.volume_Y  # (C,) mean coefficient
        sym_c = torch.einsum("ck,k...->c...", coords.detach() * abar[:, None], syms)
        smax = sym_c.abs().amax(dim=tuple(range(1, 1 + d)), keepdim=True)
        sym_c = torch.where(sym_c.abs() > 1e-8 * smax, sym_c, smax)
        sym_b = sym_c.movedim(0, -1)[..., None, :]  # (*grid, 1, C)

        def prec(R):
            Rh = torch.fft.fftn(R.reshape(*grid, -1, C), dim=dims)
            return torch.fft.ifftn(Rh / sym_b, dim=dims).real.to(R.dtype).reshape(n, -1, C)

        return prec
    bsz, r = eng.bs, eng.r
    Bbar = A_K.detach().sum(dim=1) / eng.volume_Y  # (C, r, r)
    Bbar = 0.5 * (Bbar + Bbar.transpose(1, 2))
    iu = torch.triu_indices(r, r, 1, device=Bbar.device)
    coords = torch.cat([torch.diagonal(Bbar, dim1=1, dim2=2), Bbar[:, iu[0], iu[1]]],
                       dim=1).to(syms.dtype)
    S = torch.einsum("ck,kab...->...cab", coords, syms)  # (*grid, C, bs, bs)
    tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(dim=-1)  # (*grid, C)
    alpha = (tr.abs().amax(dim=dims) / bsz + 1e-30)[(None,) * d + (slice(None), None, None)]
    _, det = _inv_and_det(S)
    bad = (det.abs() < 1e-10 * alpha[..., 0, 0] ** bsz)[..., None, None]
    eye = torch.eye(bsz, dtype=S.dtype, device=S.device)
    inv, _ = _inv_and_det(torch.where(bad, alpha * eye, S))
    invc = inv.movedim(d, -1)[(slice(None),) * d + (None,)]  # (*grid, 1, bs_i, bs_j, C)

    def prec(R):
        s = R.shape[1]
        Rh = torch.fft.fftn(R.reshape(*grid, bsz, s, C), dim=dims)
        Rv = Rh.movedim(-3, -2)  # (*grid, s, bs_j, C)
        Xv = (invc * Rv[..., None, :, :]).sum(dim=-2)  # (*grid, s, bs_i, C)
        out = torch.fft.ifftn(Xv.movedim(-2, -3), dim=dims).real
        return out.to(R.dtype).reshape(n, s, C)

    return prec


def _get_fft_symbols(eng):
    """Cached DFT symbols of the reduced periodic operator for a basis of
    constant coefficients: (syms, grid), syms (nsym, *grid) real for a
    scalar problem (the circulant stencil is symmetric), (nsym, bs, bs,
    *grid) complex Hermitian per frequency for a block one, nsym = r +
    r(r−1)/2 spanning the symmetric (r, r) coefficient blocks; the symbol
    of any constant block is the matching linear combination.  Built on
    the host in float64 from unit impulses through the element operators
    (as the reference, from the compute-dtype ``Draw``), then copied once
    to the device in the engine's dtype (complex64 for a float32 block
    problem).  Raises ValueError unless the micro mesh is a structured
    box with P1 elements whose reduced dofs form the torus grid."""
    if eng._fft_syms is None:
        st = eng.mesh.structure
        if st is None or eng.micro_degree != 1:
            raise ValueError(
                "cell_prec='fft' requires a structured box micro mesh and P1 micro elements"
            )
        shape = tuple(int(x) for x in np.asarray(st.shape))
        bs, r, n = eng.bs, eng.r, eng.n_reduced
        if int(np.prod(shape)) * bs != n:
            raise ValueError("reduced dof space is not the torus grid")
        basis = []
        for i in range(r):
            E = np.zeros((r, r))
            E[i, i] = 1.0
            basis.append(E)
        for i in range(r):
            for j in range(i + 1, r):
                E = np.zeros((r, r))
                E[i, j] = E[j, i] = 1.0
                basis.append(E)
        wsum = np.asarray(eng.wq, dtype=np.float64).sum(axis=1)
        D64 = eng.Draw.detach().cpu().numpy().astype(np.float64)  # (nE, r, nbl)
        l2r = eng.loc2red_np
        syms = []
        for B in basis:
            Ae = wsum[:, None, None] * B[None]
            cols = []
            for j in range(bs):  # unit impulse at node 0, component j
                e0 = np.zeros(n)
                e0[j] = 1.0
                Dp = np.einsum("erl,el->er", D64, e0[l2r])
                wl = np.einsum("erl,er->el", D64, np.einsum("ert,et->er", Ae, Dp))
                col = np.zeros(n)
                np.add.at(col, l2r.reshape(-1), wl.reshape(-1))
                cols.append(col.reshape(shape + (bs,)))
            S = np.fft.fftn(np.stack(cols, axis=-1), axes=tuple(range(len(shape))))
            if bs == 1:
                syms.append(S.real[..., 0, 0])
            else:
                syms.append(np.moveaxis(S, (-2, -1), (0, 1)))  # (bs_out, bs_in, *grid)
        if bs == 1:
            dt = eng.dtype
        else:
            dt = torch.complex64 if eng.dtype == torch.float32 else torch.complex128
        eng._fft_syms = (torch.as_tensor(np.stack(syms), dtype=dt, device=eng.device), shape)
    return eng._fft_syms


def tensors_chunk_plain(eng, coeff, centers, G_fn=None):
    """The same A* through the plain PCG loop on any device and dtype,
    under the same implicit rule.  No entry point calls it: it is the
    float64 check a card run holds the float32 main path (and its
    gradient) against."""
    return chunk_system(eng, coeff, centers, G_fn).solve(eng, stencil_pcg_plain)


def _get_stencil(eng):
    """Cached periodic grid stencil of a scalar problem (micro/stencil.py),
    or None: the mesh is not a raster-ordered structured box, or
    ``HOMMX_MICRO_MATVEC=matfree`` (read at the engine's first call) —
    except under ``cell_prec='mg'``, whose V-cycle is built from the
    stencil.  (The reference drops the stencil under 'matfree' and 'mg'
    too, and then says the mesh is not structured.)"""
    if getattr(eng, "_stencil", False) is False:
        eng._stencil = None
        if eng.bs == 1 and (micro_matvec_mode() == "auto" or eng.cell_prec == "mg"):
            eng._stencil = build_stencil(eng)
    return eng._stencil


def _get_block_stencil(eng):
    """Cached block stencil (micro/block_stencil.py), or None: the mesh is
    not a raster-ordered structured box, or ``HOMMX_MICRO_MATVEC=matfree``
    — except under ``cell_prec='mg'``."""
    if getattr(eng, "_bstencil", False) is False:
        eng._bstencil = None
        if micro_matvec_mode() == "auto" or eng.cell_prec == "mg":
            eng._bstencil = build_block_stencil(eng)
    return eng._bstencil


def _get_mg_levels(eng, offsets, shape):
    """Cached host-side torus-multigrid plan (micro/mg_prec.py), or None
    when the stencil is not nearest-neighbour."""
    if offsets is None or shape is None:
        return None
    key = (tuple(shape), tuple(map(tuple, np.asarray(offsets).tolist())))
    cache = eng.__dict__.setdefault("_mg_levels_cache", {})
    if key not in cache:
        signed = _signed_offsets(np.asarray(offsets), shape)
        cache[key] = None if signed is None else build_mg_levels(signed, shape)
    return cache[key]


def _mg_nu(eng) -> int:
    """Chebyshev smoothing degree of the torus-multigrid V-cycle: ``mg_nu``
    if set, else 2 for scalar problems and 4 for vector ones (the
    reference's measured time optimum on the 16³ contrast-1e5 fibre
    cell)."""
    if eng.mg_nu:
        return int(eng.mg_nu)
    return 2 if eng.coeff_kind == "scalar" and eng.bs == 1 else 4


@dataclass
class CholSystem:
    """The assembled cell problems of one chunk on the Cholesky route.

    ``K`` holds the reduced operators Kc as the route stores them.  On the
    gather assembly route (``pattern`` is the engine's :class:`KcPattern`)
    it is their nonzeros (C, nnz), in the order of ``pattern.pos``: the
    chunk is equilibrated and contracted there, and the dense layout is
    written once, as the Ks the solver reads (:meth:`dense`).  On the
    scatter route (``pattern`` None) it is the dense (C, n, n)."""

    K: torch.Tensor  # Kc, identity on pinned dofs: (C, nnz) or (C, n, n)
    F: torch.Tensor  # (n, s, C) generator loads
    Abar: torch.Tensor  # (C, r, r) Σ_e Ā_e
    pattern: Optional["KcPattern"] = None

    def dense(self, K=None):
        """The dense (C, n, n) layout of ``K`` (of Kc by default), stored
        as this route stores Kc."""
        K = self.K if K is None else K
        return K if self.pattern is None else self.pattern.place(K)

    def scaled(self, eng):
        """(Ks, Fs, sc), Ks stored as Kc is: Ks = S Kc S, Fs = S F with S =
        √(d₀/diag Kc) per dof and cell (n, C), ones when ``diag_scale`` is
        off.  Each Ks entry is (Kc_ij·S_i)·S_j, on the nonzeros as in the
        dense layout, so both store the same values bit for bit."""
        pat = self.pattern
        if eng.diag_scale:
            d = (torch.diagonal(self.K, dim1=1, dim2=2) if pat is None
                 else self.K.index_select(1, pat.diag))
            sc = eng._scale_from_diag(d.T)
        else:
            sc = torch.ones_like(self.F[:, 0, :])
        scm = sc.T
        if pat is None:
            Ks = self.K * scm[:, :, None] * scm[:, None, :]
        else:
            Ks = self.K * scm.index_select(1, pat.rows) * scm.index_select(1, pat.cols)
        return Ks, self.F * sc[:, None, :], sc

    def equilibrated(self, eng):
        """(Ks, Fs, sc) of :meth:`scaled` with Ks in the dense layout."""
        Ks, Fs, sc = self.scaled(eng)
        return self.dense(Ks), Fs, sc

    def astar(self, eng, Xs, Ks, Fs):
        """A* (C, s_full, s_full) from the solve Xs (n, s, C) of the
        equilibrated system, Ks stored as :meth:`scaled` stores it (on the
        gather route Ks·Xs is taken from the nonzeros)."""
        Xc, Fc = Xs.permute(2, 0, 1), Fs.permute(2, 0, 1)  # (C, n, s)
        KX = Ks @ Xc if self.pattern is None else self.pattern.matmul(Ks, Xc)
        return _astar_scaled(eng, self.Abar, Xc, Fc, KX)


def _astar_scaled(eng, Abar, Xs, Fs, KXs):
    """A* (C, s_full, s_full) by the bilinear expansion in scaled quantities,
    ΦᵀĀΦ = EᵀĀE − XsᵀFs − FsᵀXs + XsᵀKsXs, over |Y|: with X = S Xs the
    unscaled terms are equal (XᵀF = XsᵀFs, XᵀKcX = XsᵀKsXs), and X vanishes
    on pinned dofs, so their identity rows do not enter.  Xs, Fs and KXs =
    Ks·Xs are (C, n, s)."""
    XtF = Xs.transpose(1, 2) @ Fs
    XtKX = Xs.transpose(1, 2) @ KXs
    E = eng.E
    term1 = torch.einsum("rs,crt,tm->csm", E, Abar, E)
    return eng._expand_astar((term1 - XtF - XtF.transpose(1, 2) + XtKX) / eng.volume_Y)


def _chol_matvec(p, v):
    """Ks·v per cell: Ks (C, n, n), v (n, s, C) -> (n, s, C)."""
    return torch.einsum("cnm,msc->nsc", p[0], v)


def _chol_solve(solver, Ks, Fs, implicit_diff=True):
    """``solver(Ks, Fs)`` under the implicit-function rule (or, with
    ``implicit_diff=False``, with no gradient); each solver call, the
    adjoint's too, is the span ``hommx.micro.solve``."""

    def raw(K, B):
        with span("hommx.micro.solve"):
            return solver(K, B)

    if not implicit_diff:
        with torch.no_grad():
            return raw(Ks, Fs)
    return implicit_linear_solve(_chol_matvec, (Ks,), Fs, lambda p, B: raw(p[0], B))


def chol_system(eng, coeff, centers: torch.Tensor, G_fn=None) -> CholSystem:
    """Coefficient mapping, Kc assembly and loads for one chunk of centers
    (C, d) on the Cholesky route."""
    Ae = torch.func.vmap(lambda x: eng._raw_coeff(coeff, x))(centers)  # (C, nE, r, r)
    T = eng._grad_map(None if G_fn is None else _map_G(eng, G_fn, centers))
    if T is not None and T.ndim == 2:
        T = T.expand(Ae.shape[0], eng.r, eng.r)
    return _chol_system_of(eng, Ae, T)


def _chol_system_of(eng, Ae: torch.Tensor, T) -> CholSystem:
    """The assembled per-cell operators Kc, the keep-masked loads and Σ_e
    Ā_e of the element coefficients Ae (C, nE, r, r) under the per-cell
    maps T (C, r, r) or None: Kc as its nonzeros on the gather route, dense
    on the scatter route."""
    C = Ae.shape[0]
    nE, r, n = eng.nE, eng.r, eng.n_reduced
    if T is None:
        A_F = Ae
        blocks = torch.einsum("erl,cert,etm->celm", eng.Draw, Ae, eng.Draw)
    else:
        A_F = torch.einsum("cmr,cemt->cert", T, Ae)
        # Kron fast path: blocks[c,e,(l,m)] = Σ Draw[e,r,l]·(TᵀĀT)[c,e,r,t]·
        # Draw[e,t,m], contracted as (C,nE,r²)·(C,r²,r²) and then against
        # the static Draw⊗Draw map (nE, r², nbl²)
        TkT = torch.einsum("cmr,ctn->cmtrn", T, T).reshape(C, r * r, r * r)
        AKv = torch.bmm(Ae.reshape(C, nE, r * r), TkT)
        blocks = torch.einsum("cex,exy->cey", AKv, _get_kron_M(eng))
    keep = (~eng.pin_mask).to(eng.dtype)
    F = _loads(eng, A_F) * keep[:, None, None]
    kcg = _get_kc_gather(eng)
    if kcg is not None:
        # fixed-order assembly: a gather and a sum over the contributors of
        # every coupled dof pair, the keep/pin masks folded into per-target
        # vectors; the nonzeros stay as they are
        vals = gather_sum(blocks.reshape(C, -1), kcg.plan) * kcg.keep_vec + kcg.pin_vec
        return CholSystem(vals, F, Ae.sum(dim=1), kcg.pattern)
    # scatter of the element blocks into the dense reduced operators
    l2r = eng.loc2red
    flat = (l2r[:, :, None] * n + l2r[:, None, :]).reshape(-1)
    Kc = torch.zeros((C, n * n), dtype=eng.dtype, device=eng.device)
    Kc.index_add_(1, flat, blocks.reshape(C, -1))
    Kc = Kc.reshape(C, n, n) * keep[None, :, None] * keep[None, None, :] + torch.diag(
        eng.pin_mask.to(eng.dtype)
    )[None]
    return CholSystem(Kc, F, Ae.sum(dim=1))


def _loads(eng, A_F: torch.Tensor) -> torch.Tensor:
    """Generator loads F = −Σ_e D_eᵀ (TᵀĀ_e) E (n, s, C), the cell axis
    minor, of the F-side element blocks A_F (C, nE, r, r); not keep-masked."""
    C, nE, r, _ = A_F.shape
    n, s = eng.n_reduced, eng.s
    AE = torch.einsum("cert,ts->cers", A_F, eng.E)  # (C, nE, r, s)
    if eng.D is not None:
        return -torch.einsum("zn,czs->nsc", eng.D.reshape(nE * r, n), AE.reshape(C, nE * r, s))
    wl = torch.einsum("erl,cers->cels", eng.Draw, AE).reshape(C, -1, s)
    kcg = _get_kc_gather(eng)
    if kcg is not None:
        return -gather_sum(wl.transpose(1, 2), kcg.fc_plan).permute(2, 1, 0)  # (C, s, n)
    Fc = torch.zeros((C, n, s), dtype=eng.dtype, device=eng.device)
    Fc.index_add_(1, eng.loc2red.reshape(-1), wl)
    return -Fc.permute(1, 2, 0)


def tensors_chunk_chol(eng, coeff, centers, G_fn=None, with_correctors=False,
                       implicit_diff=True):
    """A*(c_T) (C, s_full, s_full) for one chunk of centers, and with
    ``with_correctors`` the solve X (n, s, C): the K3 CUDA kernel on CUDA
    tensors, its plain version on CPU tensors, under the implicit rule
    unless ``implicit_diff=False``."""
    return _chunk_chol(eng, coeff, centers, G_fn, fused_chol_solve, with_correctors,
                       implicit_diff)


def tensors_chunk_chol_plain(eng, coeff, centers, G_fn=None):
    """The same A* through the plain solve on any device and dtype.  No
    entry point calls it: it is the float64 check a card run holds the
    float32 main path against."""
    return _chunk_chol(eng, coeff, centers, G_fn, fused_chol_solve_plain)


def _chunk_chol(eng, coeff, centers, G_fn, solver, with_correctors=False, implicit_diff=True):
    """One chunk on the Cholesky route with ``solver`` (the signature of
    ``fused_chol_solve``): assembly, equilibration and the dense Ks (the
    span ``hommx.micro.prepare``), the solve inside the implicit-function
    rule with the operator v ↦ Ks·v, as the reference's
    ``lax.custom_linear_solve`` around its kernel (the adjoint is one more
    ``solver`` call, a second K3 launch on the card), and A* from the
    scaled quantities (``hommx.micro.astar``).  The scaling stays
    differentiable through diag(Kc).  Nothing after the solve reads the
    dense Ks, so it is freed there."""
    with span("hommx.micro.prepare"):
        system = chol_system(eng, coeff, centers, G_fn)
        ks, Fs, sc = system.scaled(eng)
        Ks = system.dense(ks)
    Xs = _chol_solve(solver, Ks, Fs, implicit_diff)
    del Ks
    with span("hommx.micro.astar"):
        A = system.astar(eng, Xs, ks, Fs)
        return (A, Xs * sc[:, None, :]) if with_correctors else A


def _get_kron_M(eng) -> torch.Tensor:
    """Static per-element Gram map M[e, (r,t), (l,m)] = Draw[e,r,l]·
    Draw[e,t,m] for the Kron fast path, (nE, r², nbl²), built on the
    device in float64 from the engine's Draw (each entry one product, so
    it equals a host build) and cached per engine."""
    if eng._kron_M is None:
        D = torch.as_tensor(eng.Draw_np, device=eng.device)
        nE, r, nbl = D.shape
        M = torch.einsum("erl,etm->ertlm", D, D).reshape(nE, r * r, nbl * nbl)
        eng._kron_M = M.to(eng.dtype)
    return eng._kron_M


def kc_assembly_mode(device) -> str:
    """The reference's ``HOMMX_KC_ASSEMBLY`` switch ('scatter' | 'gather')
    with the port's default: gather on CUDA, where ``index_add_`` adds in
    no fixed order, scatter on the CPU (the reference's default)."""
    mode = os.environ.get("HOMMX_KC_ASSEMBLY") or (
        "gather" if torch.device(device).type == "cuda" else "scatter"
    )
    if mode not in ("scatter", "gather"):
        raise ValueError(f"HOMMX_KC_ASSEMBLY must be 'scatter' or 'gather', got {mode!r}")
    return mode


@dataclass
class KcPattern:
    """The nonzeros of the Cholesky route's Kc on the device (see
    :attr:`KcGather.pattern`): a chunk's operators stored as values (C,
    nnz) in this order are equilibrated, placed and contracted here."""

    n: int
    pos: torch.Tensor  # (nnz,) flat dense position row·n + col of each nonzero, ascending
    rows: torch.Tensor  # (nnz,) row of each nonzero
    cols: torch.Tensor  # (nnz,) column of each nonzero
    diag: torch.Tensor  # (n,) position of each diagonal entry (every dof is in an element)
    width: int  # nonzeros in every row where all rows have as many, else 0
    row_plan: Optional[GatherPlan]  # the rows' sums where their widths differ

    def place(self, v: torch.Tensor) -> torch.Tensor:
        """The dense (..., n, n) layout of nonzeros v (..., nnz): a zero
        fill, then each nonzero written once at its own position (no two
        share one, so the result is the same on every run)."""
        lead, n = v.shape[:-1], self.n
        return v.new_zeros(*lead, n * n).index_copy_(-1, self.pos, v).view(*lead, n, n)

    def matmul(self, v: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """Kc·X per cell from the nonzeros v (C, nnz) of Kc and X (C, n, s):
        (C, n, s).  X's rows gathered by column, times the nonzeros, and
        each row summed in a fixed order: one reduction over ``width``
        entries where every row has as many, else the gathers of
        ``row_plan``."""
        C, n, s = X.shape
        P = v[:, :, None] * X.contiguous().index_select(1, self.cols)  # (C, nnz, s)
        if self.width:
            return P.view(C, n, self.width, s).sum(dim=2)
        return gather_sum(P.transpose(1, 2), self.row_plan).transpose(1, 2)


@dataclass
class KcGather:
    """The fixed-order assembly of the Cholesky route's Kc and loads (see
    :func:`_get_kc_gather`)."""

    tab: torch.Tensor  # (nnz, m) contributors of each coupled dof pair, the reference's table
    nz: np.ndarray  # (nnz,) flat dense position row·n + col of each coupled pair, ascending
    n: int
    keep_vec: torch.Tensor  # (nnz,) 1 where neither dof is pinned
    pin_vec: torch.Tensor  # (nnz,) 1 on the pinned diagonal
    plan: GatherPlan  # ``tab`` on the device
    fc_plan: GatherPlan  # the loads' scatter over the reduced dofs (no dense D)
    _pattern: Optional[KcPattern] = None

    @property
    def pattern(self) -> KcPattern:
        """Kc's nonzeros on the device, built at the first dense assembly
        or chunk of the Cholesky route (the scalar routes share these
        tables and never need it)."""
        if self._pattern is None:
            n, nz, dev = self.n, self.nz, self.keep_vec.device
            ti, tj = nz // n, nz % n
            counts = np.bincount(ti, minlength=n)
            width = int(counts[0]) if (counts == counts[0]).all() else 0
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)  # noqa: E731
            self._pattern = KcPattern(
                n=n, pos=idx(nz), rows=idx(ti), cols=idx(tj),
                diag=idx(np.searchsorted(nz, np.arange(n) * (n + 1))), width=width,
                row_plan=None if width else GatherPlan(invert_scatter(ti, n), nz.size, dev),
            )
        return self._pattern


def _get_kc_gather(eng):
    """The gather tables of the Kc assembly (torch port of the reference's
    ``_get_kc_gather``, ``hommx_tpu/micro/chunk.py:857-916``), or None when
    ``kc_assembly_mode`` says scatter or a pathological mesh folds more
    than 64 element entries onto one dof pair.

    The host inverts the scatter map of the element blocks (C, nE·nbl²):
    ``tab`` lists the contributors of each of the nnz coupled dof pairs
    (padded with the index of an appended zero), ``nz`` their dense
    positions, the keep/pin masks fold into per-target vectors; the loads'
    scatter over the reduced dofs gets its own table.  Both run as
    :class:`GatherPlan`s on the device, cached per engine with the mode
    read at its first call."""
    if getattr(eng, "_kc_gather", False) is False:
        eng._kc_gather = None
        if kc_assembly_mode(eng.device) == "gather":
            n = eng.n_reduced
            l2r = eng.loc2red_np.astype(np.int64)  # (nE, nbl)
            flat = (l2r[:, :, None] * n + l2r[:, None, :]).reshape(-1)
            nz, inv = np.unique(flat, return_inverse=True)
            tab = invert_scatter(inv, nz.size, max_mult=64)
            if tab is not None:
                pin = eng.pin_np
                keepn = ~pin
                ti, tj = nz // n, nz % n
                dev, dt = eng.device, eng.dtype
                eng._kc_gather = KcGather(
                    tab=tab, nz=nz, n=n,
                    keep_vec=torch.as_tensor(keepn[ti] & keepn[tj], dtype=dt, device=dev),
                    pin_vec=torch.as_tensor((ti == tj) & pin[ti], dtype=dt, device=dev),
                    plan=GatherPlan(tab, flat.size, dev),
                    fc_plan=GatherPlan(invert_scatter(l2r, n), l2r.size, dev),
                )
    return eng._kc_gather


def chol_batched_system(eng, coeff, centers, G_fn=None, chunk: int = 0):
    """Step 1 of :func:`tensors_chol_batched`: the equilibrated operators Ks
    (N, n, n), loads Fs (n, s, N) and Σ_e Ā_e (N, r, r) of the whole batch,
    assembled chunk by chunk into resident tensors; N pads the batch to a
    chunk multiple with copies of its first center, as ``_map_chunked``
    does.  Returns (Ks, Fs, Abar, chunk)."""
    centers = torch.as_tensor(centers, device=eng.device).to(eng.dtype)
    nc, n, s = centers.shape[0], eng.n_reduced, eng.s
    chunk = max(1, min(chunk or eng._auto_chunk(nc), nc))
    n_pad = (-nc) % chunk
    if n_pad:
        centers = torch.cat([centers, centers[:1].expand(n_pad, -1)])
    N = nc + n_pad
    Ks = torch.empty((N, n, n), dtype=eng.dtype, device=eng.device)
    Fs = torch.empty((n, s, N), dtype=eng.dtype, device=eng.device)
    Abar = torch.empty((N, eng.r, eng.r), dtype=eng.dtype, device=eng.device)
    for i in range(0, N, chunk):
        sys_ = chol_system(eng, coeff, centers[i : i + chunk], G_fn)
        Ks[i : i + chunk], Fs[:, :, i : i + chunk], _ = sys_.equilibrated(eng)
        Abar[i : i + chunk] = sys_.Abar
        del sys_
    return Ks, Fs, Abar, chunk


def tensors_chol_batched(eng, coeff, centers, G_fn=None, chunk: int = 0,
                         implicit_diff=True):
    """A*(c_T) (nc, s_full, s_full) with one direct solve over the whole
    batch (torch port of ``hommx_tpu/micro/chunk.py::
    tensors_chol_batched``, the ``HOMMX_CHOL_SOLVE_BATCH=1`` route).

    1. per chunk: coefficient mapping, Kc assembly, loads and equilibration
       into the resident (nc, n, n) operators Ks and (n, s, nc) loads Fs
       (:func:`chol_batched_system`);
    2. ONE :func:`~hommx_tpu_torch.ops.chol_kernel.fused_chol_solve` over
       the whole batch (a single K3 launch on the card, refinement sweep
       included);
    3. per chunk: the bilinear A* in scaled quantities (XᵀKX = XsᵀKsXs,
       FᵀX = FsᵀXs).

    Holds the whole batch's equilibrated operators (nc·n² values, 1.27 GB
    at 8640 beam cells in float32) where the in-chunk route holds one
    chunk's.  Tensors only: no correctors.  The solve runs under the
    implicit rule (its adjoint: one more whole-batch launch) unless
    ``implicit_diff=False``."""
    nc = centers.shape[0]
    with span("hommx.micro.prepare"):
        Ks, Fs, Abar, chunk = chol_batched_system(eng, coeff, centers, G_fn, chunk)
    Xs = _chol_solve(fused_chol_solve, Ks, Fs, implicit_diff)  # (n, s, N)
    out = []
    with span("hommx.micro.astar"):
        for i in range(0, Ks.shape[0], chunk):
            X = Xs[:, :, i : i + chunk].permute(2, 0, 1)  # (C, n, s)
            F = Fs[:, :, i : i + chunk].permute(2, 0, 1)
            out.append(_astar_scaled(eng, Abar[i : i + chunk], X, F, Ks[i : i + chunk] @ X))
        return torch.cat(out)[:nc]
