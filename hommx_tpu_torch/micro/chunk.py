"""Chunk-level micro routes (torch port of ``hommx_tpu/micro/chunk.py::
tensors_chunk_pcg``: the scalar periodic-stencil branch and the non-scalar
Cholesky branch).

Scalar route: for one chunk of macro cell centers, reduce the coefficient
per micro element (and map it by B_K = GᵀG and GᵀE when the stratified
variant supplies a gradient map G = Dθᵀ), assemble the stencil weights and
the generator loads,
scale the system symmetrically by its diagonal, run the lockstep block-PCG
on the scaled system, and contract A* by the exact bilinear expansion.  The
PCG is :func:`~hommx_tpu_torch.micro.stencil_pcg.stencil_pcg`, dispatched
by device alone: the fused CUDA kernel K1 on the card (float32 only), its
plain version on the CPU.  The cell axis C is minor: Krylov state (n, s, C),
reduced coefficient (C, nE).

Cholesky route (elasticity): map the coefficient
blocks by the per-cell strain map T, assemble the per-cell reduced
operators Kc (C, n, n) by the Kron fast path and a scatter, build the loads
F = −Σ_e D_eᵀ(TᵀĀ_e)E, equilibrate with S = √(d₀/d), solve with
:func:`~hommx_tpu_torch.ops.chol_kernel.fused_chol_solve` (the CUDA kernel
K3 on the card, its plain version on the CPU) and contract A* bilinearly.

The reference's opt-in switches (``HOMMX_KC_ASSEMBLY``, ``HOMMX_ASTAR``,
``HOMMX_CHOL_REFINE``, ``HOMMX_CHOL_KERNEL``, ``HOMMX_CHOL_BODY``) are not
ported: the port takes their defaults (scatter, bilinear, refinement on,
the kernel).  Other routes (dense-K PCG, FFT and multigrid cell
preconditioners, low-rank, matrix-free gather) wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hommx_tpu_torch.micro.krylov import _solve_linear, shared_prec
from hommx_tpu_torch.micro.stencil import (
    MicroStencil,
    build_stencil,
    scale_weights,
    stencil_astar,
    stencil_matvec,
    stencil_rhs,
    stencil_weights,
)
from hommx_tpu_torch.micro.stencil_pcg import stencil_pcg, stencil_pcg_plain
from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve, fused_chol_solve_plain

__all__ = [
    "tensors_chunk_pcg",
    "tensors_chunk_plain",
    "chunk_system",
    "ChunkSystem",
    "tensors_chunk_chol",
    "tensors_chunk_chol_plain",
    "chol_system",
    "CholSystem",
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

    def corrected(self, eng, Y, iters):
        """(A* (C, s, s), X (n, s, C)) from an unclamped solve Y (n, s, C)
        of the scaled system: the zero-corrector energy clamp, the
        unscaling X = S Y and the bilinear contraction, divided by |Y|."""
        sc = self.sc
        Yc, _ = _solve_linear(
            lambda P: sc * self.matvec(sc * P), self.prec, sc * self.F,
            eng.pcg_tol, eng.pcg_maxiter, raw=lambda B: (Y, iters),
        )
        X = sc * Yc
        return stencil_astar(self.st, self.ws, self.a, eng.E, self.F, X) / eng.volume_Y, X

    def astar(self, eng, Y, iters):
        """A* (C, s, s) from an unclamped solve Y of the scaled system."""
        return self.corrected(eng, Y, iters)[0]

    def solve(self, eng, pcg, with_correctors=False):
        """A* of the chunk with ``pcg`` as the Krylov solve of the scaled
        system (the signature of ``stencil_pcg``); with ``with_correctors``
        also the correctors X (n, s, C)."""
        ws_s, Fs = self.scaled()
        Y, iters = pcg(
            ws_s, Fs, self.Minv, self.st.shape, self.st.offsets, eng.pcg_tol, eng.pcg_maxiter
        )
        out = self.corrected(eng, Y, iters)
        return out if with_correctors else out[0]


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
    n, C = eng.n_reduced, a.shape[0]
    if eng.diag_scale:
        # per-dof diagonal proxy d[n, c] = Σ_e t[c, e]·Σ_r D[e, r, n]² with
        # t = a·tr(B_K)/r (exact for unmapped scalar coefficients); the
        # reference scale d0 uses the unit coefficient through the same
        # formula
        t = a if B_K is None else a * (torch.einsum("crr->c", B_K) / eng.r)[:, None]
        wsum = eng.wq_dev.sum(dim=1)
        if eng.D is not None:
            dD = torch.einsum("ern,ern->en", eng.D, eng.D)
            dp = torch.einsum("ce,en->nc", t, dD)
            d0p = torch.einsum("e,en->n", wsum, dD)
        else:
            dDl = torch.einsum("erl,erl->el", eng.Draw, eng.Draw)  # (nE, nbl)
            tl = torch.einsum("ce,el->elc", t, dDl)
            idx = eng.loc2red.reshape(-1)
            dp = torch.zeros((n, C), dtype=eng.dtype, device=eng.device)
            dp.index_add_(0, idx, tl.reshape(-1, C))
            d0p = torch.zeros(n, dtype=eng.dtype, device=eng.device)
            d0p.index_add_(0, idx, (wsum[:, None] * dDl).reshape(-1))
        bad = eng.pin_mask[:, None] | (dp <= 0) | ~torch.isfinite(dp)
        one = torch.ones((), dtype=eng.dtype, device=eng.device)
        sc = torch.where(
            bad, one, torch.sqrt(d0p[:, None] / torch.where(bad, one, dp))
        ).to(eng.dtype)[:, None, :]
    else:
        sc = torch.ones((n, 1, C), dtype=eng.dtype, device=eng.device)
    return ChunkSystem(st, a, ws, F, sc, eng._get_K0inv())


def _map_G(eng, G_fn, centers):
    """Dθᵀ(c_T) per center, (C, d, d) in the engine's dtype."""
    return torch.func.vmap(
        lambda x: torch.as_tensor(G_fn(x), device=x.device).to(eng.dtype)
    )(centers)


def tensors_chunk_pcg(eng, coeff, centers, G_fn=None, with_correctors=False):
    """A*(c_T) (C, s, s) for one chunk of centers, and with
    ``with_correctors`` the correctors (n, s, C): the fused PCG kernel on
    CUDA tensors, its plain version on CPU tensors."""
    return chunk_system(eng, coeff, centers, G_fn).solve(eng, stencil_pcg, with_correctors)


def tensors_chunk_plain(eng, coeff, centers, G_fn=None):
    """The same A* through the plain PCG loop on any device and dtype.  No
    entry point calls it: it is the float64 check a card run holds the
    float32 main path against."""
    return chunk_system(eng, coeff, centers, G_fn).solve(eng, stencil_pcg_plain)


def _get_stencil(eng):
    """Cached periodic grid stencil (micro/stencil.py); the engine checks at
    construction that it exists."""
    if getattr(eng, "_stencil", None) is None:
        eng._stencil = build_stencil(eng)
    return eng._stencil


@dataclass
class CholSystem:
    """The assembled cell problems of one chunk on the Cholesky route."""

    Kc: torch.Tensor  # (C, n, n) reduced operators, identity on pinned dofs
    F: torch.Tensor  # (n, s, C) generator loads
    Abar: torch.Tensor  # (C, r, r) Σ_e Ā_e

    def equilibrated(self, eng):
        """(Ks, Fs, sc): Ks = S Kc S, Fs = S F with S = √(d₀/diag Kc) per
        dof and cell (n, C), ones when ``diag_scale`` is off."""
        if eng.diag_scale:
            sc = eng._scale_from_diag(torch.diagonal(self.Kc, dim1=1, dim2=2).T)
        else:
            sc = torch.ones_like(self.F[:, 0, :])
        scm = sc.T
        return self.Kc * scm[:, :, None] * scm[:, None, :], self.F * sc[:, None, :], sc

    def astar(self, eng, X):
        """A* (C, s_full, s_full) from the solve X (n, s, C) by the bilinear
        expansion ΦᵀĀΦ = EᵀĀE − FᵀX − XᵀF + XᵀKX (X vanishes on pinned
        dofs, so the identity pin rows of Kc do not enter), over |Y|."""
        Xc = X.permute(2, 0, 1)  # (C, n, s)
        Fc = self.F.permute(2, 0, 1)
        XtF = Xc.transpose(1, 2) @ Fc
        XtKX = Xc.transpose(1, 2) @ (self.Kc @ Xc)
        E = eng.E
        term1 = torch.einsum("rs,crt,tm->csm", E, self.Abar, E)
        return eng._expand_astar((term1 - XtF - XtF.transpose(1, 2) + XtKX) / eng.volume_Y)

    def solve(self, eng, solver, with_correctors=False):
        """A* of the chunk with ``solver`` (the signature of
        ``fused_chol_solve``) as the direct solve of the equilibrated
        system; with ``with_correctors`` also the solve X (n, s, C)."""
        Ks, Fs, sc = self.equilibrated(eng)
        X = solver(Ks, Fs) * sc[:, None, :]
        A = self.astar(eng, X)
        return (A, X) if with_correctors else A


def chol_system(eng, coeff, centers: torch.Tensor, G_fn=None) -> CholSystem:
    """Coefficient mapping, Kc assembly and loads for one chunk of centers
    (C, d) on the Cholesky route."""
    C = centers.shape[0]
    nE, r, s, n = eng.nE, eng.r, eng.s, eng.n_reduced
    Ae = torch.func.vmap(lambda x: eng._raw_coeff(coeff, x))(centers)  # (C, nE, r, r)
    G = None if G_fn is None else _map_G(eng, G_fn, centers)
    T = eng._grad_map(G)
    if T is not None and T.ndim == 2:
        T = T.expand(C, r, r)
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
    # scatter of the element blocks into the dense reduced operators
    l2r = eng.loc2red
    flat = (l2r[:, :, None] * n + l2r[:, None, :]).reshape(-1)
    Kc = torch.zeros((C, n * n), dtype=eng.dtype, device=eng.device)
    Kc.index_add_(1, flat, blocks.reshape(C, -1))
    keep = (~eng.pin_mask).to(eng.dtype)
    Kc = Kc.reshape(C, n, n) * keep[None, :, None] * keep[None, None, :] + torch.diag(
        eng.pin_mask.to(eng.dtype)
    )[None]
    # loads F = −Σ_e D_eᵀ (TᵀĀ_e) E, the cell axis minor
    AE = torch.einsum("cert,ts->cers", A_F, eng.E)  # (C, nE, r, s)
    if eng.D is not None:
        F = -torch.einsum("zn,czs->nsc", eng.D.reshape(nE * r, n), AE.reshape(C, nE * r, s))
    else:
        wl = torch.einsum("erl,cers->cels", eng.Draw, AE).reshape(C, -1, s)
        Fc = torch.zeros((C, n, s), dtype=eng.dtype, device=eng.device)
        Fc.index_add_(1, l2r.reshape(-1), wl)
        F = -Fc.permute(1, 2, 0)
    return CholSystem(Kc, F * keep[:, None, None], Ae.sum(dim=1))


def tensors_chunk_chol(eng, coeff, centers, G_fn=None, with_correctors=False):
    """A*(c_T) (C, s_full, s_full) for one chunk of centers, and with
    ``with_correctors`` the solve X (n, s, C): the K3 CUDA kernel on CUDA
    tensors, its plain version on CPU tensors."""
    return chol_system(eng, coeff, centers, G_fn).solve(eng, fused_chol_solve, with_correctors)


def tensors_chunk_chol_plain(eng, coeff, centers, G_fn=None):
    """The same A* through the plain solve on any device and dtype.  No
    entry point calls it: it is the float64 check a card run holds the
    float32 main path against."""
    return chol_system(eng, coeff, centers, G_fn).solve(eng, fused_chol_solve_plain)


def _get_kron_M(eng) -> torch.Tensor:
    """Static per-element Gram map M[e, (r,t), (l,m)] = Draw[e,r,l]·
    Draw[e,t,m] for the Kron fast path, (nE, r², nbl²) on the device."""
    if eng._kron_M is None:
        D = eng.Draw_np
        nE, r, nbl = D.shape
        M = np.einsum("erl,etm->ertlm", D, D).reshape(nE, r * r, nbl * nbl)
        eng._kron_M = torch.as_tensor(M, dtype=eng.dtype, device=eng.device)
    return eng._kron_M
