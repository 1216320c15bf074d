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

The Kc assembly honours the reference's ``HOMMX_KC_ASSEMBLY`` switch
(``scatter`` | ``gather``) with another default: gather on CUDA, scatter
on the CPU (the reference's default everywhere).  The gather form inverts
the scatter map on the host once (:func:`_get_kc_gather`), so every Kc and
Fc entry is added in one fixed order; ``index_add_`` on CUDA adds in the
order its atomics land, and two identical float32 runs then differ.
``HOMMX_CHOL_SOLVE_BATCH=1`` takes :func:`tensors_chol_batched`: the
chunks are assembled and equilibrated, one K3 launch solves the whole
batch, and A* is contracted per chunk.  The other opt-in switches
(``HOMMX_ASTAR``, ``HOMMX_CHOL_REFINE``, ``HOMMX_CHOL_KERNEL``,
``HOMMX_CHOL_BODY``) are not ported: the port takes their defaults
(bilinear, refinement on, the kernel).  Other routes (dense-K PCG, FFT and
multigrid cell preconditioners, low-rank, matrix-free gather) wait for
later slices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from hommx_tpu_torch.micro.krylov import _solve_linear, shared_prec
from hommx_tpu_torch.micro.stencil import (
    MicroStencil,
    torus_matvec,
    build_stencil,
    scale_weights,
    stencil_astar,
    stencil_matvec,
    stencil_rhs,
    stencil_weights,
)
from hommx_tpu_torch.micro.stencil_pcg import stencil_pcg, stencil_pcg_plain
from hommx_tpu_torch.ops.assembly import GatherPlan, gather_sum, invert_scatter
from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve, fused_chol_solve_plain
from hommx_tpu_torch.ops.solvers import implicit_linear_solve

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

    def corrected(self, eng, Y, iters):
        """(A* (C, s, s), X (n, s, C)) from a given unclamped solve Y
        (n, s, C) of the scaled system: the zero-corrector energy clamp, the
        unscaling X = S Y and the bilinear contraction, divided by |Y|.  Y
        is taken as it is: no implicit rule (see :meth:`solve`)."""
        Fs = self.sc * self.F
        return self._contract(eng, self._clamped(eng, lambda B: (Y, iters), Fs, False)[0])

    def astar(self, eng, Y, iters):
        """A* (C, s, s) from an unclamped solve Y of the scaled system."""
        return self.corrected(eng, Y, iters)[0]

    def _clamped(self, eng, raw, Fs, implicit_diff, params=None):
        """The clamped solve Yc of the scaled system S K S Y = Fs (= S F) by
        ``raw``, through :func:`_solve_linear` (the implicit rule with the
        scaled weights ``params`` as the operator's tensors)."""
        sc, st = self.sc, self.st
        operator = None
        if params is not None:
            operator = (lambda ws, P: torus_matvec(st.shape, st.offsets, ws, P), tuple(params))
        return _solve_linear(
            lambda P: sc * self.matvec(sc * P), self.prec, Fs,
            eng.pcg_tol, eng.pcg_maxiter, False, implicit_diff, raw=raw, operator=operator,
        )

    def _contract(self, eng, Yc):
        X = self.sc * Yc
        return stencil_astar(self.st, self.ws, self.a, eng.E, self.F, X) / eng.volume_Y, X

    def solve(self, eng, pcg, with_correctors=False, implicit_diff=True):
        """A* of the chunk with ``pcg`` as the Krylov solve of the scaled
        system (the signature of ``stencil_pcg``); with ``with_correctors``
        also the correctors X (n, s, C).  The solve runs inside the
        implicit-function rule: the scaled weights ``ws_s`` and loads ``Fs``
        are its inputs and its adjoint is one more ``pcg`` solve (a second
        K1 launch on the card).  With ``implicit_diff=False`` the solve
        carries no gradient."""
        ws_s, Fs = self.scaled()
        st = self.st
        raw = lambda B: pcg(  # noqa: E731
            ws_s, B, self.Minv, st.shape, st.offsets, eng.pcg_tol, eng.pcg_maxiter
        )
        Yc, _ = self._clamped(eng, raw, Fs, implicit_diff, params=ws_s)
        out = self._contract(eng, Yc)
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


def tensors_chunk_pcg(eng, coeff, centers, G_fn=None, with_correctors=False,
                      implicit_diff=True):
    """A*(c_T) (C, s, s) for one chunk of centers, and with
    ``with_correctors`` the correctors (n, s, C): the fused PCG kernel on
    CUDA tensors, its plain version on CPU tensors, under the implicit
    rule unless ``implicit_diff=False``."""
    return chunk_system(eng, coeff, centers, G_fn).solve(
        eng, stencil_pcg, with_correctors, implicit_diff
    )


def tensors_chunk_plain(eng, coeff, centers, G_fn=None):
    """The same A* through the plain PCG loop on any device and dtype,
    under the same implicit rule.  No entry point calls it: it is the
    float64 check a card run holds the float32 main path (and its
    gradient) against."""
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

    def solve(self, eng, solver, with_correctors=False, implicit_diff=True):
        """A* of the chunk with ``solver`` (the signature of
        ``fused_chol_solve``) as the direct solve of the equilibrated
        system; with ``with_correctors`` also the solve X (n, s, C).  The
        solve runs inside the implicit-function rule with the operator
        v ↦ Ks·v, as the reference's ``lax.custom_linear_solve`` around its
        kernel: the adjoint is one more ``solver`` call (a second K3 launch
        on the card).  The scaling stays differentiable through diag(Kc).
        With ``implicit_diff=False`` the solve carries no gradient."""
        Ks, Fs, sc = self.equilibrated(eng)
        X = _chol_solve(solver, Ks, Fs, implicit_diff) * sc[:, None, :]
        A = self.astar(eng, X)
        return (A, X) if with_correctors else A


def _chol_matvec(p, v):
    """Ks·v per cell: Ks (C, n, n), v (n, s, C) -> (n, s, C)."""
    return torch.einsum("cnm,msc->nsc", p[0], v)


def _chol_solve(solver, Ks, Fs, implicit_diff=True):
    """``solver(Ks, Fs)`` under the implicit-function rule (or, with
    ``implicit_diff=False``, with no gradient)."""
    if not implicit_diff:
        with torch.no_grad():
            return solver(Ks, Fs)
    return implicit_linear_solve(_chol_matvec, (Ks,), Fs, lambda p, B: solver(p[0], B))


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
    keep = (~eng.pin_mask).to(eng.dtype)
    kcg = _get_kc_gather(eng)
    if kcg is not None:
        # fixed-order assembly: a gather and a sum over the contributors of
        # every coupled dof pair, the keep/pin masks folded into per-target
        # vectors, then one placement gather into the dense layout
        vals = gather_sum(blocks.reshape(C, -1), kcg.plan) * kcg.keep_vec + kcg.pin_vec
        vals = torch.cat([vals, vals.new_zeros(C, 1)], dim=1)
        Kc = vals.index_select(1, kcg.inv_map).reshape(C, n, n)
    else:
        # scatter of the element blocks into the dense reduced operators
        l2r = eng.loc2red
        flat = (l2r[:, :, None] * n + l2r[:, None, :]).reshape(-1)
        Kc = torch.zeros((C, n * n), dtype=eng.dtype, device=eng.device)
        Kc.index_add_(1, flat, blocks.reshape(C, -1))
        Kc = Kc.reshape(C, n, n) * keep[None, :, None] * keep[None, None, :] + torch.diag(
            eng.pin_mask.to(eng.dtype)
        )[None]
    # loads F = −Σ_e D_eᵀ (TᵀĀ_e) E, the cell axis minor
    AE = torch.einsum("cert,ts->cers", A_F, eng.E)  # (C, nE, r, s)
    if eng.D is not None:
        F = -torch.einsum("zn,czs->nsc", eng.D.reshape(nE * r, n), AE.reshape(C, nE * r, s))
    else:
        wl = torch.einsum("erl,cers->cels", eng.Draw, AE).reshape(C, -1, s)
        if kcg is not None:
            Fc = gather_sum(wl.transpose(1, 2), kcg.fc_plan)  # (C, s, n)
            F = -Fc.permute(2, 1, 0)
        else:
            Fc = torch.zeros((C, n, s), dtype=eng.dtype, device=eng.device)
            Fc.index_add_(1, eng.loc2red.reshape(-1), wl)
            F = -Fc.permute(1, 2, 0)
    return CholSystem(Kc, F * keep[:, None, None], Ae.sum(dim=1))


def tensors_chunk_chol(eng, coeff, centers, G_fn=None, with_correctors=False,
                       implicit_diff=True):
    """A*(c_T) (C, s_full, s_full) for one chunk of centers, and with
    ``with_correctors`` the solve X (n, s, C): the K3 CUDA kernel on CUDA
    tensors, its plain version on CPU tensors, under the implicit rule
    unless ``implicit_diff=False``."""
    return chol_system(eng, coeff, centers, G_fn).solve(
        eng, fused_chol_solve, with_correctors, implicit_diff
    )


def tensors_chunk_chol_plain(eng, coeff, centers, G_fn=None):
    """The same A* through the plain solve on any device and dtype.  No
    entry point calls it: it is the float64 check a card run holds the
    float32 main path against."""
    return chol_system(eng, coeff, centers, G_fn).solve(eng, fused_chol_solve_plain)


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
class KcGather:
    """The fixed-order assembly of the Cholesky route's Kc and loads (see
    :func:`_get_kc_gather`)."""

    tab: torch.Tensor  # (nnz, m) contributors of each coupled dof pair, the reference's table
    inv_map: torch.Tensor  # (n²,) position of each dense entry among the nnz (nnz: none)
    keep_vec: torch.Tensor  # (nnz,) 1 where neither dof is pinned
    pin_vec: torch.Tensor  # (nnz,) 1 on the pinned diagonal
    plan: GatherPlan  # ``tab`` on the device
    fc_plan: GatherPlan  # the loads' scatter over the reduced dofs (no dense D)


def _get_kc_gather(eng):
    """The gather tables of the Kc assembly (torch port of the reference's
    ``_get_kc_gather``, ``hommx_tpu/micro/chunk.py:857-916``), or None when
    ``kc_assembly_mode`` says scatter or a pathological mesh folds more
    than 64 element entries onto one dof pair.

    The host inverts the scatter map of the element blocks (C, nE·nbl²):
    ``tab`` lists the contributors of each of the nnz coupled dof pairs
    (padded with the index of an appended zero), ``inv_map`` places them
    in the dense (n, n) layout, the keep/pin masks fold into per-target
    vectors; the loads' scatter over the reduced dofs gets its own table.
    Both run as :class:`GatherPlan`s on the device, cached per engine with
    the mode read at its first call."""
    if getattr(eng, "_kc_gather", False) is False:
        eng._kc_gather = None
        if kc_assembly_mode(eng.device) == "gather":
            n = eng.n_reduced
            l2r = eng.loc2red_np.astype(np.int64)  # (nE, nbl)
            flat = (l2r[:, :, None] * n + l2r[:, None, :]).reshape(-1)
            nz, inv = np.unique(flat, return_inverse=True)
            tab = invert_scatter(inv, nz.size, max_mult=64)
            if tab is not None:
                inv_map = np.full(n * n, nz.size, dtype=np.int64)
                inv_map[nz] = np.arange(nz.size)
                pin = eng.pin_np
                keepn = ~pin
                ti, tj = nz // n, nz % n
                dev, dt = eng.device, eng.dtype
                eng._kc_gather = KcGather(
                    tab=tab,
                    inv_map=torch.as_tensor(inv_map, device=dev),
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
    Ks, Fs, Abar, chunk = chol_batched_system(eng, coeff, centers, G_fn, chunk)
    Xs = _chol_solve(fused_chol_solve, Ks, Fs, implicit_diff)  # (n, s, N)
    E = eng.E
    out = []
    for i in range(0, Ks.shape[0], chunk):
        X = Xs[:, :, i : i + chunk].permute(2, 0, 1)  # (C, n, s)
        F = Fs[:, :, i : i + chunk].permute(2, 0, 1)
        XtF = X.transpose(1, 2) @ F
        XtKX = X.transpose(1, 2) @ (Ks[i : i + chunk] @ X)
        term1 = torch.einsum("rs,crt,tm->csm", E, Abar[i : i + chunk], E)
        out.append((term1 - XtF - XtF.transpose(1, 2) + XtKX) / eng.volume_Y)
    return eng._expand_astar(torch.cat(out)[:nc])
