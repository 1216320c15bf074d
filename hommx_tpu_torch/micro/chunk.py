"""Chunk-level micro route (torch port of the scalar periodic-stencil branch
of ``hommx_tpu/micro/chunk.py::tensors_chunk_pcg``).

For one chunk of macro cell centers: reduce the coefficient per micro
element, assemble the stencil weights and the generator loads, scale the
system symmetrically by its diagonal, run the lockstep block-PCG on the
scaled system, and contract A* by the exact bilinear expansion.  The PCG is
:func:`~hommx_tpu_torch.micro.stencil_pcg.stencil_pcg`, dispatched by
device alone: the fused CUDA kernel on the card (float32 only), its plain
version on the CPU.  The cell axis C is minor everywhere: Krylov state
(n, s, C), reduced coefficient (C, nE).

Other routes of the reference (dense-K, Cholesky, FFT and multigrid cell
preconditioners, low-rank, matrix-free gather) wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

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

__all__ = ["tensors_chunk_pcg", "tensors_chunk_plain", "chunk_system", "ChunkSystem"]


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

    def astar(self, eng, Y, iters):
        """A* (C, s, s) from an unclamped solve Y (n, s, C) of the scaled
        system: the zero-corrector energy clamp, the unscaling X = S Y and
        the bilinear contraction, divided by |Y|."""
        sc = self.sc
        Yc, _ = _solve_linear(
            lambda P: sc * self.matvec(sc * P), self.prec, sc * self.F,
            eng.pcg_tol, eng.pcg_maxiter, raw=lambda B: (Y, iters),
        )
        return stencil_astar(self.st, self.ws, self.a, eng.E, self.F, sc * Yc) / eng.volume_Y

    def solve(self, eng, pcg):
        """A* of the chunk with ``pcg`` as the Krylov solve of the scaled
        system (the signature of ``stencil_pcg``)."""
        ws_s, Fs = self.scaled()
        Y, iters = pcg(
            ws_s, Fs, self.Minv, self.st.shape, self.st.offsets, eng.pcg_tol, eng.pcg_maxiter
        )
        return self.astar(eng, Y, iters)


def chunk_system(eng, coeff, centers: torch.Tensor) -> ChunkSystem:
    """Coefficient mapping, stencil weights, loads and diagonal scaling for
    one chunk of centers (C, d)."""
    st = eng._get_stencil()
    a = torch.func.vmap(lambda x: eng._raw_coeff(coeff, x))(centers)  # (C, nE)
    ws = stencil_weights(st, a)
    F = stencil_rhs(st, a, eng.E)
    n, C = eng.n_reduced, a.shape[0]
    if eng.diag_scale:
        # per-dof diagonal proxy d[n, c] = Σ_e a[c, e]·Σ_r D[e, r, n]²
        # (exact for unmapped scalar coefficients); the reference scale d0
        # uses the unit coefficient through the same formula
        wsum = eng.wq_dev.sum(dim=1)
        if eng.D is not None:
            dD = torch.einsum("ern,ern->en", eng.D, eng.D)
            dp = torch.einsum("ce,en->nc", a, dD)
            d0p = torch.einsum("e,en->n", wsum, dD)
        else:
            dDl = torch.einsum("erl,erl->el", eng.Draw, eng.Draw)  # (nE, nbl)
            tl = torch.einsum("ce,el->elc", a, dDl)
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


def tensors_chunk_pcg(eng, coeff, centers):
    """A*(c_T) (C, s, s) for one chunk of centers: the fused PCG kernel on
    CUDA tensors, its plain version on CPU tensors."""
    return chunk_system(eng, coeff, centers).solve(eng, stencil_pcg)


def tensors_chunk_plain(eng, coeff, centers):
    """The same A* through the plain PCG loop on any device and dtype.  No
    entry point calls it: it is the float64 check a card run holds the
    float32 main path against."""
    return chunk_system(eng, coeff, centers).solve(eng, stencil_pcg_plain)


def _get_stencil(eng):
    """Cached periodic grid stencil (micro/stencil.py); the engine checks at
    construction that it exists."""
    if getattr(eng, "_stencil", None) is None:
        eng._stencil = build_stencil(eng)
    return eng._stencil
