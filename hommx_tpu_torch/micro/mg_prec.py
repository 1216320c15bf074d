"""Torus (periodic) geometric multigrid preconditioner for the chunk PCG
(torch port of ``hommx_tpu/micro/mg_prec.py``).

On a structured micro mesh the reduced periodic dof space is the torus grid
and a cell operator is a block stencil on it (micro/block_stencil.py; the
scalar stencil is its bs = 1 case), so the structured-grid V-cycle applies
with wrap-around transfers, batched over a chunk of cells:

- **Galerkin coarse stencils, computed algebraically.**  With periodic
  multilinear interpolation P (hat weights w(u) = Π 2^{-|u_i|}) and full
  weighting R = 2^{-d} Pᵀ, RAP of a 3^d-support stencil is a 3^d-support
  stencil whose weights are fixed combinations of fine weights at fine
  sites 2I+u:  Wc_Δ[I] = Σ_{δ,u,v : u+δ-v = 2Δ} 2^{-d} w(u) w(v)·W_δ[2I+u].
  :func:`build_mg_levels` builds the (Δ, δ, u) tables on the host, exactly
  as the reference does; a chunk's coarse weights are one gather of the
  fine weights at the sites 2I+u and one matmul by the coefficients.
- **Chebyshev smoothing with block-Jacobi** on [λ/4, 1.02·λ] of D⁻¹A, λ per
  cell from 8 power iterations with 1.1x headroom; the same pre- and
  post-smoother keep the V-cycle symmetric.
- **A dense solve** on the coarsest grid (<= 4 nodes a side, or the first
  odd side), one per cell: a Cholesky factor, as the reference.  Float32
  weights are coarsened in float64 and their coarsest solve is an
  eigenvalue-floored float64 inverse (:func:`_floored_inverse`: the
  reference's float32 factor fails on the card on contrast-1e5 cells).

Inside the V-cycle fields are cell-major, (C, nodes, bs, s): a level's
matvec is then one neighbour gather and one batched matmul
(micro/block_stencil.py::torus_apply).  The chunk PCG's layout (nodes·bs,
s, C) is converted at the preconditioner's entry and exit.  The setup runs
without gradient: the preconditioner sits inside the implicit solve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from hommx_tpu_torch.micro.block_stencil import torus_apply, torus_neighbours

__all__ = ["build_mg_levels", "check_coarsest", "mg_setup", "mg_prec", "MAX_COARSE"]

#: most unknowns per cell the coarsest level may hold: a grid with an odd
#: side stops coarsening there, and its dense factor would be the fine
#: operator's (the reference has no such guard)
MAX_COARSE = 4096


def _signed_offsets(offsets: np.ndarray, shape) -> Optional[np.ndarray]:
    """Canonical (mod shape) offsets -> signed offsets in {-1, 0, 1}^d, or
    None if one reaches further (not a nearest-neighbour P1 stencil)."""
    sh = np.asarray(shape)
    signed = ((offsets + sh // 2) % sh) - sh // 2
    if np.abs(signed).max(initial=0) > 1:
        return None
    return signed.astype(np.int64)


def _hat(u: np.ndarray) -> float:
    return float(2.0 ** (-np.abs(u).sum()))


@dataclass
class _Level:
    shape: Tuple[int, ...]
    offsets: np.ndarray  # (K, dim) signed
    # Galerkin table mapping this level's weights to the next-coarser
    # stencil: (coarse offset index, fine offset index, shift u, coefficient);
    # None on the coarsest level
    table: Optional[list]
    coarse_offsets: Optional[np.ndarray]
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def self_k(self) -> int:
        return int(np.nonzero(np.abs(self.offsets).sum(axis=1) == 0)[0][0])

    def neighbours(self, device) -> torch.Tensor:
        key = ("nbr", str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(torus_neighbours(self.shape, self.offsets),
                                             device=device)
        return self._dev[key]

    def coarsening(self, dtype, device):
        """(src, M): the fine sites 2I+u of every (fine offset, shift) pair
        as indices into the (K·n) weights, (P, n_coarse), and the
        coefficients (Kc, P) that combine them into the coarse weights."""
        key = ("coarsen", dtype, str(device))
        if key not in self._dev:
            pairs, cols, rows = {}, [], []
            for ck, fk, u, coef in self.table:
                pk = (fk, tuple(int(x) for x in u))
                if pk not in pairs:
                    pairs[pk] = len(pairs)
                rows.append((ck, pairs[pk], coef))
            M = np.zeros((self.coarse_offsets.shape[0], len(pairs)))
            for ck, p, coef in rows:
                M[ck, p] += coef
            cshape = tuple(s // 2 for s in self.shape)
            cc = np.stack(np.unravel_index(np.arange(int(np.prod(cshape))), cshape), axis=-1)
            sh = np.asarray(self.shape)
            for (fk, u) in pairs:
                fine = np.ravel_multi_index(((2 * cc + np.asarray(u)) % sh).T, self.shape)
                cols.append(fk * self.n + fine)
            self._dev[key] = (torch.as_tensor(np.stack(cols), device=device),
                              torch.as_tensor(M, dtype=dtype, device=device))
        return self._dev[key]

    def dense_index(self, bs: int, device) -> torch.Tensor:
        """Flat (row·m + col) targets of the weights (K, n, bs, bs) in the
        dense (m, m) operator, m = n·bs."""
        key = ("dense", bs, str(device))
        if key not in self._dev:
            n, m = self.n, self.n * bs
            nbr = torus_neighbours(self.shape, self.offsets).T  # (K, n)
            bi = np.arange(bs)
            rows = np.arange(n)[None, :, None, None] * bs + bi[None, None, :, None]
            cols = nbr[:, :, None, None] * bs + bi[None, None, None, :]
            flat = np.broadcast_to(rows, cols.shape[:2] + (bs, bs)) * m + cols
            self._dev[key] = torch.as_tensor(flat.reshape(-1), device=device)
        return self._dev[key]


def build_mg_levels(offsets_signed: np.ndarray, shape) -> List[_Level]:
    """Host-side hierarchy plan: grid shapes, stencil offsets and the
    Galerkin tables, down to the coarsest grid (stop when any side is odd or
    <= 4).  The same tables as the reference's, entry for entry."""
    dim = len(shape)
    levels: List[_Level] = []
    cur_off = offsets_signed
    cur_shape = tuple(int(x) for x in shape)
    while True:
        if not all(s % 2 == 0 and s > 4 for s in cur_shape):
            levels.append(_Level(cur_shape, cur_off, None, None))
            break
        grids = np.meshgrid(*([np.array([-1, 0, 1])] * dim), indexing="ij")
        coarse_off = np.stack([g.ravel() for g in grids], axis=-1)
        key_of = {tuple(o): i for i, o in enumerate(coarse_off)}
        acc: dict = {}
        for fk, delta in enumerate(cur_off):
            for u in coarse_off:
                wu = _hat(u)
                for v in coarse_off:
                    t = u + delta - v
                    if np.all(t % 2 == 0):
                        Dlt = t // 2
                        if np.abs(Dlt).max(initial=0) > 1:
                            continue
                        k2 = (key_of[tuple(Dlt)], fk, tuple(u))
                        acc[k2] = acc.get(k2, 0.0) + (2.0 ** (-dim)) * wu * _hat(v)
        table = [(ck, fk, np.asarray(u), coef) for (ck, fk, u), coef in sorted(acc.items())
                 if coef != 0.0]
        levels.append(_Level(cur_shape, cur_off, table, coarse_off))
        cur_shape = tuple(s // 2 for s in cur_shape)
        cur_off = coarse_off
    return levels


def check_coarsest(levels: List[_Level], bs: int) -> None:
    """Raise ValueError when the coarsest level's dense operator would hold
    more than MAX_COARSE unknowns a cell (a grid side that turns odd above
    4 stops the coarsening early: a 15³ grid's coarsest level is the fine
    grid itself)."""
    level = levels[-1]
    if level.n * bs > MAX_COARSE:
        raise ValueError(
            f"cell_prec='mg': the coarsest level of the {levels[0].shape} torus grid is "
            f"{level.shape}, {level.n * bs} unknowns a cell (more than {MAX_COARSE}): the grid "
            f"coarsens only while every side is even and above 4; use a micro mesh whose "
            f"sides halve down to 4 or less, or cell_prec='k0inv'")


def _coarsen_weights(level: _Level, Wc: torch.Tensor) -> torch.Tensor:
    """Exact Galerkin coarse weights: Wc (C, K, n, bs, bs) -> (C, Kc, n/2^d,
    bs, bs)."""
    C, K, n, bs, _ = Wc.shape
    src, M = level.coarsening(Wc.dtype, Wc.device)
    S = Wc.reshape(C, K * n, bs * bs)[:, src.reshape(-1)]  # (C, P·nc, bs²)
    P, nc = src.shape
    out = M @ S.reshape(C, P, nc * bs * bs)  # (C, Kc, nc·bs²)
    return out.reshape(C, M.shape[0], nc, bs, bs)


def _mm(Wc: torch.Tensor) -> torch.Tensor:
    """Cell-major weights (C, K, n, bs, bs) in torus_apply's layout."""
    C, K, n, bs, _ = Wc.shape
    return Wc.permute(0, 2, 3, 1, 4).reshape(C * n, bs, K * bs)


def _apply_dinv(Dinv: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    C, n, bs, s = R.shape
    return torch.bmm(Dinv, R.reshape(C * n, bs, s)).reshape(C, n, bs, s)


def _lmax_est(level: _Level, nbr, Wmm, Dinv, C: int, bs: int, dtype, device) -> torch.Tensor:
    """Per-cell λ_max(D⁻¹A) by 8 power iterations from a fixed start, with
    1.1x headroom: (C, 1, 1, 1)."""
    idx = np.arange(level.n * bs, dtype=np.float64)
    x0 = np.sin(1.0 + 7.3 * idx) + 0.25 * np.sin(0.13 * idx * idx)
    x = torch.as_tensor(x0, dtype=dtype, device=device).reshape(1, level.n, bs, 1).expand(
        C, -1, -1, -1)
    tiny = 1e-30
    for _ in range(8):
        y = _apply_dinv(Dinv, torus_apply(nbr, Wmm, x))
        x = y / (torch.sqrt((y * y).sum(dim=(1, 2, 3), keepdim=True)) + tiny)
    y = _apply_dinv(Dinv, torus_apply(nbr, Wmm, x))
    lam = (x * y).sum(dim=(1, 2, 3), keepdim=True) / ((x * x).sum(dim=(1, 2, 3), keepdim=True)
                                                      + tiny)
    # headroom: Chebyshev diverges if λ_max is underestimated
    return 1.1 * lam


def _floored_inverse(Kd: torch.Tensor, floor: torch.Tensor) -> torch.Tensor:
    """Inverse (C, m, m) of the coarsest operators Kd with every eigenvalue
    raised to at least ``floor`` (C,), in float64: the coarse solve of a
    float32 V-cycle, applied in float64.

    The reference coarsens float32 weights in float32 and factors Kd +
    1e-6·tr(Kd)/m·I by Cholesky in float32.  On contrast-1e5 cells those
    float32 Galerkin products leave the coarsest operator's near-null
    (translation) modes at rounding level, below zero even after the shift
    (eigenvalues down to −1.4e-6 against 2.1 on 16³ fibre cells); there
    LAPACK returns a finite factor but the card's batched Cholesky returns
    NaN, and the cell falls back to the zero corrector.  The port coarsens
    in float64 instead, and the floor (at the reference's float32 jitter)
    keeps the solve exact on every mode above it."""
    K64 = Kd.double()
    lam, V = torch.linalg.eigh(0.5 * (K64 + K64.transpose(1, 2)))
    lam = torch.maximum(lam, floor.double()[:, None])
    return (V / lam[:, None, :]) @ V.transpose(1, 2)


@dataclass
class MGState:
    """The per-chunk V-cycle operators: per level the neighbour table, the
    matvec weights, the inverse self blocks and λ; the coarsest level's
    Cholesky factors."""

    nbrs: list
    Wmms: list
    Dinvs: list
    lams: list
    # (C, m, m) the coarsest operators' Cholesky factors (float64 weights),
    # or their floored float64 inverses (float32, :func:`_floored_inverse`)
    L: torch.Tensor
    bs: int


@torch.no_grad()
def mg_setup(levels: List[_Level], W_fine: torch.Tensor) -> MGState:
    """Coarsen the weights level by level, invert the self blocks, estimate
    the smoothing ranges and factor the coarsest dense operators.
    ``W_fine`` is (K, n_nodes, bs, bs, C), the block stencil's layout."""
    K, n, bs, _, C = W_fine.shape
    dt, dev = W_fine.dtype, W_fine.device
    # float32 weights are coarsened in float64 (see _floored_inverse)
    f32 = dt == torch.float32
    Wc = W_fine.permute(4, 0, 1, 2, 3).to(torch.float64 if f32 else dt)  # (C, K, n, bs, bs)
    nbrs, Wmms, Dinvs, lams = [], [], [], []
    for li, level in enumerate(levels):
        if li == len(levels) - 1:
            m = level.n * bs
            Kd = torch.zeros((C, m * m), dtype=Wc.dtype, device=dev)
            Kd.index_add_(1, level.dense_index(bs, dev), Wc.reshape(C, -1))
            Kd = Kd.reshape(C, m, m)
            tr = torch.diagonal(Kd, dim1=1, dim2=2).sum(dim=1) / m
            if f32:
                return MGState(nbrs, Wmms, Dinvs, lams, _floored_inverse(Kd, 1e-6 * tr), bs)
            # a tiny relative jitter keeps the factorization robust
            Kd = Kd + (1e-13 * tr)[:, None, None] * torch.eye(m, dtype=dt, device=dev)
            return MGState(nbrs, Wmms, Dinvs, lams, torch.linalg.cholesky_ex(Kd).L, bs)
        nbr = level.neighbours(dev)
        Wmm = _mm(Wc).to(dt)
        Dself = Wc[:, level.self_k].reshape(C * level.n, bs, bs)
        Dinv = (1.0 / Dself if bs == 1 else torch.linalg.inv(Dself)).to(dt)
        nbrs.append(nbr)
        Wmms.append(Wmm)
        Dinvs.append(Dinv)
        lams.append(_lmax_est(level, nbr, Wmm, Dinv, C, bs, dt, dev))
        Wc = _coarsen_weights(level, Wc)
    raise AssertionError("unreachable")


def _cheb_smooth(nbr, Wmm, Dinv, lam, x, b, nu: int):
    """Degree-ν Chebyshev smoothing of A x = b on [λ/4, 1.02·λ] of D⁻¹A (λ
    per cell); x None is the zero initial guess."""
    lmax = 1.02 * lam
    lmin = lam / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    if x is None:
        r = b
        x = torch.zeros_like(b)
    else:
        r = b - torus_apply(nbr, Wmm, x)
    d = _apply_dinv(Dinv, r) / theta
    for _ in range(nu - 1):
        x = x + d
        r = r - torus_apply(nbr, Wmm, d)
        z = _apply_dinv(Dinv, r)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        rho = rho_new
    return x + d


def _restrict(f: torch.Tensor, shape) -> torch.Tensor:
    """Full weighting (2^{-d} Pᵀ), separable per grid axis: (C, n, bs, s)
    on ``shape`` -> the next-coarser grid."""
    C = f.shape[0]
    f = f.reshape(C, *shape, *f.shape[2:])
    for ax in range(1, 1 + len(shape)):
        f = 0.5 * f + 0.25 * (torch.roll(f, 1, ax) + torch.roll(f, -1, ax))
        f = f[(slice(None),) * ax + (slice(0, None, 2),)]
    return f.reshape(C, -1, *f.shape[1 + len(shape):])


def _prolong(xc: torch.Tensor, cshape) -> torch.Tensor:
    """Periodic multilinear interpolation, separable per grid axis."""
    C = xc.shape[0]
    x = xc.reshape(C, *cshape, *xc.shape[2:])
    for ax in range(1, 1 + len(cshape)):
        odd = 0.5 * (x + torch.roll(x, -1, ax))
        y = torch.stack([x, odd], dim=ax + 1)
        sh = list(x.shape)
        sh[ax] *= 2
        x = y.reshape(sh)
    return x.reshape(C, -1, *xc.shape[2:])


def mg_prec(levels: List[_Level], state: MGState, nu: int = 2):
    """V(ν, ν)-cycle preconditioner ``prec(R) -> Z`` on the chunk layout R
    (n_nodes·bs, s, C)."""
    bs = state.bs

    def vcycle(li: int, b):
        level = levels[li]
        if li == len(levels) - 1:
            C, n, _, s = b.shape
            B = b.reshape(C, n * bs, s)
            if B.dtype == torch.float32:
                X = torch.bmm(state.L, B.double()).to(B.dtype)
            else:
                X = torch.cholesky_solve(B, state.L)
            return X.reshape(C, n, bs, s)
        nbr, Wmm, Dinv, lam = state.nbrs[li], state.Wmms[li], state.Dinvs[li], state.lams[li]
        x = _cheb_smooth(nbr, Wmm, Dinv, lam, None, b, nu)
        r = b - torus_apply(nbr, Wmm, x)
        xc = vcycle(li + 1, _restrict(r, level.shape))
        x = x + _prolong(xc, levels[li + 1].shape)
        return _cheb_smooth(nbr, Wmm, Dinv, lam, x, b, nu)

    def prec(R):
        nbs, s, C = R.shape
        Rc = R.reshape(nbs // bs, bs, s, C).permute(3, 0, 1, 2).contiguous()
        return vcycle(0, Rc).permute(1, 2, 3, 0).reshape(nbs, s, C)

    return prec
