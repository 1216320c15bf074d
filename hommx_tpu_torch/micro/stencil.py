"""Periodic-stencil micro matvec for the chunk block-PCG, scalar P1 (torch
port of ``hommx_tpu/micro/stencil.py``).

Cell-problem micro meshes are box-periodic structured grids, so the reduced
periodic dof space is the torus grid and the per-cell operator couples each
node to a FIXED small set of periodic grid offsets (7 in 2D, <= 15 in 3D).
The matvec is Σ_k w_k ⊙ roll(p, -Δ_k) on (grid…, s, C) arrays with the cell
axis C minor.  The weights w_k(node, c) are linear in the reduced
coefficient ``a`` and assemble per chunk from host-built tables (one dense
matmul on small cell meshes, a gather-reduce on large ones).  Nullspace
pinning is folded into the weights (zeroed couplings and an identity
self-weight at pinned rows).

The tables are host numpy (built once per engine); their device copies are
cached per (dtype, device) on the stencil object, so a chunk loop uploads
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "MicroStencil",
    "build_stencil",
    "stencil_weights",
    "scale_weights",
    "stencil_rhs",
    "stencil_astar",
    "stencil_matvec",
    "torus_matvec",
    "torus_coords",
]

# Size gate for the dense matmul formulations (entries of K·n·nE): above
# it the gather tables' sparsity wins (16x16 cell mesh: 0.9M; 32x32: 14.7M).
_DENSE_CAP = 4_000_000


@dataclass
class MicroStencil:
    """Static stencil data (host numpy) plus cached device copies."""

    shape: Tuple[int, ...]  # torus grid dims, prod = n_reduced
    offsets: np.ndarray  # (K, dim) periodic grid offsets (non-negative)
    te: List[np.ndarray]  # per offset: (n, M_k) element indices (pad = nE)
    gB: List[np.ndarray]  # per offset: (n, M_k, r, r) geometry tensors
    gw: List[np.ndarray]  # per offset: (n, M_k) identity-contracted gB
    self_k: int  # index of the zero offset (self coupling)
    pinned: np.ndarray  # pinned reduced node ids (identity rows)
    teF: np.ndarray  # (n, MF) element indices of (e, i) -> node contributions
    gD: np.ndarray  # (n, MF, r) test gradients D_{e,i} (zeroed at pins)
    Wd: Optional[np.ndarray] = None  # (K·n, nE) identity-B_K weight map
    Wsym: Optional[np.ndarray] = None  # (K, n, nE, nsym) B_K-sym weight map
    WF: Optional[np.ndarray] = None  # (n, nE, r) dense RHS gradient map
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def tensor(self, name: str, dtype, device, k: Optional[int] = None):
        """Device copy of table ``name`` (entry ``k`` of a per-offset list),
        cast to ``dtype`` (integer tables keep int64)."""
        key = (name, k, dtype, str(device))
        t = self._dev.get(key)
        if t is None:
            arr = getattr(self, name)
            arr = arr if k is None else arr[k]
            if np.issubdtype(np.asarray(arr).dtype, np.integer):
                t = torch.as_tensor(np.asarray(arr, dtype=np.int64), device=device)
            else:
                t = torch.as_tensor(arr, dtype=dtype, device=device)
            self._dev[key] = t
        return t


def torus_coords(engine):
    """(shape, coords) of the reduced periodic node space as the raster torus
    grid, or None if the micro mesh is not a structured box whose reduced
    nodes raster-order onto the grid."""
    st = engine.mesh.structure
    if st is None:
        return None
    shape = tuple(int(x) for x in np.asarray(st.shape))
    n_nodes = engine.n_reduced
    if int(np.prod(shape)) != n_nodes:
        return None
    red = np.asarray(engine.pmap.reduced_index)
    first = np.full(n_nodes, -1, dtype=np.int64)
    seen = np.zeros(n_nodes, dtype=bool)
    for v, p in enumerate(red):
        if not seen[p]:
            seen[p] = True
            first[p] = v
    verts = np.asarray(engine.mesh.vertices, dtype=np.float64)[first]
    lo = np.asarray(st.lo, dtype=np.float64)
    h = (np.asarray(st.hi, dtype=np.float64) - lo) / np.asarray(shape)
    coords = np.rint((verts - lo) / h).astype(np.int64) % np.asarray(shape)
    if not np.array_equal(np.ravel_multi_index(coords.T, shape), np.arange(n_nodes)):
        return None
    return shape, coords


def build_stencil(engine) -> Optional[MicroStencil]:
    """Host-side stencil construction for a MicroEngine, or None when the
    micro mesh is not a raster-ordered structured box."""
    tc = torus_coords(engine)
    if tc is None:
        return None
    shape, coords = tc
    n = engine.n_reduced
    dim = engine.d

    loc2red = np.asarray(engine.loc2red_np)  # (ne, nbl)
    # the weights are built from the compute-dtype gradient operator, as
    # the reference does (it reads the dtype-cast ``engine.Draw``)
    Draw = engine.Draw.detach().cpu().numpy().astype(np.float64)
    pin = np.asarray(engine.pin_np)
    ne, nbl = loc2red.shape
    r = engine.r
    grid_of = coords

    # group contributions by periodic offset Δ = grid(q) − grid(p)
    groups: dict = {}
    for i in range(nbl):
        for j in range(nbl):
            p = loc2red[:, i]
            q = loc2red[:, j]
            off = (grid_of[q] - grid_of[p]) % np.asarray(shape)
            g = Draw[:, :, i][:, :, None] * Draw[:, :, j][:, None, :]
            # pinning: zero couplings with a pinned endpoint; the identity
            # at pinned rows is restored in stencil_weights
            dead = pin[p] | pin[q]
            g = np.where(dead[:, None, None], 0.0, g)
            for e in range(ne):
                groups.setdefault(tuple(off[e]), []).append((int(p[e]), e, g[e]))

    offsets = sorted(groups.keys())
    zero = tuple([0] * dim)
    if zero not in offsets:
        offsets.append(zero)
        groups[zero] = []
        offsets = sorted(offsets)
    te_list, gB_list, gw_list = [], [], []
    for off in offsets:
        per_node: List[list] = [[] for _ in range(n)]
        for p, e, g in groups[off]:
            per_node[p].append((e, g))
        M = max(1, max(len(c) for c in per_node))
        te = np.full((n, M), ne, dtype=np.int32)  # pad slot = ne (a = 0)
        gB = np.zeros((n, M, r, r), dtype=np.float64)
        for p, contribs in enumerate(per_node):
            for m, (e, g) in enumerate(contribs):
                te[p, m] = e
                gB[p, m] = g
        te_list.append(te)
        gB_list.append(gB)
        gw_list.append(np.einsum("nmrr->nm", gB))

    # RHS table: per node p, the (e, i) contributions with loc2red[e, i] = p
    per_node_F: List[list] = [[] for _ in range(n)]
    for i in range(nbl):
        p = loc2red[:, i]
        for e in range(ne):
            if not pin[p[e]]:
                per_node_F[p[e]].append((e, Draw[e, :, i]))
    MF = max(1, max(len(c) for c in per_node_F))
    teF = np.full((n, MF), ne, dtype=np.int32)
    gD = np.zeros((n, MF, r), dtype=np.float64)
    for p, contribs in enumerate(per_node_F):
        for m, (e, g) in enumerate(contribs):
            teF[p, m] = e
            gD[p, m] = g

    K = len(te_list)
    Wd = Wsym = WF = None
    if K * n * ne <= _DENSE_CAP:
        nsym = r * (r + 1) // 2
        Wd = np.zeros((K, n, ne), dtype=np.float64)
        Wsym = np.zeros((K, n, ne, nsym), dtype=np.float64)
        pairs = [(i, i) for i in range(r)] + [
            (i, j) for i in range(r) for j in range(i + 1, r)
        ]
        for k in range(K):
            tek, gBk = te_list[k], gB_list[k]
            for p in range(n):
                for m in range(tek.shape[1]):
                    e = tek[p, m]
                    if e >= ne:
                        continue
                    Wd[k, p, e] += np.trace(gBk[p, m])
                    for si, (i, j) in enumerate(pairs):
                        v = gBk[p, m, i, j]
                        if i != j:
                            v = v + gBk[p, m, j, i]
                        Wsym[k, p, e, si] += v
        Wd = Wd.reshape(K * n, ne)
        WF = np.zeros((n, ne, r), dtype=np.float64)
        for p in range(n):
            for m in range(teF.shape[1]):
                e = teF[p, m]
                if e < ne:
                    WF[p, e] += gD[p, m]
    return MicroStencil(
        shape=shape,
        offsets=np.asarray(offsets, dtype=np.int64),
        te=te_list,
        gB=gB_list,
        gw=gw_list,
        self_k=offsets.index(zero),
        pinned=np.nonzero(pin)[0],
        teF=teF,
        gD=gD,
        Wd=Wd,
        Wsym=Wsym,
        WF=WF,
    )


def stencil_weights(st: MicroStencil, a: torch.Tensor, B_K=None):
    """Per-chunk stencil weights, one (n, C) tensor per offset.

    Dense form (``st.Wd`` present): one (K·n, nE)-by-(nE, C) matmul.
    Gather form (cell meshes above the dense size gate): per offset, a
    (C, n, M) gather from ``a`` and a contraction with the static geometry.

    Args:
        a: (C, nE) reduced scalar coefficient.
        B_K: optional per-cell (C, r, r) gradient-map Gram GᵀG; None means
            identity.
    """
    C = a.shape[0]
    K = len(st.te)
    n = st.te[0].shape[0]
    dt, dev = a.dtype, a.device
    if st.Wd is not None and B_K is None:
        W = st.tensor("Wd", dt, dev)  # (K·n, nE)
        ws_all = (W @ a.T).reshape(K, n, C)
        ws = [ws_all[k] for k in range(K)]
    elif st.Wsym is not None and B_K is not None:
        r = B_K.shape[-1]
        nsym = r * (r + 1) // 2
        Wsym = st.tensor("Wsym", dt, dev)  # (K, n, nE, nsym)
        t1 = (
            Wsym.permute(0, 1, 3, 2).reshape(K * n * nsym, -1) @ a.T
        ).reshape(K, n, nsym, C)
        pairs = [(i, i) for i in range(r)] + [
            (i, j) for i in range(r) for j in range(i + 1, r)
        ]
        Bs = torch.stack([B_K[:, i, j] for (i, j) in pairs], dim=0)  # (nsym, C)
        ws_all = torch.einsum("knsc,sc->knc", t1, Bs)
        ws = [ws_all[k] for k in range(K)]
    else:
        a_pad = torch.cat([a, torch.zeros((C, 1), dtype=dt, device=dev)], dim=1)
        ws = []
        for k in range(K):
            av = a_pad[:, st.tensor("te", dt, dev, k)]  # (C, n, M)
            if B_K is None:
                wk = torch.einsum("cnm,nm->nc", av, st.tensor("gw", dt, dev, k))
            else:
                wk = torch.einsum(
                    "cnm,nmrt,crt->nc", av, st.tensor("gB", dt, dev, k), B_K
                )
            ws.append(wk)
    if st.pinned.size:
        ws[st.self_k] = ws[st.self_k].clone()
        ws[st.self_k][st.tensor("pinned", dt, dev), :] = 1.0
    return ws


def _roll_grid(x: torch.Tensor, shape, off) -> torch.Tensor:
    """roll(x, -off) over the leading grid axes of x (grid…, rest…)."""
    if all(int(o) == 0 for o in off):
        return x
    return torch.roll(
        x, shifts=tuple(-int(o) for o in off), dims=tuple(range(len(shape)))
    )


def scale_weights(st: MicroStencil, ws, sc2: torch.Tensor):
    """Fold the symmetric diagonal scaling into the weights:
    ``ws_s[k] = sc2 ⊙ ws[k] ⊙ roll(sc2, -Δk)`` so a solver runs on the
    scaled operator S K S with no scaling inside its loop.  ``sc2`` is
    (n, C) with 1.0 at pinned rows."""
    n, C = sc2.shape
    g = sc2.reshape(*st.shape, C)
    return [
        sc2 * ws[k] * _roll_grid(g, st.shape, off).reshape(n, C)
        for k, off in enumerate(st.offsets)
    ]


def stencil_rhs(st: MicroStencil, a: torch.Tensor, E: torch.Tensor, TE=None):
    """Generator load F = −D2ᵀ(Ā Tᵀ E) (keep-masked) -> (n, s, C).

    Args:
        a: (C, nE) reduced coefficient.
        E: (r, s) static generators (used when TE is None).
        TE: optional per-cell (C, r, s) mapped generators Tᵀ(c)·E.
    """
    C = a.shape[0]
    dt, dev = a.dtype, a.device
    if st.WF is not None:
        WF = st.tensor("WF", dt, dev)  # (n, nE, r)
        n, nE, r = WF.shape
        if TE is None:
            RE = torch.einsum("ner,rs->nse", WF, E)
            s = E.shape[1]
            return -(RE.reshape(n * s, nE) @ a.T).reshape(n, s, C)
        H = (WF.permute(0, 2, 1).reshape(n * r, nE) @ a.T).reshape(n, r, C)
        return -torch.einsum("nrc,crs->nsc", H, TE)
    a_pad = torch.cat([a, torch.zeros((C, 1), dtype=dt, device=dev)], dim=1)
    av = a_pad[:, st.tensor("teF", dt, dev)]  # (C, n, MF)
    gD = st.tensor("gD", dt, dev)
    if TE is None:
        gE = torch.einsum("nmr,rs->nms", gD, E)
        return -torch.einsum("cnm,nms->nsc", av, gE)
    return -torch.einsum("cnm,nmr,crs->nsc", av, gD, TE)


def stencil_astar(st: MicroStencil, ws, a, E, F, X):
    """Homogenized tensor by the exact bilinear expansion

        (Σ_e a_e)·(EᵀE) − FᵀX̃ − X̃ᵀF + X̃ᵀ K X̃

    valid for any iterate X̃ (X̃ and F vanish at pinned rows).

    Returns: (C, s, s) — NOT divided by |Y|.
    """
    a_sum = a.sum(dim=1)
    T1 = a_sum[:, None, None] * (E.T @ E)[None]
    FX = torch.einsum("nsc,ntc->cst", F, X)
    KX = stencil_matvec(st, ws, X)
    XKX = torch.einsum("nsc,ntc->cst", X, KX)
    return T1 - FX - FX.transpose(-1, -2) + XKX


def stencil_matvec(st: MicroStencil, ws, P: torch.Tensor) -> torch.Tensor:
    """K·P via periodic rolls: P (n, s, C) -> (n, s, C)."""
    return torus_matvec(st.shape, st.offsets, ws, P)


def torus_matvec(shape, offsets, ws, P: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k ⊙ roll(P, −Δ_k) on the torus grid ``shape``: P (n, s, C),
    ws K (n, C) weights, offsets (K, dim) -> (n, s, C)."""
    n, s, C = P.shape
    Pg = P.reshape(*shape, s, C)
    out = None
    for k, off in enumerate(offsets):
        term = ws[k].reshape(*shape, 1, C) * _roll_grid(Pg, shape, off)
        out = term if out is None else out + term
    return out.reshape(n, s, C)
