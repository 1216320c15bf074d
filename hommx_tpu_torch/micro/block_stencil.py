"""Block periodic-stencil micro matvec, vector problems, P1 (torch port of
``hommx_tpu/micro/block_stencil.py``).

On a structured box micro mesh the reduced periodic NODES are the torus
grid, and a vector (elasticity) cell operator couples each node to a fixed
set of periodic grid offsets (<= 3^d) with one (bs, bs) block per (node,
offset):

    K[p·bs+bi, q·bs+bj] = Σ_{e,a,b} D_{e,(a,bi)}ᵀ A_K(c, e) D_{e,(b,bj)},
        node(e, a) = p, node(e, b) = q, Δ = grid(q) − grid(p).

So K·P = Σ_k W_k · roll(P, −Δ_k) on (grid…, bs, s, C) with the cell axis C
minor.  The weights W (K, n_nodes, bs, bs, C) are assembled per chunk from
the element blocks Drawᵀ A_K Draw by one static scatter onto the (node,
offset) targets — O(n·3^d·bs²) values a cell, so a 16³ elasticity cell
holds a few MB where its dense K would take 600 MB.  Pinning is folded in
as in the scalar stencil: couplings with a pinned endpoint are zeroed and
the pinned node's self block is the identity.

The matvec gathers the K shifted copies of P in one index (the neighbour
table of :func:`torus_neighbours`) and contracts them with the weights in
one batched matmul, (bs, K·bs) by (K·bs, s) per (cell, node): the same sum
as the reference's K rolls and block products, in two device operations.
The torus multigrid (micro/mg_prec.py) applies its levels the same way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "BlockStencil",
    "build_block_stencil",
    "block_stencil_weights",
    "block_stencil_matvec",
    "scale_block_weights",
    "torus_neighbours",
    "torus_apply",
    "mm_weights",
]


@dataclass
class BlockStencil:
    """Static block-stencil data (host numpy) plus cached device copies."""

    shape: Tuple[int, ...]  # torus grid dims, prod = n_nodes
    bs: int  # block size (= dim for elasticity)
    offsets: np.ndarray  # (K, dim) periodic grid offsets (canonical mod shape)
    tgt: np.ndarray  # (nE·nnd·nnd,) scatter target node·K + k
    keep: np.ndarray  # (nE·nnd·nnd,) 0/1 pin mask per contribution
    self_k: int  # index of the zero offset
    pinned: np.ndarray  # pinned reduced node ids
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def neighbours(self, device) -> torch.Tensor:
        """(n_nodes, K) neighbour table on ``device`` (cached)."""
        key = ("nbr", str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(torus_neighbours(self.shape, self.offsets),
                                             device=device)
        return self._dev[key]


def torus_neighbours(shape, offsets) -> np.ndarray:
    """(n, K) int64 table: entry [p, k] is the node at grid(p) + Δ_k on the
    torus ``shape`` (raster order), so ``P[nbr[:, k]] == roll(P, −Δ_k)``."""
    sh = np.asarray(shape)
    n = int(np.prod(sh))
    coords = np.stack(np.unravel_index(np.arange(n), tuple(shape)), axis=-1)
    off = np.asarray(offsets, dtype=np.int64)
    moved = (coords[:, None, :] + off[None, :, :]) % sh
    return np.ravel_multi_index(np.moveaxis(moved, -1, 0), tuple(shape)).astype(np.int64)


def mm_weights(W: torch.Tensor) -> torch.Tensor:
    """Block weights W (K, n, bs, bs, C) in the matvec's layout (C·n, bs, K·bs)."""
    K, n, bs, _, C = W.shape
    return W.permute(4, 1, 2, 0, 3).reshape(C * n, bs, K * bs)


def torus_apply(nbr: torch.Tensor, Wmm: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """K·X on cell-major fields X (C, n, bs, s) -> (C, n, bs, s): one
    gather of the K neighbours of every node, one batched matmul."""
    C, n, bs, s = X.shape
    G = X[:, nbr]  # (C, n, K, bs, s)
    return torch.bmm(Wmm, G.reshape(C * n, -1, s)).reshape(C, n, bs, s)


def build_block_stencil(engine) -> Optional[BlockStencil]:
    """Host-side block-stencil construction for a MicroEngine, or None when
    the micro mesh is not a structured box whose reduced nodes raster-order
    onto the torus grid.  Works for any block size (bs = 1 gives the scalar
    stencil's couplings as 1×1 blocks)."""
    from hommx_tpu_torch.micro.stencil import torus_coords

    tc = torus_coords(engine)
    if tc is None:
        return None
    shape, coords = tc
    red = np.asarray(engine.pmap.reduced_index)
    red_cells = red[np.asarray(engine._node_cells)]  # (nE, nnd) reduced node per local node
    sh = np.asarray(shape)
    # per (e, a, b): offset Δ = grid(node(e, b)) − grid(node(e, a)) mod shape
    p = red_cells[:, :, None]
    q = red_cells[:, None, :]
    off = (coords[q] - coords[p]) % sh  # (nE, nnd, nnd, dim)
    off_flat = np.ravel_multi_index(np.moveaxis(off, -1, 0), shape)
    keys = np.unique(off_flat)
    offsets = np.stack(np.unravel_index(keys, shape), axis=-1)  # (K, dim)
    k_of = np.full(int(np.prod(shape)), -1, dtype=np.int64)
    k_of[keys] = np.arange(keys.size)
    K = keys.size
    # the engine pins the bs dofs of reduced vertex 0: as a node set, node 0
    pin_nodes = np.zeros(int(np.prod(shape)), dtype=bool)
    pin_nodes[0] = True
    tgt = (p * K + k_of[off_flat]).reshape(-1)
    keep = np.logical_not(pin_nodes[p] | pin_nodes[q]).astype(np.float64).reshape(-1)
    zero = int(np.ravel_multi_index((0,) * len(shape), shape))
    return BlockStencil(
        shape=shape,
        bs=engine.bs,
        offsets=offsets.astype(np.int64),
        tgt=tgt.astype(np.int64),
        keep=keep,
        self_k=int(k_of[zero]),
        pinned=np.nonzero(pin_nodes)[0],
    )


def block_stencil_weights(st: BlockStencil, engine, A_K: torch.Tensor) -> torch.Tensor:
    """Per-chunk block weights W (K, n_nodes, bs, bs, C) from the mapped
    element blocks A_K (C, nE, r, r): the element blocks Drawᵀ A_K Draw,
    grouped by (node, offset) — a scatter-add, or on an engine whose Kc
    assembly is the gather (the CUDA default) the same sum in a fixed
    order."""
    from hommx_tpu_torch.micro.chunk import kc_assembly_mode

    C = A_K.shape[0]
    bs = st.bs
    nE, nnd = np.asarray(engine._node_cells).shape
    n_nodes = int(np.prod(st.shape))
    K = st.offsets.shape[0]
    dt, dev = A_K.dtype, A_K.device
    Draw = engine._static("Draw", A_K)
    blocks = torch.einsum("erl,cert,etm->celm", Draw, A_K, Draw)  # (C, nE, nbl, nbl)
    # (C, nE, a, bi, b, bj) -> (C, nE·nnd·nnd, bs, bs)
    vals = blocks.reshape(C, nE, nnd, bs, nnd, bs).transpose(3, 4).reshape(C, -1, bs, bs)
    key = ("keep", dt, str(dev))
    if key not in st._dev:
        st._dev[key] = torch.as_tensor(st.keep, dtype=dt, device=dev)
    vals = vals * st._dev[key][None, :, None, None]
    if kc_assembly_mode(dev) == "gather":
        pkey = ("plan", str(dev))
        if pkey not in st._dev:
            from hommx_tpu_torch.ops.assembly import GatherPlan, invert_scatter

            st._dev[pkey] = GatherPlan(invert_scatter(st.tgt, n_nodes * K), st.tgt.size, dev)
        from hommx_tpu_torch.ops.assembly import gather_sum

        W = gather_sum(vals.permute(0, 2, 3, 1), st._dev[pkey]).permute(0, 3, 1, 2)
    else:
        W = torch.zeros((C, n_nodes * K, bs, bs), dtype=dt, device=dev)
        W = W.index_add(1, torch.as_tensor(st.tgt, device=dev), vals)
    W = W.reshape(C, n_nodes, K, bs, bs)
    if st.pinned.size:
        # identity self block at pinned nodes (replaces the keep/pin guards)
        W[:, torch.as_tensor(st.pinned, device=dev), st.self_k] = torch.eye(
            bs, dtype=dt, device=dev)
    # cells minor: (K, n_nodes, bs, bs, C)
    return W.permute(2, 1, 3, 4, 0)


def block_stencil_matvec(st: BlockStencil, W: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """K·P for P (n_nodes·bs, s, C) -> the same shape, W as returned by
    :func:`block_stencil_weights`."""
    nbs, s, C = P.shape
    n = nbs // st.bs
    X = P.reshape(n, st.bs, s, C).permute(3, 0, 1, 2)
    out = torus_apply(st.neighbours(P.device), mm_weights(W), X)
    return out.permute(1, 2, 3, 0).reshape(nbs, s, C)


def scale_block_weights(st: BlockStencil, W: torch.Tensor, sc2: torch.Tensor) -> torch.Tensor:
    """Fold the symmetric diagonal scaling into the block weights:
    (S K S)[p·bs+bi, (p+Δ)·bs+bj] = sc[p,bi]·W_k[p,bi,bj]·sc[p+Δ,bj].
    ``sc2`` is (n_nodes·bs, C) with 1.0 at pinned dofs, which keeps the
    identity self block at pins exactly."""
    n_nodes = int(np.prod(st.shape))
    C = sc2.shape[-1]
    scn = sc2.reshape(n_nodes, st.bs, C)
    nbr = st.neighbours(sc2.device)  # (n, K)
    rolled = scn[nbr].permute(1, 0, 2, 3)  # (K, n, bs, C): sc at p + Δ_k
    return W * scn[None, :, :, None, :] * rolled[:, :, None, :, :]
