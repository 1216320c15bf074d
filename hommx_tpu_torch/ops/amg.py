"""Aggregation algebraic multigrid for unstructured macro systems (torch
port of ``hommx_tpu/ops/amg.py``).

The preconditioner of the macro CG where the geometric hierarchy
(ops/multigrid.py) declines: Delaunay and file meshes, P2 dof layouts.  It
stands in for PETSc GAMG, which the reference's users run on any mesh.

* **The hierarchy is host numpy, built once per mesh** and copied from the
  reference array for array (the same constants and the same seeded power
  vectors): greedy aggregation on the ELL adjacency graph (the native
  host runtime's sweep, or the Python one: the same output), a
  singleton merge, and for the smoothed hierarchy (the default) the static
  patterns of P, AP and PᵀAP with their contributor tables.
* **Smoothed aggregation with static sparsity.**  P's pattern does not
  depend on the values, so only P's values are computed per operator:
  P = (I − ω D⁻¹A) P₀ with ω = 4/(3 λmax(D⁻¹A)), P₀ the per-aggregate QR
  of the near-null space (the translations, or the rigid-body modes of an
  elasticity system, ``models/common.py::MacroSystem._rigid_modes``).  The
  triple product is two sums over the static contributor tables.  Plain
  aggregation (``smoothed=False``) keeps a piecewise-constant P and
  over-corrects the coarse correction by ``_OVERCORRECT``.
* **Device data.**  :func:`amg_setup` and :func:`amg_vcycle` read each
  level's static arrays from one table object made once per structure,
  level, device and dtype (:meth:`AMGStructure.tables`), so no cycle
  copies from the host.  Row sums come from the (N, K) layout.  On a
  CUDA device every sum that the reference scatters (P's values, the two
  triple-product sums, the plain Galerkin sum, the restriction of every
  cycle) runs as fixed-order gathers over the inverted tables
  (:class:`_Sum`, ops/assembly.py::GatherPlan): ``index_add_`` on CUDA
  adds colliding entries in the order its atomics land, so two identical
  solves would differ in the last bits.  The CPU keeps ``index_add_``,
  which adds in order.
* **Bottom level**: a dense Cholesky inverse in the working dtype below
  ``bottom_max`` unknowns (the reference's non-TPU branch).  Where the
  factorization fails (a semidefinite coarse operator, see
  :func:`_pseudo_inverse`) it is the pseudo-inverse; the reference's
  Cholesky returns NaN there.

The reference is plain ``jnp`` with no Pallas kernel, so this is plain
torch.  Its TPU branches (the Newton–Schulz inverse, the float32 cast of a
float64 V-cycle) are not ported.  The V-cycle (equal pre- and post-
Chebyshev smoothing of degree ``_CHEB_DEGREE``, a variational hierarchy)
is SPD and preconditions CG (ops/solvers.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from hommx_tpu_torch import native
from hommx_tpu_torch.ops.assembly import GatherPlan, gather_sum, invert_scatter
from hommx_tpu_torch.ops.multigrid import _cheby, _cheby_from
from hommx_tpu_torch.ops.sparse import ell_to_dense, spmv

__all__ = ["AMGStructure", "build_amg_structure", "amg_setup", "amg_vcycle"]

#: target coarsest size for the dense bottom inverse (as ops/multigrid.py)
_BOTTOM_MAX = 1500
#: stop coarsening when a level shrinks by less than this factor
_MIN_COARSEN = 1.2
#: Chebyshev smoothing degree, one higher than the geometric hierarchy's:
#: aggregation transfers leave more of the work to the smoother
_CHEB_DEGREE = 3
#: plain aggregation's coarse-correction over-relaxation: the piecewise-
#: constant coarse space underestimates corrections; ω ∈ (0, 2) keeps the
#: cycle symmetric.  The smoothed hierarchy uses 1
_OVERCORRECT = 1.8


@dataclasses.dataclass(frozen=True)
class _ALevel:
    """One level: its ELL pattern and the transfer data down to the next.

    ``cols``/``diag_slots`` describe this level's operator; the transfer
    members are None on the bottom level.  The ``p_*``/``ap_*``/``c_*``
    members are the smoothed-aggregation index maps (None on plain
    hierarchies), built by :func:`_sa_maps`.
    """

    n_dofs: int
    cols: np.ndarray  # (N, K) ELL column indices
    diag_slots: np.ndarray  # (N,)
    slot_rows: np.ndarray  # (N*K,) row of each flat slot
    real_slots: np.ndarray  # (N*K,) bool, structurally present entries
    agg_dof: Optional[np.ndarray] = None  # (N,) fine dof -> coarse dof
    slot_map: Optional[np.ndarray] = None  # (N*K,) flat slot -> coarse slot
    power_vec: Optional[np.ndarray] = None  # λmax power-iteration start
    # --- smoothed-aggregation transfer (None on plain hierarchies) ---
    p_cols: Optional[np.ndarray] = None  # (N, KP) coarse col of each P slot
    p_rows: Optional[np.ndarray] = None  # (N*KP,) row of each flat P slot
    p0_slot: Optional[np.ndarray] = None  # (N, m) P slots of the tentative P₀
    p0_w: Optional[np.ndarray] = None  # (N, m) static P₀ kernel weights
    a_to_p: Optional[np.ndarray] = None  # (N*K, m) A slot -> P slots (trash pad)
    ps_w: Optional[np.ndarray] = None  # (N*K, m) static smoothing weights w0[j]
    ap_contrib: Optional[tuple] = None  # (a_slot, p_slot, ap_slot) arrays
    n_ap: int = 0  # flat size of the AP value array
    c_contrib: Optional[tuple] = None  # (p_slot, ap_slot, out_slot) arrays


@dataclasses.dataclass(frozen=True)
class AMGStructure:
    """The static hierarchy, with a cache of each level's device tables
    (:meth:`tables`) and the host build's seconds (``timings``: the
    aggregation sweep, the per-aggregate QR, the smoothed-aggregation maps
    and the whole build)."""

    bs: int
    levels: tuple  # of _ALevel
    smoothed: bool = False
    timings: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def level_sizes(self) -> list:
        return [lev.n_dofs for lev in self.levels]

    def tables(self, level: int, device, dtype) -> "_Tables":
        """Level ``level``'s static arrays on ``device`` (the float weights
        in ``dtype``), made once per structure, level, device and dtype."""
        device = torch.device(device)
        # the sums' form follows _fixed_order, so it is part of the key
        key = (level, str(device), dtype, _fixed_order(device))
        out = self._dev.get(key)
        if out is None:
            out = self._dev[key] = _level_tables(self, level, device, dtype)
        return out


class _Sum:
    """``out[targets[i]] += src[i]`` over ``n_out`` targets, a source aimed
    at or past ``n_out`` (the reference's trash slot) dropped.  Where
    :func:`_fixed_order` holds, fixed-order gathers over the inverted table:
    a ``GatherPlan`` (a group per multiplicity), or with ``padded`` one
    padded table (one gather and one sum: the restriction, run every
    cycle); otherwise an in-order ``index_add_``."""

    def __init__(self, targets, n_out: int, device, padded: bool = False):
        self.n_out = n_out
        self.plan = self.table = self.targets = None
        if not _fixed_order(device):
            self.targets = torch.as_tensor(np.minimum(targets, n_out), device=device)
        elif padded:
            self.table = _inverted_table(targets, n_out, device)
        else:
            self.plan = GatherPlan(_inverted_table(targets, n_out, device),
                                   np.asarray(targets).size, device)

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        if self.table is not None:
            return torch.cat([src, src.new_zeros(1)])[self.table].sum(dim=1)
        if self.plan is not None:
            return gather_sum(src, self.plan)
        return src.new_zeros(self.n_out + 1).index_add_(0, self.targets, src)[:self.n_out]


@dataclasses.dataclass(frozen=True)
class _Tables:
    """One level's static arrays on one device: its operator's pattern and
    λmax start, and the transfer down to the next level (None on the
    bottom level): on smoothed hierarchies P's pattern, P₀'s and the
    smoothing term's weights, the triple product's contributor slots and
    the sums P (both terms), AP, PᵀAP and the restriction Pᵀr; on plain
    ones the aggregate map, the Galerkin sum and the restriction."""

    cols: torch.Tensor  # (N, K)
    diag_slots: torch.Tensor  # (N,)
    power_vec: Optional[torch.Tensor] = None
    p0_w: Optional[torch.Tensor] = None  # (N, m)
    ps_w: Optional[torch.Tensor] = None  # (N*K, m)
    p_rows: Optional[torch.Tensor] = None  # (N*KP,)
    p_cols: Optional[torch.Tensor] = None  # (N*KP,)
    ap_a: Optional[torch.Tensor] = None  # AP's contributions: A slot,
    ap_p: Optional[torch.Tensor] = None  # P slot
    c_p: Optional[torch.Tensor] = None  # PᵀAP's contributions: P slot,
    c_ap: Optional[torch.Tensor] = None  # AP slot
    agg_dof: Optional[torch.Tensor] = None  # (N,)
    p_sum: Optional[_Sum] = None
    ap_sum: Optional[_Sum] = None
    c_sum: Optional[_Sum] = None
    galerkin_sum: Optional[_Sum] = None
    restrict_sum: Optional[_Sum] = None


def _sum_targets(struct: AMGStructure, level: int) -> dict:
    """The level's scatter-adds as (target of every source, number of
    targets): ``p`` (P's values, both terms), ``ap`` and ``c`` (the triple
    product's two sums), ``restrict`` (Pᵀr; P's padding slots left out) on
    smoothed hierarchies, ``galerkin`` and ``restrict`` on plain ones."""
    lev, nxt = struct.levels[level], struct.levels[level + 1]
    n_c = nxt.n_dofs * nxt.cols.shape[1]
    if not struct.smoothed:
        return {"galerkin": (lev.slot_map, n_c), "restrict": (lev.agg_dof, nxt.n_dofs)}
    NP = lev.n_dofs * lev.p_cols.shape[1]
    real = np.zeros(NP + 1, dtype=bool)  # P's structurally present slots
    real[lev.p0_slot.reshape(-1)] = True
    real[lev.a_to_p.reshape(-1)] = True
    return {"p": (np.concatenate([lev.p0_slot.reshape(-1), lev.a_to_p.reshape(-1)]), NP),
            "ap": (lev.ap_contrib[2], lev.n_ap),
            "c": (lev.c_contrib[2], n_c),
            "restrict": (np.where(real[:NP], lev.p_cols.reshape(-1), nxt.n_dofs), nxt.n_dofs)}


def _level_tables(struct: AMGStructure, level: int, device, dtype) -> _Tables:
    """The level's host arrays copied to ``device`` (indices as int64,
    weights in ``dtype``) and its sums built there: the cache entry of
    :meth:`AMGStructure.tables`."""
    lev = struct.levels[level]

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def wts(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    base = dict(cols=idx(lev.cols), diag_slots=idx(lev.diag_slots))
    if level == struct.num_levels - 1:
        return _Tables(**base)
    sums = {name + "_sum": _Sum(t, n, device, padded=name == "restrict")
            for name, (t, n) in _sum_targets(struct, level).items()}
    if not struct.smoothed:
        return _Tables(**base, power_vec=wts(lev.power_vec), agg_dof=idx(lev.agg_dof), **sums)
    return _Tables(**base, power_vec=wts(lev.power_vec), p0_w=wts(lev.p0_w),
                   ps_w=wts(lev.ps_w), p_rows=idx(lev.p_rows), p_cols=idx(lev.p_cols.reshape(-1)),
                   ap_a=idx(lev.ap_contrib[0]), ap_p=idx(lev.ap_contrib[1]),
                   c_p=idx(lev.c_contrib[0]), c_ap=idx(lev.c_contrib[1]), **sums)


def _inverted_table(targets, n_targets: int, device=None) -> torch.Tensor:
    """:func:`invert_scatter` of ``out[targets[i]] += src[i]`` over
    ``n_targets`` targets, the sources whose target is at or past
    ``n_targets`` (the reference's trash slot) dropped: an int64
    (n_targets, m) table of source positions, padded with the number of
    sources."""
    t = np.asarray(targets, dtype=np.int64).reshape(-1)
    keep = np.nonzero(t < n_targets)[0]
    table = invert_scatter(t[keep], n_targets, device=device)
    if table is None:  # no source at all
        return torch.full((n_targets, 1), t.size, dtype=torch.int64, device=device)
    keep = torch.as_tensor(keep, device=device)
    return torch.where(table == keep.numel(), t.size, keep[table.clamp(max=keep.numel() - 1)])


# ---------------------------------------------------------------------------
# host build (numpy, once per mesh)
# ---------------------------------------------------------------------------


def _greedy_aggregate(adj_rows, adj_cols, n_nodes: int):
    """Greedy aggregation: every unaggregated node in turn seeds an
    aggregate of itself and its unaggregated neighbours (plain aggregation;
    one pass covers every node), then :func:`_merge_singletons`.  Input:
    the node adjacency as COO arrays.  The sweep runs in the native host
    runtime where it is built and not switched off, else
    :func:`_greedy_sweep_numpy` (the same aggregation); the merge runs on
    either's output."""
    order = np.argsort(adj_rows, kind="stable")
    rows_s, cols_s = adj_rows[order], adj_cols[order]
    starts = np.searchsorted(rows_s, np.arange(n_nodes + 1))
    res = native.greedy_aggregate_native(rows_s, cols_s, n_nodes)
    agg, na = res if res is not None else _greedy_sweep_numpy(rows_s, cols_s, n_nodes)
    return _merge_singletons(agg, na, cols_s, starts)


def _greedy_sweep_numpy(rows_s, cols_s, n_nodes: int):
    """The sweep as a Python loop over the row-sorted COO adjacency;
    returns (agg, n_aggregates)."""
    native.note("greedy_aggregate", "numpy")
    starts = np.searchsorted(rows_s, np.arange(n_nodes + 1))
    agg = np.full(n_nodes, -1, dtype=np.int64)
    na = 0
    for i in range(n_nodes):
        if agg[i] >= 0:
            continue
        agg[i] = na
        for j in cols_s[starts[i] : starts[i + 1]]:
            if agg[j] < 0:
                agg[j] = na
        na += 1
    return agg, na


def _merge_singletons(agg, na, cols_s, starts):
    """Fold singleton aggregates into a neighbouring aggregate: each joins
    the aggregate of its first differently aggregated neighbour (isolated
    nodes stay); ids are recompressed afterwards."""
    agg = agg.copy()
    n_nodes = agg.shape[0]
    sizes = np.bincount(agg, minlength=na)
    for i in np.nonzero(sizes[agg] == 1)[0]:
        for j in cols_s[starts[i] : starts[i + 1]]:
            if agg[j] != agg[i]:
                sizes[agg[j]] += 1
                sizes[agg[i]] -= 1
                agg[i] = agg[j]
                break
    uniq, agg = np.unique(agg, return_inverse=True)
    return agg.astype(np.int64).reshape(n_nodes), len(uniq)


def _ell_from_coo(rows, cols, n: int):
    """Host ELL layout from COO pairs; returns (cols_arr, K, (keys, slot)
    lookup, diag slots)."""
    keys = rows.astype(np.int64) * n + cols.astype(np.int64)
    uniq = np.unique(keys)
    urows = (uniq // n).astype(np.int64)
    ucols = (uniq % n).astype(np.int64)
    counts = np.bincount(urows, minlength=n)
    K = int(counts.max())
    row_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(uniq.shape[0]) - row_starts[urows]
    uslot = (urows * K + pos).astype(np.int64)
    cols_arr = np.zeros((n, K), dtype=np.int32)
    cols_arr.reshape(-1)[uslot] = ucols
    diag = np.zeros(n, dtype=np.int64)
    dmask = urows == ucols
    diag[urows[dmask]] = uslot[dmask]
    return cols_arr, K, (uniq, uslot), diag


def _ell_rect(rows, cols, nrows: int, ncols: int):
    """Host ELL layout of a rectangular pattern from (possibly repeated)
    COO pairs: (cols_arr (nrows, K), K, (keys, slot) lookup, real), with
    ``real`` the structurally present flat slots."""
    keys = rows.astype(np.int64) * ncols + cols.astype(np.int64)
    uniq = np.unique(keys)
    urows = (uniq // ncols).astype(np.int64)
    ucols = (uniq % ncols).astype(np.int64)
    counts = np.bincount(urows, minlength=nrows)
    K = int(counts.max())
    row_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(uniq.shape[0]) - row_starts[urows]
    uslot = (urows * K + pos).astype(np.int64)
    cols_arr = np.zeros((nrows, K), dtype=np.int32)
    cols_arr.reshape(-1)[uslot] = ucols
    real = np.zeros(nrows * K, dtype=bool)
    real[uslot] = True
    return cols_arr, K, (uniq, uslot), real


def _ragged_enumerate(rep):
    """For groups of sizes ``rep``: the index 0..rep_g-1 of every element
    of the concatenation within its group."""
    csum = np.concatenate([[0], np.cumsum(rep)[:-1]])
    return np.arange(int(rep.sum())) - np.repeat(csum, rep)


def _aggregate_qr(B, agg, bs_l: int, na: int, m: int):
    """Per-aggregate thin QR of the near-kernel rows: P₀ holds, per
    aggregate g, the orthonormal factor Q_g of B[dofs(g)]; the coarse
    kernel rows are R_g, so every level fits the kernel exactly.  Returns
    (w0 (N, m) static P₀ weights, Bc (na·m, m) coarse kernel); a block of
    fewer than m dofs leaves zero columns."""
    N = B.shape[0]
    agg_of_dof = agg[np.arange(N) // bs_l]
    order = np.argsort(agg_of_dof, kind="stable")
    bounds = np.searchsorted(agg_of_dof[order], np.arange(na + 1))
    w0 = np.zeros((N, m))
    Bc = np.zeros((na * m, m))
    for g in range(na):
        d = order[bounds[g] : bounds[g + 1]]
        Q, R = np.linalg.qr(B[d], mode="reduced")
        r = Q.shape[1]
        w0[d, :r] = Q
        Bc[g * m : g * m + r, :] = R
    return w0, Bc


def _sa_maps(rows_d, cols_d, r_idx, agg0, w0, N: int, K: int, Nc: int, m: int):
    """Host index maps of the smoothed-aggregation transfer and triple
    product, all with static sparsity.  P's row i couples to the coarse
    columns agg0[j] + t of its graph neighbours j (t < m), so the patterns
    of P, AP = A·P and A_c = Pᵀ·AP are structural, and each product is a
    gather-multiply and a sum over contributor tables built here.

    Args: the real A entries as COO (rows_d, cols_d) with flat slots r_idx;
    agg0 (N,) the first coarse dof of each fine dof's aggregate; w0 the
    static P₀ weights.  Returns (p_cols, p_rows, p0_slot, a_to_p, ps_w,
    ap_contrib, n_ap, c_contrib, cols_c, Kc, diag_c, real_c)."""
    ar_m = np.arange(m, dtype=np.int64)
    # ---- P pattern
    pr = np.concatenate([np.repeat(rows_d, m), np.repeat(np.arange(N, dtype=np.int64), m)])
    pc = np.concatenate(
        [(agg0[cols_d][:, None] + ar_m).reshape(-1), (agg0[:, None] + ar_m).reshape(-1)]
    )
    p_cols, KP, (pkeys, puslot), p_real = _ell_rect(pr, pc, N, Nc)

    def pslot(r, c):
        return puslot[np.searchsorted(pkeys, r * np.int64(Nc) + c)]

    p0_slot = pslot(
        np.repeat(np.arange(N, dtype=np.int64), m), (agg0[:, None] + ar_m).reshape(-1)
    ).reshape(N, m)
    # smoothing term: A slot (i, j) spreads into the m coarse columns of
    # j's aggregate with the static kernel weights w0[j]
    a_to_p = np.full((N * K, m), N * KP, dtype=np.int64)  # padding -> trash
    a_to_p[r_idx] = pslot(
        np.repeat(rows_d, m), (agg0[cols_d][:, None] + ar_m).reshape(-1)
    ).reshape(-1, m)
    ps_w = np.zeros((N * K, m))
    ps_w[r_idx] = w0[cols_d]
    p_rows = np.repeat(np.arange(N, dtype=np.int64), KP)

    # ---- AP: one contribution per (real A slot (i, j)) × (real P slot
    # (j, q)) pair
    p_rslots = np.nonzero(p_real)[0]
    p_rows_of = p_rslots // KP
    p_row_starts = np.searchsorted(p_rows_of, np.arange(N + 1))
    p_deg = np.diff(p_row_starts)
    rep = p_deg[cols_d]
    contrib_a = np.repeat(r_idx, rep)
    contrib_i = np.repeat(rows_d, rep)
    contrib_p = p_rslots[np.repeat(p_row_starts[cols_d], rep) + _ragged_enumerate(rep)]
    ap_c = p_cols.reshape(-1)[contrib_p].astype(np.int64)
    ap_cols, K_AP, (apkeys, apuslot), ap_real = _ell_rect(contrib_i, ap_c, N, Nc)
    contrib_ap = apuslot[np.searchsorted(apkeys, contrib_i * np.int64(Nc) + ap_c)]
    ap_contrib = (
        contrib_a.astype(np.int64), contrib_p.astype(np.int64), contrib_ap.astype(np.int64),
    )

    # ---- A_c = Pᵀ·AP: one contribution per fine row i per (real P slot
    # (i, I)) × (real AP slot (i, c)) pair
    ap_rslots = np.nonzero(ap_real)[0]
    ap_rows_of = ap_rslots // K_AP
    ap_row_starts = np.searchsorted(ap_rows_of, np.arange(N + 1))
    ap_deg = np.diff(ap_row_starts)
    rep2 = ap_deg[p_rows_of]
    c_p = np.repeat(p_rslots, rep2)
    c_ap = ap_rslots[np.repeat(ap_row_starts[p_rows_of], rep2) + _ragged_enumerate(rep2)]
    cI = p_cols.reshape(-1)[c_p].astype(np.int64)
    cc = ap_cols.reshape(-1)[c_ap].astype(np.int64)
    cols_c, Kc, (ckeys, cuslot), real_c = _ell_rect(cI, cc, Nc, Nc)
    c_out = cuslot[np.searchsorted(ckeys, cI * np.int64(Nc) + cc)]
    c_contrib = (c_p.astype(np.int64), c_ap.astype(np.int64), c_out.astype(np.int64))
    # coarse diagonal slots: every aggregate I has a member row i with P
    # slot (i, I) and AP slot (i, I)
    dkeys = np.arange(Nc, dtype=np.int64) * Nc + np.arange(Nc)
    dpos = np.searchsorted(ckeys, dkeys)
    assert np.array_equal(ckeys[dpos], dkeys), "coarse diagonal missing"
    diag_c = cuslot[dpos]
    return (
        p_cols, p_rows, p0_slot, a_to_p, ps_w, ap_contrib, N * K_AP,
        c_contrib, cols_c, Kc, diag_c, real_c,
    )


def build_amg_structure(
    pattern,
    bs: int,
    bottom_max: Optional[int] = None,
    smoothed: bool = True,
    near_kernel: Optional[np.ndarray] = None,
) -> Optional[AMGStructure]:
    """Static hierarchy from an ELLPattern (host, once per mesh).

    ``smoothed=True`` (the default) builds the smoothed-aggregation maps;
    ``smoothed=False`` the piecewise-constant hierarchy.  ``near_kernel``
    is an (N, m) basis of the operator's near-null space for the tentative
    prolongation (smoothed hierarchies only), by default the m = bs
    per-component constants; for elasticity pass the rigid-body modes
    (PETSc GAMG's ``MatSetNearNullSpace``).  ``bottom_max`` defaults to
    ``_BOTTOM_MAX``.

    Returns None when the system is at or below the bottom size or the
    graph does not coarsen.
    """
    t_start = time.perf_counter()
    timings = {"sweep": 0.0, "qr": 0.0, "sa_maps": 0.0}
    if bottom_max is None:
        bottom_max = _BOTTOM_MAX
    rng = np.random.default_rng(11)

    N = pattern.num_dofs
    K = pattern.row_width
    cols = np.asarray(pattern.cols, dtype=np.int64)
    real = np.zeros(N * K, dtype=bool)
    real[np.asarray(pattern.slots).reshape(-1)] = True
    diag_slots = np.asarray(pattern.diag_slots, dtype=np.int64)
    if N <= bottom_max:
        return None

    if smoothed:
        if near_kernel is None:
            B = np.zeros((N, bs))
            B[np.arange(N), np.arange(N) % bs] = 1.0
        else:
            B = np.asarray(near_kernel, dtype=np.float64)
            assert B.shape[0] == N, "near_kernel rows must match dofs"
    m = B.shape[1] if smoothed else bs
    bs_l = bs  # node block size of the current level (m below the top)

    levels = []
    while N > bottom_max:
        n_nodes = N // bs_l
        slot_rows = np.repeat(np.arange(N, dtype=np.int64), K)
        r_idx = np.nonzero(real)[0]
        rows_d = slot_rows[r_idx]
        cols_d = cols.reshape(-1)[r_idx]
        # node graph (block rows): vertex coupling is full per node pair
        rows_n = rows_d // bs_l
        cols_n = cols_d // bs_l
        t0 = time.perf_counter()
        agg, na = _greedy_aggregate(rows_n, cols_n, n_nodes)
        timings["sweep"] += time.perf_counter() - t0
        if na * m * _MIN_COARSEN > N:
            break  # the graph refuses to coarsen
        Nc = na * m
        if smoothed:
            t0 = time.perf_counter()
            w0, Bc = _aggregate_qr(B, agg, bs_l, na, m)
            t1 = time.perf_counter()
            agg0 = agg[np.arange(N, dtype=np.int64) // bs_l] * m
            (
                p_cols, p_rows, p0_slot, a_to_p, ps_w, ap_contrib, n_ap,
                c_contrib, cols_c, Kc, diag_c, real_c,
            ) = _sa_maps(rows_d, cols_d, r_idx, agg0, w0, N, K, Nc, m)
            timings["qr"] += t1 - t0
            timings["sa_maps"] += time.perf_counter() - t1
            levels.append(
                _ALevel(
                    N, cols.astype(np.int32), diag_slots, slot_rows, real,
                    None, None, rng.standard_normal(N),
                    p_cols=p_cols, p_rows=p_rows, p0_slot=p0_slot,
                    p0_w=w0, a_to_p=a_to_p, ps_w=ps_w,
                    ap_contrib=ap_contrib, n_ap=n_ap, c_contrib=c_contrib,
                )
            )
            B = Bc
        else:
            # coarse dof of each fine dof: the same component in the aggregate
            comp = np.arange(N, dtype=np.int64) % bs_l
            agg_dof = agg[np.arange(N, dtype=np.int64) // bs_l] * bs_l + comp
            crows = agg_dof[rows_d]
            ccols = agg_dof[cols_d]
            cols_c, Kc, (ukeys, uslot), diag_c = _ell_from_coo(crows, ccols, Nc)
            # flat fine slot -> flat coarse slot; padding slots go to a
            # trash entry one past the end
            keys = crows * Nc + ccols
            slot_map = np.full(N * K, Nc * Kc, dtype=np.int64)
            slot_map[r_idx] = uslot[np.searchsorted(ukeys, keys)]
            levels.append(
                _ALevel(
                    N, cols.astype(np.int32), diag_slots, slot_rows, real,
                    agg_dof, slot_map, rng.standard_normal(N),
                )
            )
            real_c = np.zeros(Nc * Kc, dtype=bool)
            real_c[uslot] = True
        N, K, cols, real, diag_slots = Nc, Kc, cols_c.astype(np.int64), real_c, diag_c
        bs_l = m
    if not levels:
        return None
    levels.append(
        _ALevel(
            N, cols.astype(np.int32), diag_slots,
            np.repeat(np.arange(N, dtype=np.int64), K), real,
        )
    )
    timings["total"] = time.perf_counter() - t_start
    return AMGStructure(bs, tuple(levels), smoothed=smoothed, timings=timings)


# ---------------------------------------------------------------------------
# device setup and cycle
# ---------------------------------------------------------------------------


def _fixed_order(device) -> bool:
    """Whether the scatter-adds on ``device`` run as fixed-order gathers
    (CUDA) rather than ``index_add_``."""
    return torch.device(device).type == "cuda"


def _pseudo_inverse(dense: torch.Tensor) -> torch.Tensor:
    """The bottom operator's pseudo-inverse, from a float64 eigen-
    decomposition, where its Cholesky factorization failed.

    A smoothed-aggregation coarse operator A_c = PᵀAP is only semidefinite
    when P's columns are dependent: a tentative block QR'd over a whole
    aggregate loses rank once the Dirichlet rows are zeroed (elasticity's
    rigid modes on an aggregate with one or two free nodes).  Then
    null(A_c) = null(P), so P A_c⁺ Pᵀ is the exact coarse correction.
    Eigenvalues up to 100·eps·λmax are taken as that null space; an
    eigenvalue below −sqrt(eps)·λmax is an indefinite operator, which
    raises."""
    eps = torch.finfo(dense.dtype).eps
    w, V = torch.linalg.eigh(dense.double())
    top = w.max()
    if not bool(torch.isfinite(w).all()) or bool(w.min() < -(eps ** 0.5) * top):
        raise ValueError(
            f"AMG bottom operator is not semidefinite: eigenvalues {float(w.min()):.3e} "
            f"to {float(top):.3e}")
    keep = w > 100 * eps * top
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)), torch.zeros_like(w))
    return ((V * winv) @ V.T).to(dense.dtype)


def amg_setup(struct: AMGStructure, vals: torch.Tensor):
    """Per-operator setup: every level's Galerkin values, the Jacobi
    smoother with its λmax estimate (16 power iterations, 30% headroom,
    capped by Gershgorin), on smoothed hierarchies P's values, and the
    bottom inverse.  ``vals``: (N·K,) BC-applied ELL values of the fine
    operator.  Returns the per-level list that :func:`amg_vcycle` reads."""
    state = []
    v = vals.reshape(-1)
    dev, dtype = v.device, v.dtype
    tabs = [struct.tables(li, dev, dtype) for li in range(struct.num_levels)]
    for li, lev in enumerate(struct.levels):
        N = lev.n_dofs
        K = lev.cols.shape[1]
        tab = tabs[li]
        cols = tab.cols
        diag = v[tab.diag_slots]
        rowsum = v.abs().reshape(N, K).sum(dim=1)
        zmask = (rowsum - diag.abs() > 0).to(dtype)
        if li == struct.num_levels - 1:
            dense = ell_to_dense(v, cols)
            dense = 0.5 * (dense + dense.T)
            L, info = torch.linalg.cholesky_ex(dense)
            pinv = bool(info.item())  # the setup's one host read
            if pinv:
                binv = _pseudo_inverse(dense)
            else:
                binv = torch.cholesky_solve(torch.eye(N, dtype=dtype, device=dev), L)
            state.append({"zmask": zmask, "binv": binv, "bottom_pinv": pinv})
            break
        one = torch.ones((), dtype=dtype, device=dev)
        dinv = torch.where(diag.abs() > 0, one / diag, one)
        papply = lambda r, dinv=dinv: dinv * r  # noqa: E731
        matvec = lambda x, v=v, cols=cols: spmv(v, cols, x)  # noqa: E731
        gersh = (dinv * rowsum).max()
        w = tab.power_vec / torch.linalg.vector_norm(tab.power_vec)
        for _ in range(16):
            u = papply(matvec(w))
            w = u / (torch.linalg.vector_norm(u) + 1e-30)
        Aw = matvec(w)
        lam = torch.dot(Aw, papply(Aw)) / (torch.dot(w, Aw) + 1e-30)
        lmax = torch.minimum(gersh, 1.3 * lam)
        entry = {"vals": v, "cols": cols, "zmask": zmask, "papply": papply, "lmax": lmax,
                 "tables": tab}
        if struct.smoothed:
            # P = (I − ω D⁻¹A) P₀, ω = 4/(3 λmax): P₀'s static weights on
            # interior rows, then the smoothing term spread over j's
            # aggregate columns with weights w0[j]; BC rows zeroed
            omega = (4.0 / 3.0) / lmax
            sm = -omega * (dinv * zmask)[:, None] * v.reshape(N, K)  # (N, K)
            src = torch.cat([(tab.p0_w * zmask[:, None]).reshape(-1),
                             (tab.ps_w * sm.reshape(-1, 1)).reshape(-1)])
            Pv = tab.p_sum(src)
            APv = tab.ap_sum(v[tab.ap_a] * Pv[tab.ap_p])
            vc = tab.c_sum(Pv[tab.c_p] * APv[tab.c_ap])
            entry["Pv"] = Pv
        else:
            # A_c[I, J] = Σ A[i, j] over the aggregate pair, BC rows and
            # columns masked out
            zc = zmask[cols.reshape(-1)]
            src = v * (zmask[:, None] * zc.reshape(N, K)).reshape(-1)
            vc = tab.galerkin_sum(src)
        state.append(entry)
        # identity diagonal where an aggregate carried no interior mass
        # (the diagonal slots are distinct: an in-order add on any device)
        dslots = tabs[li + 1].diag_slots
        fix = (vc[dslots].abs() == 0).to(dtype)
        v = vc.index_add(0, dslots, fix)
    return state


def amg_vcycle(struct: AMGStructure, state, r: torch.Tensor) -> torch.Tensor:
    """One V(ν,ν) aggregation-AMG cycle applied to ``r``: SPD (variational
    hierarchy, symmetric Chebyshev smoothing), so it preconditions CG."""
    return _acycle(struct, state, r, 0)


def _acycle(struct, state, b, li):
    st = state[li]
    if li == struct.num_levels - 1:
        return st["binv"] @ b
    tab = st["tables"]
    matvec = lambda x: spmv(st["vals"], st["cols"], x)  # noqa: E731
    x = _cheby(matvec, st["papply"], b, st["lmax"], _CHEB_DEGREE)
    r = b - matvec(x)
    if struct.smoothed:
        # rc = Pᵀ r and e = P e_c over the static P pattern (P's BC rows
        # are zero by construction)
        Pv = st["Pv"]
        rc = tab.restrict_sum(Pv * r[tab.p_rows])
        ec = _acycle(struct, state, rc, li + 1)
        x = x + (Pv * ec[tab.p_cols]).reshape(b.shape[0], -1).sum(dim=1)
    else:
        rc = tab.restrict_sum(r * st["zmask"])
        zc = state[li + 1]["zmask"]
        ec = _acycle(struct, state, rc * zc, li + 1)
        x = x + _OVERCORRECT * (ec * zc)[tab.agg_dof] * st["zmask"]
    return _cheby_from(matvec, st["papply"], b, x, st["lmax"], _CHEB_DEGREE)
