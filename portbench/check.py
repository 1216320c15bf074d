"""The check that decides ``correct``: what the timed path produced, against
the plain reference (``portbench/reference/<family>.py``), on a sample drawn
from the seed.

For each sampled solve j (θ_j), of the solves whose output a run still holds:

- ``astar_gap``: the micro stage.  A* of sampled macro cells, at least
  ``check.cells`` of them and at least one from each chunk of cells that
  the program's micro stage took in one launch (the cells split into
  ``chunks`` equal runs of consecutive cells, as the engine splits them),
  worked out again by the reference in float64 from the meshes, the
  coefficient and θ_j; the largest over the cells of
  max|A*_program − A*_reference| / max|A*_reference|.
- ``u_gap``: the macro stage.  The reference assembles and solves the macro
  problem in float64 from the program's A* of every cell of solve j (the
  micro stage of 32,768 cells cannot be worked out again within a run;
  ``astar_gap`` checks that stage on its own, so a wrong A* in a cell that
  is not sampled moves the program's u and the reference's alike);
  max|u_program − u_reference| / max|u_reference|.

Each number's limit is the configuration's ``check.limits``.  With
``control`` the reference in TF32 takes the program's place
(``portbench/control.py``).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["check", "sample", "gaps"]


def sample(cfg: dict, seed: int, held: list, n_cells: int, chunks: int = 1):
    """(solves, cells a solve) drawn from the seed: ``check.solves`` of the
    ``held`` solve indices, and for each the same number of distinct macro
    cells of ``n_cells`` from each of ``chunks`` equal runs of consecutive
    cells (the last may be shorter), ⌈check.cells / chunks⌉ a run."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0xC4EC])
    ch = cfg["check"]
    solves = sorted(rng.choice(held, size=min(ch["solves"], len(held)), replace=False).tolist())
    size = -(-n_cells // max(1, min(chunks, n_cells)))
    per = -(-int(ch["cells"]) // max(1, chunks))
    cells = []
    for _ in solves:
        picks = [lo + rng.choice(min(size, n_cells - lo), size=min(per, n_cells - lo, size),
                                 replace=False) for lo in range(0, n_cells, size)]
        cells.append(np.sort(np.concatenate(picks)))
    return solves, cells


def _rel(a, b) -> float:
    """max|a − b| / max|b| over each leading row, the largest row."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    v = ((a - b).abs().amax(dim=1) / b.abs().amax(dim=1)).max()
    return float(v)


def gaps(ref, cfg, theta: float, cells, A_prog, u_prog, prec_test):
    """(astar_gap, u_gap) of one solve: the tested A* of ``cells`` (the
    program's ``A_prog[cells]``, or the reference's in ``prec_test``) and the
    tested u (the program's ``u_prog``, or the reference's macro solve of
    ``A_prog`` in ``prec_test``), each against the float64 reference."""
    import torch

    from portbench.reference.fem import Precision

    f64 = Precision("float64")
    block = int(cfg["check"]["block"])
    idx = torch.as_tensor(cells, device=ref.centers.device)
    worst = 0.0
    for i in range(0, len(cells), block):
        part = idx[i:i + block]
        A_ref = ref.astar(part, theta, f64)
        if prec_test is None:
            A_t = A_prog[part].to(A_ref.device)
        else:
            A_t = ref.astar(part, theta, prec_test)
        g = _rel(A_t, A_ref)
        worst = g if math.isnan(g) else max(worst, g)
        del A_ref, A_t
    A_all = A_prog.to(ref.centers.device)
    u_ref = ref.solve(A_all, f64)
    u_t = u_prog.to(u_ref.device) if prec_test is None else ref.solve(A_all, prec_test)
    return worst, _rel(u_t[None], u_ref[None])


def check(cfg: dict, seed: int, held: list, thetas, outputs, device, control=None,
          program_mesh=None, chunks: int = 1) -> dict:
    """{name: {"value", "limit"}} of the numbers compared.  ``outputs(j)``
    gives solve j's (u, A*) as the program produced them; ``thetas[j]`` its
    θ; ``program_mesh`` the program's macro (vertices, cells), which must
    be the reference's for u to be compared dof by dof; ``chunks`` the
    launches a solve of the family's chunk kernel, each of whose chunks the
    sample draws from.  ``control`` ('tf32') puts the reference in that
    precision in the program's place."""
    import importlib

    import torch

    from portbench.reference.fem import Precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_mod = importlib.import_module(f"portbench.reference.{cfg['family']}")
    ref = ref_mod.Model(cfg, device)
    n_cells = int(ref.centers.shape[0])
    solves, cells = sample(cfg, seed, held, n_cells, chunks)
    prec = None if control is None else Precision(control)
    a_gap, u_gap = 0.0, 0.0
    for j, cs in zip(solves, cells):
        u, A = outputs(j)
        ga, gu = gaps(ref, cfg, float(thetas[j]), cs, A, u, prec)
        a_gap = ga if math.isnan(ga) or math.isnan(a_gap) else max(a_gap, ga)
        u_gap = gu if math.isnan(gu) or math.isnan(u_gap) else max(u_gap, gu)
    limits = cfg["check"]["limits"]

    def entry(v, name):
        return {"value": v if math.isfinite(v) else None, "limit": limits[name]}

    out = {"astar_gap": entry(a_gap, "astar_gap"), "u_gap": entry(u_gap, "u_gap")}
    if program_mesh is not None:
        same = (np.array_equal(program_mesh[0], ref.verts)
                and np.array_equal(np.asarray(program_mesh[1], dtype=np.int64), ref.cells))
        out["mesh_mismatch"] = {"value": int(not same), "limit": 0}
    return out
