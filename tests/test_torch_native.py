"""The port's native C++ host runtime (``hommx_tpu_torch/native``) on the CPU,
mirroring tests/test_native.py: the library builds, and on every setup hot
path the port's native route, its numpy route and the JAX package's own
output are equal exactly (the ELL pattern, the periodic map, the greedy
aggregation, the cell location); an unmatched periodic point set raises on
both routes; a MacroSystem and an AMG hierarchy built with the native
route equal those built with ``HOMMX_TPU_NO_NATIVE=1``."""

import dataclasses

import numpy as np
import pytest

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro import periodic as jperiodic
from hommx_tpu.ops import amg as jamg
from hommx_tpu.ops import interpolation as jinterp
from hommx_tpu.ops import sparse as jsparse
from hommx_tpu_torch import native
from hommx_tpu_torch.micro import periodic as tperiodic
from hommx_tpu_torch.models.common import MacroSystem
from hommx_tpu_torch.ops import amg as tamg
from hommx_tpu_torch.ops import interpolation as tinterp
from hommx_tpu_torch.ops import sparse as tsparse
from hommx_tpu_torch.ops.p2 import build_edges, p2_cell_dofs, p2_dof_coordinates


def _delaunay(n_random: int, seed: int) -> ht.SimplexMesh:
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.array([[0, 0], [1, 0], [0, 1], [1, 1.0]]),
                          rng.uniform(0, 1, (n_random, 2))])
    return ht.mesh_from_delaunay(pts, Delaunay(pts).simplices)


def _p2(mesh):
    edges, cell_edges = build_edges(mesh.cells, mesh.num_vertices)
    return (p2_cell_dofs(mesh.cells, cell_edges, mesh.num_vertices),
            p2_dof_coordinates(mesh.vertices, edges))


def test_native_builds():
    """g++ is present, so the library builds under hommx_tpu_torch/_build/,
    named by its source's hash, and loads."""
    assert native.available
    assert native.build_error is None
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "hommx_tpu_torch"


def test_switch_off_and_counts(monkeypatch):
    """HOMMX_TPU_NO_NATIVE=1 (read at every call) sends a dispatcher to its
    numpy route, and ``calls`` counts each route."""
    mesh = ht.create_unit_square(3)
    native.reset_calls()
    tsparse.build_ell_pattern(mesh.cells, mesh.num_vertices)
    assert native.calls["ell_pattern"] == {"native": 1, "numpy": 0}
    monkeypatch.setenv("HOMMX_TPU_NO_NATIVE", "1")
    assert not native.available
    assert native.build_ell_pattern_native(mesh.cells, mesh.num_vertices) is None
    tsparse.build_ell_pattern(mesh.cells, mesh.num_vertices)
    assert native.calls["ell_pattern"] == {"native": 1, "numpy": 1}
    native.reset_calls()
    assert all(c == {"native": 0, "numpy": 0} for c in native.calls.values())


ELL_CASES = {
    "2d9": lambda: (ht.create_unit_square(9).cells, ht.create_unit_square(9).num_vertices),
    "3d4": lambda: (ht.create_unit_cube(4).cells, ht.create_unit_cube(4).num_vertices),
    "p2_2d5": lambda: (lambda m, d: (d[0], d[1].shape[0]))(
        ht.create_unit_square(5), _p2(ht.create_unit_square(5))),
}


@pytest.mark.parametrize("case", list(ELL_CASES))
def test_ell_pattern_routes_equal(case):
    cell_dofs, num_dofs = ELL_CASES[case]()
    native.reset_calls()
    nat = tsparse.build_ell_pattern(cell_dofs, num_dofs)
    assert native.calls["ell_pattern"] == {"native": 1, "numpy": 0}
    ref = jsparse.build_ell_pattern(cell_dofs, num_dofs)
    for pat in (tsparse.build_ell_pattern_numpy(cell_dofs, num_dofs), ref):
        assert pat.num_dofs == nat.num_dofs and pat.row_width == nat.row_width
        for name in ("cols", "slots", "diag_slots"):
            a, b = getattr(nat, name), np.asarray(getattr(pat, name))
            assert a.dtype == b.dtype == np.int32, name
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(nat.cols.reshape(-1)[nat.diag_slots], np.arange(num_dofs))


PERIODIC_CASES = {
    "2d7": lambda: ht.create_unit_square(7).vertices,
    "cube6": lambda: ht.create_unit_cube(6).vertices,
    "p2_2d4": lambda: _p2(ht.create_unit_square(4))[1],
    "p2_3d2": lambda: _p2(ht.create_unit_cube(2))[1],
}


@pytest.mark.parametrize("case", list(PERIODIC_CASES))
def test_periodic_map_routes_equal(case):
    points = PERIODIC_CASES[case]()
    native.reset_calls()
    nat = tperiodic.build_periodic_map_points(points)
    assert native.calls["periodic_match"] == {"native": 1, "numpy": 0}
    assert nat.is_slave.any()
    for pm in (tperiodic.build_periodic_map_points_numpy(points),
               jperiodic.build_periodic_map_points(points)):
        assert pm.n_reduced == nat.n_reduced
        for name in ("masters", "is_slave", "reduced_index"):
            a, b = getattr(nat, name), np.asarray(getattr(pm, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_periodic_unmatched_raises(route):
    """A point on a hi face whose lo-face image is missing raises
    ValueError on both routes (as the reference does)."""
    points = np.array([[0, 0], [1, 0], [0, 1], [1, 1], [0.5, 0], [0.5, 1], [1, 0.5]], float)
    fn = {"native": tperiodic.build_periodic_map_points,
          "numpy": tperiodic.build_periodic_map_points_numpy}[route]
    with pytest.raises(ValueError, match="periodic"):
        fn(points)
    with pytest.raises(ValueError, match="periodic"):
        jperiodic.build_periodic_map_points(points)


def _adjacency(mesh):
    rows = np.repeat(mesh.cells, 3, axis=1).reshape(-1).astype(np.int64)
    cols = np.tile(mesh.cells, (1, 3)).reshape(-1).astype(np.int64)
    return rows, cols


def test_greedy_aggregate_routes_equal(monkeypatch):
    """The sweep (native against the Python loop) and the whole
    aggregation with its singleton merge (native route, numpy route, the
    reference) on a 200-point Delaunay mesh."""
    mesh = _delaunay(200, seed=9)
    n = mesh.num_vertices
    rows, cols = _adjacency(mesh)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s = rows[order], cols[order]
    sweep_n = native.greedy_aggregate_native(rows_s, cols_s, n)
    sweep_p = tamg._greedy_sweep_numpy(rows_s, cols_s, n)
    assert sweep_n[1] == sweep_p[1] > 1
    np.testing.assert_array_equal(sweep_n[0], sweep_p[0])

    ref = jamg._greedy_aggregate(rows, cols, n)
    native.reset_calls()
    nat = tamg._greedy_aggregate(rows, cols, n)
    monkeypatch.setenv("HOMMX_TPU_NO_NATIVE", "1")
    nump = tamg._greedy_aggregate(rows, cols, n)
    assert native.calls["greedy_aggregate"] == {"native": 1, "numpy": 1}
    for other in (nump, ref):
        assert other[1] == nat[1] < sweep_n[1]  # the merge took singletons
        assert np.asarray(other[0]).dtype == nat[0].dtype
        np.testing.assert_array_equal(nat[0], np.asarray(other[0]))


def test_locate_cells_routes_equal():
    """Seeded interior points lie inside exactly one cell, so the native
    and numpy binnings (which differ) and the reference find the same cell,
    and it contains the point; a 1D mesh is left to the numpy route."""
    mesh = _delaunay(60, seed=7)
    q = np.random.default_rng(11).uniform(0.05, 0.95, (40, 2))
    native.reset_calls()
    nat = tinterp._locate_binned(mesh, q)
    assert native.calls["locate_cells"] == {"native": 1, "numpy": 0}
    nump = tinterp._locate_binned_numpy(mesh, q)
    ref = jinterp._locate_binned(hx.mesh_from_delaunay(mesh.vertices, mesh.cells), q)
    assert nat.dtype == nump.dtype == np.int32
    np.testing.assert_array_equal(nat, nump)
    np.testing.assert_array_equal(nat, np.asarray(ref))
    for p, c in zip(q, nat):
        assert tinterp._barycentric(mesh.vertices[mesh.cells[c]], p).min() > -1e-8
    # the native locator bins 2D and 3D meshes only: a 1D mesh takes numpy
    line = np.linspace(0.0, 1.0, 5)[:, None]
    segs = np.stack([np.arange(4), np.arange(1, 5)], axis=1)
    assert native.locate_cells_native(line, segs, np.array([[0.3], [0.9]])) is None


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, tuple):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


def test_macro_system_and_amg_native_equal_numpy(monkeypatch):
    """A MacroSystem (its ELL pattern and DIA view) on the 8² square and on
    a Delaunay mesh, and the Delaunay system's smoothed AMG hierarchy, built
    with the native routes and again with HOMMX_TPU_NO_NATIVE=1."""
    import torch

    meshes = [ht.create_unit_square(8), _delaunay(400, seed=3)]

    def build():
        systems = [MacroSystem(ht.FunctionSpace(m, 1), torch.float64, "cpu") for m in meshes]
        amg = tamg.build_amg_structure(systems[1].pattern, 1, bottom_max=60)
        return systems, amg

    native.reset_calls()
    sys_n, amg_n = build()
    assert native.calls["ell_pattern"] == {"native": 2, "numpy": 0}
    assert native.calls["greedy_aggregate"]["native"] >= 2
    assert native.calls["greedy_aggregate"]["numpy"] == 0
    monkeypatch.setenv("HOMMX_TPU_NO_NATIVE", "1")
    sys_p, amg_p = build()
    assert native.calls["ell_pattern"]["numpy"] == 2
    assert native.calls["greedy_aggregate"]["numpy"] == native.calls["greedy_aggregate"]["native"]
    for a, b in zip(sys_n, sys_p):
        _fields_equal(a.pattern, b.pattern)
        assert (a.dia is None) == (b.dia is None)
        if a.dia is not None:
            np.testing.assert_array_equal(a.dia.offsets, b.dia.offsets)
    assert amg_n.num_levels == amg_p.num_levels >= 3
    for la, lb in zip(amg_n.levels, amg_p.levels):
        _fields_equal(la, lb)
