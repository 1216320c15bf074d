"""The DOLFINx-style function surface of the port — ``functionspace``,
``Function.values``, ``interpolate`` (vmapped, and the per-point loop a
callable that vmap cannot trace takes), ``eval`` (P1 and P2, with and
without ``cells``), ``copy``, ``scatter_forward`` — and ``integrate`` and
``assemble_p1_stiffness_local``, each against the JAX package in this
process at 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.ops import assembly as jasm
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

TOL = 1e-12


def _quad(lib):
    return lambda x: 1 + x[0] ** 2 + 2 * x[0] * x[1]


def _vec(lib):
    if lib is torch:
        return lambda x: torch.stack([x[0] ** 2, x[0] * x[1]])
    return lambda x: jnp.array([x[0] ** 2, x[0] * x[1]])


def _pair(jm, element):
    return hx.functionspace(jm, element), ht.functionspace(port_mesh(jm), element)


@pytest.mark.parametrize("element", [("Lagrange", 1), ("P", 2), ("CG", 2, (2,)),
                                     ("Lagrange", 1, (2,))])
def test_functionspace_matches_reference(element):
    """``functionspace(mesh, element)`` gives the reference's space: degree,
    block size, dofmap and dof coordinates; other families raise."""
    Vj, Vt = _pair(hx.create_unit_square(3), element)
    assert (Vt.degree, Vt.bs, Vt.num_dofs, Vt.dofs_per_cell) == (
        Vj.degree, Vj.bs, Vj.num_dofs, Vj.dofs_per_cell)
    np.testing.assert_array_equal(Vt.cell_dofs_unrolled(), Vj.cell_dofs_unrolled())
    np.testing.assert_array_equal(Vt.tabulate_dof_coordinates(), Vj.tabulate_dof_coordinates())
    assert Vt == ht.FunctionSpace(Vt.mesh, Vt.bs, Vt.degree) and "P%d" % Vt.degree in repr(Vt)
    with pytest.raises(NotImplementedError):
        ht.functionspace(Vt.mesh, ("DG", 1))
    with pytest.raises(NotImplementedError):
        ht.functionspace(Vt.mesh, ("Lagrange", 3))


@pytest.mark.parametrize("degree,bs", [(1, 1), (2, 1), (2, 2)])
def test_interpolate_vmapped_and_values(degree, bs):
    """``interpolate`` of a torch callable (vmapped) equals the reference's
    jax.vmap interpolation; ``values()`` is the (num_nodes, bs) view; the
    Function keeps its dtype and device."""
    elem = ("Lagrange", degree) if bs == 1 else ("Lagrange", degree, (bs,))
    Vj, Vt = _pair(hx.create_unit_square(4), elem)
    fn = _quad if bs == 1 else _vec
    gj = hx.Function(Vj).interpolate(fn(jnp))
    gt = ht.Function(Vt, device="cpu").interpolate(fn(torch))
    assert gt.array.dtype == torch.float64 and gt.array.device.type == "cpu"
    assert np.abs(gt.array.numpy() - np.asarray(gj.array)).max() < TOL
    assert gt.values().shape == (Vt.num_nodes, bs)
    np.testing.assert_array_equal(gt.values().numpy(), np.asarray(gj.values()))
    g32 = ht.Function(Vt, device="cpu", dtype=torch.float32).interpolate(fn(torch))
    assert g32.array.dtype == torch.float32
    assert np.abs(g32.array.double().numpy() - np.asarray(gj.array)).max() < 1e-6


def test_interpolate_loop_fallback():
    """A callable that vmap cannot trace (``float`` of a coordinate) is
    evaluated point by point, as the reference falls back to numpy: the
    same values."""
    def step(x):
        return 1.0 + (float(x[0]) ** 2 if float(x[0]) > 0.5 else 0.0) + float(x[1])

    Vj, Vt = _pair(hx.create_unit_square(4), ("Lagrange", 2))
    gj = hx.Function(Vj).interpolate(step)
    gt = ht.Function(Vt, device="cpu").interpolate(step)
    assert np.abs(gt.array.numpy() - np.asarray(gj.array)).max() < TOL
    xy = Vt.tabulate_dof_coordinates()
    expect = 1.0 + np.where(xy[:, 0] > 0.5, xy[:, 0] ** 2, 0.0) + xy[:, 1]
    assert np.abs(gt.array.numpy() - expect).max() < TOL


@pytest.mark.parametrize("degree,bs", [(1, 1), (2, 1), (2, 2)])
def test_eval_with_and_without_cells(degree, bs):
    """``Function.eval`` at random points (cells located), and with given
    cells (each point takes its cell's polynomial, outside it too), equals
    the reference's ``eval`` / ``eval_p1``."""
    from hommx_tpu.ops.interpolation import eval_p1 as jax_eval

    elem = ("Lagrange", degree) if bs == 1 else ("Lagrange", degree, (bs,))
    Vj, Vt = _pair(hx.create_unit_square(5), elem)
    fn = _quad if bs == 1 else _vec
    gj = hx.Function(Vj).interpolate(fn(jnp))
    gt = ht.Function(Vt, device="cpu").interpolate(fn(torch))
    rng = np.random.default_rng(4)
    pts = rng.uniform(0.0, 1.0, (30, 2))
    assert np.abs(gt.eval(pts).numpy() - np.asarray(gj.eval(pts))).max() < TOL
    cells = rng.integers(0, Vt.mesh.num_cells, 30)
    ref = np.asarray(jax_eval(gj, pts, cells))
    assert np.abs(gt.eval(pts, cells).numpy() - ref).max() < TOL


def test_copy_and_scatter_forward():
    """``copy`` is a Function on the same space with its own dof vector;
    ``scatter_forward`` returns the Function itself (a single program has
    no ghosts)."""
    V = ht.functionspace(ht.create_unit_square(3), ("Lagrange", 2))
    g = ht.Function(V, device="cpu").interpolate(_quad(torch))
    c = g.copy()
    assert c.space is V and torch.equal(c.array, g.array)
    c.array[0] = 123.0
    assert float(g.array[0]) != 123.0
    assert g.scatter_forward() is g and g.x is g and g.function_space is V
    assert np.abs(g.x.array.numpy() - hx.Function(
        hx.functionspace(hx.create_unit_square(3), ("Lagrange", 2))).interpolate(
            _quad(jnp)).array).max() < TOL


@pytest.mark.parametrize("dim", [2, 3])
def test_integrate_and_local_stiffness(dim):
    """``integrate`` and ``assemble_p1_stiffness_local`` equal the
    reference's on the same mesh."""
    from hommx_tpu_torch.ops.assembly import assemble_p1_stiffness_local, integrate

    jm = hx.create_unit_square(4) if dim == 2 else hx.create_unit_cube(2)
    tv = torch.as_tensor(jm.vertices, dtype=torch.float64)
    tc = torch.as_tensor(jm.cells)
    jv, jc = jnp.asarray(jm.vertices), jnp.asarray(jm.cells)
    tfn = lambda x: torch.sin(torch.pi * x[0]) * (1 + x[dim - 1]) ** 2  # noqa: E731
    jfn = lambda x: jnp.sin(jnp.pi * x[0]) * (1 + x[dim - 1]) ** 2  # noqa: E731
    got = float(integrate(tv, tc, tfn, degree=4))
    ref = float(jasm.integrate(jv, jc, jfn, degree=4))
    assert abs(got - ref) < TOL * abs(ref)
    rng = np.random.default_rng(2)
    M = rng.standard_normal((jm.num_cells, dim, dim))
    A = M @ M.transpose(0, 2, 1) + np.eye(dim)
    S = assemble_p1_stiffness_local(tv, tc, torch.as_tensor(A)).numpy()
    S_ref = np.asarray(jasm.assemble_p1_stiffness_local(jv, jc, jnp.asarray(A)))
    assert np.abs(S - S_ref).max() < TOL * np.abs(S_ref).max()
