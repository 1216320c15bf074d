"""``hommx_tpu_torch.helpers``, the interval mesh, the rescale helpers and
the package's exports against the JAX package, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu import helpers as jhelpers
from hommx_tpu_torch import helpers

torch.set_num_threads(1)


@pytest.mark.parametrize("which", ["1d", "2d"])
def test_solve_diffusion_matches_reference(which):
    """solve_diffusion_1d/2d with an oscillating coefficient: the
    reference's arrays (the 2D one in its lexsorted grid order) to 1e-12."""
    eps = 1 / 8
    jA = lambda x: 2.0 + jnp.sin(2 * jnp.pi * x[0] / eps)
    tA = lambda x: 2.0 + torch.sin(2 * torch.pi * x[0] / eps)
    if which == "1d":
        ref = jhelpers.solve_diffusion_1d(eps, 32, jA)
        got = helpers.solve_diffusion_1d(eps, 32, tA, device="cpu")
        assert got.shape == (33,)
    else:
        ref = jhelpers.solve_diffusion_2d(eps, 12, jA)
        got = helpers.solve_diffusion_2d(eps, 12, tA, device="cpu")
        assert got.shape == (13, 13)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_create_interval_matches_reference():
    for n, pts in ((5, (0.0, 1.0)), (7, (-1.0, 2.5))):
        jm, tm = hx.create_interval(n, pts), ht.create_interval(n, pts)
        np.testing.assert_array_equal(tm.vertices, jm.vertices)
        np.testing.assert_array_equal(tm.cells, jm.cells)
        assert tm.structure.shape == jm.structure.shape == (n,)
        np.testing.assert_array_equal(tm.boundary_vertices(), jm.boundary_vertices())
        assert tm.volume() == pytest.approx(jm.volume(), rel=1e-15)


@pytest.mark.parametrize("name", ["interval5", "square7", "rect_left", "cube3", "box234"])
def test_boundary_facets_match_reference(name):
    """The boundary facets (sorted by one integer key per facet) and the
    cached boundary vertices equal the reference's row-wise unique."""
    from tests._torch_parity import port_mesh

    jm = {"interval5": lambda: hx.create_interval(5),
          "square7": lambda: hx.create_unit_square(7),
          "rect_left": lambda: hx.create_rectangle([[0, 0], [2, 1]], [5, 3], "left"),
          "cube3": lambda: hx.create_unit_cube(3),
          "box234": lambda: hx.create_box([[0, 0, 0], [1, 2, 3]], [2, 3, 4])}[name]()
    tm = port_mesh(jm)
    ref, got = jm.boundary_facets(), tm.boundary_facets()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tm.boundary_vertices(), jm.boundary_vertices())
    assert tm.boundary_vertices() is tm.boundary_vertices()


@pytest.mark.parametrize("in_place", [False, True])
def test_rescale_mesh_matches_reference(in_place):
    """rescale_mesh (a copy) and rescale_mesh_in_place move the vertices
    and the box structure as the reference's do, in 2D and 3D."""
    for jm, tm, shift in ((hx.create_unit_square(3), ht.create_unit_square(3), [0.5, -1.0]),
                          (hx.create_unit_cube(2), ht.create_unit_cube(2), [1.0, 2.0, 3.0])):
        if in_place:
            jr = jhelpers.rescale_mesh_in_place(jm, 2.5, shift)
            tr = helpers.rescale_mesh_in_place(tm, 2.5, shift)
            assert tr is tm
        else:
            jr, tr = jhelpers.rescale_mesh(jm, 2.5, shift), ht.rescale_mesh(tm, 2.5, shift)
            assert tr is not tm
        np.testing.assert_array_equal(tr.vertices, jr.vertices)
        np.testing.assert_array_equal(tr.cells, jr.cells)
        np.testing.assert_array_equal(tr.structure.lo, jr.structure.lo)
        np.testing.assert_array_equal(tr.structure.hi, jr.structure.hi)


def test_exports_mirror_the_reference():
    """The names of the reference's top-level exports that the port has
    ported, and the helpers module's."""
    ported = {"PoissonPeriodicHMM", "ElasticityPeriodicHMM", "BasePeriodicHMM", "PoissonFEM",
              "LinearElasticityFEM", "create_interval", "rescale_mesh", "locate_dofs_geometrical"}
    assert ported <= set(hx.__all__) and ported <= set(ht.__all__)
    for name in ported | {"fem_solve", "helpers"}:
        assert hasattr(ht, name), name
    for name in ("solve_diffusion_1d", "solve_diffusion_2d", "rescale_mesh",
                 "rescale_mesh_in_place", "PoissonFEM", "plot_fem_function"):
        assert name in helpers.__all__ and name in jhelpers.__all__
    from hommx_tpu_torch import models

    assert set(models.__all__) == set(hx.models.__all__)
    engine = ht.MicroEngine(ht.create_unit_square(4), device="cpu")
    for name in ("element_coeff", "cell_tensor", "solve_periodic"):
        assert callable(getattr(engine, name))
