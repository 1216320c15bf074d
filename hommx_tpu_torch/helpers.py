"""Reference-compatible helpers module (torch port of
``hommx_tpu/helpers.py``): the names of the reference's ``hommx.helpers``,
so its users can move their imports over:

    from hommx_tpu_torch.helpers import solve_diffusion_2d, rescale_mesh, PoissonFEM

The solves run on ``device`` (the card unless the caller passes "cpu").
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from hommx_tpu_torch.meshes.simplex import (  # noqa: F401
    create_interval,
    create_unit_square,
    mesh_from_delaunay,
    mesh_from_file,
    rescale_mesh,
    rescale_mesh_in_place,
)
from hommx_tpu_torch.models.fem import PoissonFEM, fem_solve  # noqa: F401
from hommx_tpu_torch.ops.function_space import FunctionSpace, boundary_dofs, dirichletbc
from hommx_tpu_torch.utils.plotting import plot_fem_function  # noqa: F401

__all__ = [
    "solve_diffusion_1d",
    "solve_diffusion_2d",
    "rescale_mesh",
    "rescale_mesh_in_place",
    "mesh_from_file",
    "mesh_from_delaunay",
    "PoissonFEM",
    "fem_solve",
    "plot_fem_function",
]


def _solve_unit_f(msh, A_callable: Callable, device) -> np.ndarray:
    """-div(A ∇u) = 1 with u = 0 on the boundary; the dof array."""
    V = FunctionSpace(msh, 1)
    bcs = [dirichletbc(0.0, boundary_dofs(V), V)]
    u = fem_solve(V, lambda x: A_callable(x), lambda x: 1.0, bcs, device=device)
    return u.array.cpu().numpy()


def solve_diffusion_1d(epsilon: float, nx: int, A_callable: Callable, device="cuda") -> np.ndarray:
    """1D multiscale diffusion solve: -d/dx(A(x) du/dx) = 1, u(0) = u(1) =
    0 on ``nx`` intervals (reference ``helpers.py:26-65``); the dof array."""
    return _solve_unit_f(create_interval(nx), A_callable, device)


def solve_diffusion_2d(epsilon: float, nx: int, A_callable: Callable, device="cuda") -> np.ndarray:
    """2D multiscale diffusion solve on the unit square with f = 1 and zero
    Dirichlet BCs (reference ``helpers.py:68-122``, without its plot); the
    values sorted into an (nx+1, nx+1) grid, x-major."""
    msh = create_unit_square(nx, nx)
    u = _solve_unit_f(msh, A_callable, device)
    coords = msh.vertices
    # lexicographic (x-major) order; a weighted-sum key would collide once
    # nx reaches the weight
    ix = np.lexsort((coords[:, 1], coords[:, 0]))
    return u[ix].reshape(nx + 1, nx + 1)
