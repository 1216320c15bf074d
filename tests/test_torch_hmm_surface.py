"""The rest of the ``BaseHMM`` surface through the port against the JAX
package (float64 on the CPU): ``set_right_hand_side`` with a second solve,
``cell_correctors``, ``local_stiffness`` and ``matrix_dense``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

JAX_A = lambda x, y: 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0]) * jnp.cos(2 * jnp.pi * y[1])
TORCH_A = lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0]) * torch.cos(2 * torch.pi * y[1])


def jax_mu(x, y):
    inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09
    return jnp.where(inc, 50.0 * (1.0 + 0.2 * x[0]), 0.5 + 0.3 * jnp.sin(2 * jnp.pi * y[1]))


def torch_mu(x, y):
    inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09
    return torch.where(inc, 50.0 * (1.0 + 0.2 * x[0]), 0.5 + 0.3 * torch.sin(2 * torch.pi * y[1]))


ONE = lambda x, y: 1.0


def _poisson():
    """(reference, port) PoissonHMM on a 6² macro, 8² micro mesh; the
    reference on its chunk-PCG route, the port's route."""
    jmac, jmic = hx.create_unit_square(6), hx.create_unit_square(8)
    hj = hx.PoissonHMM(jmac, JAX_A, lambda x: 1.0, jmic, 2**-4,
                       engine_kwargs={"solver": "pcg", "pcg_tol": 1e-13})
    h = ht.PoissonHMM(port_mesh(jmac), TORCH_A, lambda x: 1.0, port_mesh(jmic), 2**-4,
                      engine_kwargs={"pcg_tol": 1e-13}, device="cpu")
    return hj, h


def _elasticity():
    """(reference, port) LinearElasticityHMM on a 4x2 rectangle with a 4²
    micro mesh, clamped at x₀ = 0."""
    jmac = hx.create_rectangle([[0.0, 0.0], [1.0, 0.25]], [4, 2])
    jmic = hx.create_unit_square(4)
    clamp = lambda x: np.isclose(x[0], 0)
    hj = hx.LinearElasticityHMM(jmac, jval.hooke_tensor(2, jax_mu, ONE),
                                lambda x: jnp.array([0.0, -0.01]), jmic, 2**-4)
    V = hj.function_space
    hj.set_boundary_conditions(hx.dirichletbc(np.zeros(2), jax_boundary_dofs(V, clamp), V))
    f = torch.tensor([0.0, -0.01], dtype=torch.float64)
    h = ht.LinearElasticityHMM(port_mesh(jmac), tval.hooke_tensor(2, torch_mu, ONE),
                               lambda x: f, port_mesh(jmic), 2**-4, device="cpu")
    V = h.function_space
    h.set_boundary_conditions(ht.dirichletbc(np.zeros(2), boundary_dofs(V, clamp), V))
    return hj, h


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def test_set_right_hand_side_then_solve_again():
    """A second solve after ``set_right_hand_side`` reuses the micro stage
    and agrees with the reference's second solve; doubling f doubles u."""
    hj, h = _poisson()
    u1 = h.solve().array.numpy()
    hj.solve()
    A_star = h._A_star
    f2 = lambda x: 2.0 + x[0] * x[1]
    hj.set_right_hand_side(lambda x: 2.0 + x[0] * x[1])
    h.set_right_hand_side(f2)
    u2_ref = np.asarray(hj.solve().array)
    u2 = h.solve().array.numpy()
    assert h._A_star is A_star
    assert _rel(u2, u2_ref) < 1e-9
    h.set_right_hand_side(2.0)
    np.testing.assert_allclose(h.solve().array.numpy(), 2 * u1, rtol=0, atol=1e-12)


@pytest.mark.parametrize("model", ["poisson", "elasticity"])
def test_cell_correctors_match_reference(model):
    """A* and the correctors expanded to the full periodic node set, on
    selected cells, against the reference at 1e-9; the correctors are
    exactly periodic."""
    hj, h = _poisson() if model == "poisson" else _elasticity()
    cells = [0, 5, 11]
    A_ref, X_ref = hj.cell_correctors(cells=cells)
    A, X = h.cell_correctors(cells=cells)
    eng = h._engine
    n_nodes = eng.mesh.num_vertices
    assert X.shape == tuple(np.shape(X_ref)) == (3, n_nodes * eng.bs, eng.s_full)
    assert _rel(A, A_ref) < 1e-9
    assert _rel(X, X_ref) < 1e-9
    # exact periodicity across x₀ = 0 and x₀ = 1
    v = np.asarray(eng.mesh.vertices)
    left, right = (np.where(np.isclose(v[:, 0], t))[0] for t in (0.0, 1.0))
    left = left[np.argsort(v[left, 1], kind="stable")]
    right = right[np.argsort(v[right, 1], kind="stable")]
    Xn = X[0].numpy().reshape(n_nodes, eng.bs, -1)
    assert np.abs(Xn[left] - Xn[right]).max() == 0.0
    # the whole batch through the default argument
    A_all, _ = h.cell_correctors()
    assert A_all.shape[0] == h._sys.centers.shape[0]


@pytest.mark.parametrize("model", ["poisson", "elasticity"])
def test_local_stiffness_matches_reference(model):
    hj, h = _poisson() if model == "poisson" else _elasticity()
    S_ref = np.asarray(hj.local_stiffness())
    S = h.local_stiffness().numpy()
    assert S.shape == S_ref.shape
    assert _rel(S, S_ref) < 1e-10


@pytest.mark.parametrize("model", ["poisson", "elasticity"])
def test_matrix_dense_matches_reference(model):
    """The BC-applied macro matrix of the last solve at 1e-12 relative; a
    RuntimeError before the first solve."""
    hj, h = _poisson() if model == "poisson" else _elasticity()
    with pytest.raises(RuntimeError, match="solve"):
        h.matrix_dense()
    h.solve()
    hj.solve()
    M, M_ref = h.matrix_dense(), hj.matrix_dense()
    assert isinstance(M, np.ndarray) and M.shape == M_ref.shape == (h.function_space.num_dofs,) * 2
    assert _rel(M, M_ref) < 1e-12
