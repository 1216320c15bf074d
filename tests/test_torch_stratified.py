"""Stratified scalar problems and the 3D scalar slice through the port:
``PoissonStratifiedHMM`` against the frozen golden and the JAX package, the
stencil chunk route with a gradient map against the reference's chunk
route, and a 3D ``PoissonHMM`` end to end (float64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu_torch.micro.chunk import chunk_system, tensors_chunk_plain
from hommx_tpu_torch.micro.stencil import stencil_weights
from hommx_tpu_torch.micro.stencil_pcg import launch_config
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh
from tests.test_golden import GOLDEN, RTOL

torch.set_num_threads(1)


# -- the golden wavy laminate, written once in jnp and once in torch --------


def jax_golden_A(x, y):
    return jnp.where(jnp.sin(2 * jnp.pi * y[1]) > 0.0, 2.0, 0.5)


def torch_golden_A(x, y):
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(torch.sin(2 * torch.pi * y[1]) > 0.0, 2.0 * one, 0.5 * one)


def jax_golden_Dt(x):
    return jnp.array([[1.0, -2.0 * jnp.pi * jnp.cos(2.0 * jnp.pi * x[0])], [0.0, 1.0]])


def torch_golden_Dt(x):
    z, o = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return torch.stack([torch.stack([o, -2.0 * torch.pi * torch.cos(2.0 * torch.pi * x[0])]),
                        torch.stack([z, o])])


# -- the laminate example (examples/diffusion/laminate.py) -------------------


def jax_laminate_A(x, y):
    return jnp.where(jnp.cos(2 * jnp.pi * y[0]) < 0, 5.0, 0.05)


def torch_laminate_A(x, y):
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(torch.cos(2 * torch.pi * y[0]) < 0, 5.0 * one, 0.05 * one)


def jax_laminate_Dt(x):
    return jnp.array([[-2 * jnp.pi * jnp.cos(2 * jnp.pi * x[0]), 1.0], [1.0, 0.0]])


def torch_laminate_Dt(x):
    z, o = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return torch.stack([torch.stack([-2 * torch.pi * torch.cos(2 * torch.pi * x[0]), o]),
                        torch.stack([o, z])])


def _darcy(V, dirichletbc, bdofs):
    lo, hi = V.mesh.bounding_box()
    left = bdofs(V, lambda x: np.isclose(x[0], lo[0]))
    right = bdofs(V, lambda x: np.isclose(x[0], hi[0]))
    return [dirichletbc(1.0, left, V), dirichletbc(0.0, right, V)]


def test_golden_poisson_stratified_f64():
    """The golden poisson_stratified configuration through the port (float64,
    default dedup) matches the frozen functionals at RTOL = 1e-8."""
    macro, micro = ht.create_unit_square(8, 8), ht.create_unit_square(8, 8)
    hmm = ht.PoissonStratifiedHMM(macro, torch_golden_A, lambda x: 1.0, micro, 2**-4,
                                  torch_golden_Dt, device="cpu")
    u = hmm.solve()
    got = (tval.calc_l2_norm(macro, u), float(u.array.abs().max()))
    for g, w in zip(got, GOLDEN["poisson_stratified"]):
        assert g == pytest.approx(w, rel=RTOL), (got, GOLDEN["poisson_stratified"])
    assert hmm.diagnostics["unique_cells"] < hmm.diagnostics["num_cells"]


@pytest.fixture(scope="module")
def laminate_engines():
    jm = hx.create_unit_square(8)
    je = JaxEngine(jm, dtype=jnp.float64, solver="pcg")
    te = ht.MicroEngine(port_mesh(jm), device="cpu")
    centers = np.random.default_rng(5).uniform(0, 1, (48, 2))
    return je, te, centers


def test_stratified_chunk_astar_matches_reference(laminate_engines):
    """A* of stratified chunks on the port's stencil route (the kernel's
    plain version on the CPU, and the plain loop a card run checks it
    with) against the reference's chunk route, at 1e-10 relative."""
    je, te, centers = laminate_engines
    A_ref = np.asarray(je.tensors_for_centers(jax_laminate_A, jnp.asarray(centers),
                                              G_fn=jax_laminate_Dt, chunk=16))
    c = torch.as_tensor(centers)
    A = te.tensors_for_centers(torch_laminate_A, c, G_fn=torch_laminate_Dt, chunk=16)
    A_plain = tensors_chunk_plain(te, torch_laminate_A, c, torch_laminate_Dt)
    scale = np.abs(A_ref).max()
    assert np.abs(A.numpy() - A_ref).max() / scale < 1e-10
    assert np.abs(A_plain.numpy() - A_ref).max() / scale < 1e-10


def test_gradient_map_keeps_the_stencil_and_launch_config(laminate_engines):
    """G enters the weights and loads only: the stencil (its offsets) is the
    engine's one, the weights are one per offset, B_K = I gives the unmapped
    weights, and K1's launch configuration depends on (n, s) alone."""
    _, te, centers = laminate_engines
    c = torch.as_tensor(centers[:16])
    plain = chunk_system(te, torch_laminate_A, c)
    mapped = chunk_system(te, torch_laminate_A, c, torch_laminate_Dt)
    assert mapped.st is plain.st and len(mapped.ws) == len(plain.ws) == len(plain.st.offsets)
    assert mapped.F.shape == plain.F.shape == (te.n_reduced, te.s, 16)
    eye = torch.eye(2, dtype=torch.float64).expand(16, 2, 2)
    ws_eye = stencil_weights(plain.st, plain.a, eye)
    for w, w0 in zip(ws_eye, plain.ws):
        np.testing.assert_allclose(w.numpy(), w0.numpy(), rtol=0, atol=1e-13)
    assert launch_config(te.n_reduced, te.s) == launch_config(mapped.F.shape[0], mapped.F.shape[1])


def test_poisson_hmm_3d_matches_reference():
    """A 3D PoissonHMM (4³ macro, 4³ micro, the flagship coefficient) against
    the JAX package at 1e-8 relative."""
    jmac, jmic = hx.create_unit_cube(4), hx.create_unit_cube(4)
    u_ref = np.asarray(hx.PoissonHMM(jmac, lambda x, y: 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0]),
                                     lambda x: 1.0, jmic, 2**-3).solve().array)
    h = ht.PoissonHMM(port_mesh(jmac), lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0]),
                      lambda x: 1.0, port_mesh(jmic), 2**-3, device="cpu")
    u = h.solve().array.numpy()
    assert h._engine.d == 3 and h.diagnostics["num_cells"] == 384
    assert np.abs(u - u_ref).max() / np.abs(u_ref).max() < 1e-8


def test_stratified_darcy_matches_reference():
    """PoissonStratifiedHMM on the laminate example's coefficient and map
    (contrast 100) with Darcy boundary conditions (1 left, 0 right) against
    the JAX package at 1e-8 relative."""
    jmac, jmic = hx.create_unit_square(8), hx.create_unit_square(8)
    hj = hx.PoissonStratifiedHMM(jmac, jax_laminate_A, lambda x: 1.0, jmic, 2**-5,
                                 jax_laminate_Dt)
    hj.set_boundary_conditions(_darcy(hj.function_space, hx.dirichletbc, jax_boundary_dofs))
    u_ref = np.asarray(hj.solve().array)
    h = ht.PoissonStratifiedHMM(port_mesh(jmac), torch_laminate_A, lambda x: 1.0,
                                port_mesh(jmic), 2**-5, torch_laminate_Dt, device="cpu")
    h.set_boundary_conditions(_darcy(h.function_space, ht.dirichletbc, boundary_dofs))
    u = h.solve().array.numpy()
    assert np.abs(u - u_ref).max() / np.abs(u_ref).max() < 1e-8
    # the coefficient does not depend on x, so the classes are those of
    # Dθᵀ(c_T) as each framework rounds it: cos 2πx₀ of the 16 barycenter
    # x₀ repeats bitwise for 2 mirrored pairs in torch, for none in JAX
    G = torch.func.vmap(torch_laminate_Dt)(h._sys.centers).reshape(-1, 4).numpy()
    assert h.diagnostics["unique_cells"] == np.unique(G, axis=0).shape[0] == 14
    assert hj.diagnostics["unique_cells"] == 16
    dg = h.diagnostics
    assert dg["diverged_cells"].size == dg["nan_cells"].size == 0
