"""Micro engine parity: the port's ``tensors_for_centers`` against the JAX
package's MicroEngine on its chunk-PCG route (float64, 8x8 micro mesh, 64
seeded centers, chunk 16), plus the zero-corrector tensors and the routes
that are not ported yet."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

# the same formula in both frameworks
JAX_A = lambda x, y: 1.5 + x[0] + jnp.sin(2 * jnp.pi * y[0]) * jnp.cos(2 * jnp.pi * y[1])
TORCH_A = lambda x, y: 1.5 + x[0] + torch.sin(2 * torch.pi * y[0]) * torch.cos(2 * torch.pi * y[1])


@pytest.fixture(scope="module")
def engines():
    jm = hx.create_unit_square(8)
    je = JaxEngine(jm, dtype=jnp.float64, solver="pcg")
    te = ht.MicroEngine(port_mesh(jm), device="cpu")
    centers = np.random.default_rng(11).uniform(0, 1, (64, 2))
    return je, te, centers


def test_tensors_for_centers_f64_matches_reference(engines):
    """Same Krylov process in float64: A* agrees to 1e-9 relative."""
    je, te, centers = engines
    A_ref = np.asarray(je.tensors_for_centers(JAX_A, jnp.asarray(centers), chunk=16))
    A = te.tensors_for_centers(TORCH_A, torch.as_tensor(centers), chunk=16).numpy()
    assert A.shape == A_ref.shape == (64, 2, 2)
    np.testing.assert_allclose(A, A_ref, rtol=1e-9, atol=0)


def test_plain_chunk_route_matches_reference(engines):
    """``tensors_chunk_plain``, the plain PCG loop a card run checks the
    kernel route against in float64, agrees with the reference to 1e-9
    relative on ragged chunks."""
    from hommx_tpu_torch.micro.chunk import tensors_chunk_plain
    from hommx_tpu_torch.micro.krylov import _map_chunked

    je, te, centers = engines
    A_ref = np.asarray(je.tensors_for_centers(JAX_A, jnp.asarray(centers), chunk=16))
    A = _map_chunked(lambda c: tensors_chunk_plain(te, TORCH_A, c), torch.as_tensor(centers), 24)
    np.testing.assert_allclose(A.numpy(), A_ref, rtol=1e-9, atol=0)


def test_float32_route_matches_reference(engines):
    """The float32 route (the kernel's route; its plain version on the CPU)
    against the float64 reference: f32 PCG to tol 1e-5 is ~1e-6 on A*."""
    je, _, centers = engines
    te32 = ht.MicroEngine(port_mesh(hx.create_unit_square(8)), dtype=torch.float32,
                           device="cpu")
    A_ref = np.asarray(je.tensors_for_centers(JAX_A, jnp.asarray(centers), chunk=16))
    A = te32.tensors_for_centers(TORCH_A, torch.as_tensor(centers, dtype=torch.float32), chunk=16)
    assert A.dtype == torch.float32
    assert np.abs(A.numpy() - A_ref).max() / np.abs(A_ref).max() < 1e-5


def test_nocorrector_tensors_match_reference(engines):
    je, te, centers = engines
    A0_ref, c_ref = je.nocorrector_tensors(JAX_A, jnp.asarray(centers))
    A0, c = te.nocorrector_tensors(TORCH_A, torch.as_tensor(centers), chunk=16)
    np.testing.assert_allclose(A0.numpy(), np.asarray(A0_ref), rtol=1e-13, atol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-13, atol=0)


def test_chunking_and_padding_do_not_change_results(engines):
    """_map_chunked pads the last chunk with copies of the first center."""
    _, te, centers = engines
    c = torch.as_tensor(centers[:37])
    A_a = te.tensors_for_centers(TORCH_A, c, chunk=16)
    A_b = te.tensors_for_centers(TORCH_A, c, chunk=37)
    assert A_a.shape == (37, 2, 2)
    np.testing.assert_allclose(A_a.numpy(), A_b.numpy(), rtol=1e-9, atol=0)


@pytest.mark.parametrize(
    "kwargs",
    [{"solver": "cholesky"}, {"cell_prec": "fft"}, {"bs": 2}, {"coeff_kind": "matrix"}],
)
def test_unported_routes_raise(kwargs):
    with pytest.raises(NotImplementedError):
        ht.MicroEngine(ht.create_unit_square(4), device="cpu", **kwargs)


def test_k0_scatter_assembly_matches_dense():
    """The two builds of the unit-coefficient operator K0 (dense DᵀD for
    small cells, per-element scatter above n = 512) give the same K0⁻¹."""
    mesh = ht.create_unit_square(6)
    K_dense = ht.MicroEngine(mesh, assembly="dense", device="cpu")._get_K0inv()
    K_scatter = ht.MicroEngine(mesh, assembly="scatter", device="cpu")._get_K0inv()
    np.testing.assert_allclose(K_scatter.numpy(), K_dense.numpy(), rtol=0,
                               atol=1e-12 * K_dense.abs().max().item())


@pytest.mark.parametrize("variant", ["dfree_scaling", "no_scaling"])
def test_scaling_variants_match(engines, variant):
    """The D-free diagonal proxy (cell meshes too large for the dense D)
    equals the dense one, and the unscaled PCG converges to the same A*."""
    _, te, centers = engines
    c = torch.as_tensor(centers[:16])
    A_ref = te.tensors_for_centers(TORCH_A, c)
    mesh = te.mesh
    if variant == "dfree_scaling":
        other = ht.MicroEngine(mesh, device="cpu")
        other.D = None  # what build_operators leaves above its size cap
    else:
        other = ht.MicroEngine(mesh, diag_scale=False, device="cpu")
    np.testing.assert_allclose(other.tensors_for_centers(TORCH_A, c).numpy(), A_ref.numpy(),
                               rtol=1e-9, atol=0)
