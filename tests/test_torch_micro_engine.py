"""Micro engine parity: the port's ``tensors_for_centers`` against the JAX
package's MicroEngine on its chunk-PCG route (float64, 8x8 micro mesh, 64
seeded centers, chunk 16), plus the zero-corrector tensors, the routes an
earlier slice lacked, K1's size check and the whole-batch Cholesky's
``diag_scale``."""

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
    te = ht.MicroEngine(port_mesh(jm), device="cpu", solver="pcg")
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
    [{"solver": "cholesky"}, {"solver": "pcg", "cell_prec": "fft"},
     {"bs": 2, "coeff_kind": "tensor4", "solver": "pcg", "pcg_strategy": "matfree"},
     {"coeff_kind": "matrix"}],
)
def test_unported_routes_raise(kwargs):
    """The routes this test once pinned as unported — the scalar per-cell
    Cholesky, the FFT cell preconditioner on the chunk PCG, the vector PCG
    (block stencil) and matrix coefficients (the per-cell route) — run and
    give the reference's A* (1e-10)."""
    jm = hx.create_unit_square(4)
    c = np.random.default_rng(3).uniform(0, 1, (6, 2))
    if kwargs.get("coeff_kind") == "tensor4":
        from hommx_tpu.utils.validation import hooke_tensor as jh
        from hommx_tpu_torch.utils.validation import hooke_tensor as th

        jA = jh(2, lambda x, y: 1.0 + 0.5 * jnp.sin(2 * jnp.pi * y[0]), lambda x, y: 1.0)
        tA = th(2, lambda x, y: 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0]), lambda x, y: 1.0)
    elif kwargs.get("coeff_kind") == "matrix":
        jA = lambda x, y: jnp.array([[2.0 + jnp.sin(2 * jnp.pi * y[0]), 0.2 * x[0]],
                                     [0.2 * x[0], 1.0 + x[1]]])
        tA = lambda x, y: torch.stack([torch.stack([2.0 + torch.sin(2 * torch.pi * y[0]),
                                                    0.2 * x[0]]),
                                       torch.stack([0.2 * x[0], 1.0 + x[1]])])
    else:
        jA, tA = JAX_A, TORCH_A
    je = JaxEngine(jm, dtype=jnp.float64, **kwargs)
    te = ht.MicroEngine(port_mesh(jm), device="cpu", **kwargs)
    A_ref = np.asarray(je.tensors_for_centers(jA, jnp.asarray(c)))
    A = te.tensors_for_centers(tA, torch.as_tensor(c)).numpy()
    assert A.shape == A_ref.shape
    assert np.abs(A - A_ref).max() / np.abs(A_ref).max() < 1e-10


def test_k1_limit_checked_at_construction():
    """K1's size limit is checked when a float32 CUDA engine on K1's route
    is built: the check itself takes n = 4096 (the 64² square, the 16³
    cube) at every s and raises NotImplementedError naming ROADMAP B7 and
    the limit at n = 4097."""
    from hommx_tpu_torch.micro.stencil_pcg import check_k1_fits

    for s in (1, 2, 3):
        assert check_k1_fits(4096, s).large
        with pytest.raises(NotImplementedError) as err:
            check_k1_fits(4097, s)
        assert "B7" in str(err.value) and "4096" in str(err.value)
    # the engine's rule for which routes launch K1: not the multigrid one
    eng = ht.MicroEngine(ht.create_unit_square(4), dtype=torch.float32, device="cpu")
    assert eng._k1_route()
    assert not ht.MicroEngine(ht.create_unit_square(4), dtype=torch.float32, cell_prec="mg",
                              device="cpu")._k1_route()


def test_chol_batched_honours_diag_scale():
    """``tensors_chol_batched`` with diag_scale=False (the reference
    equilibrates whatever diag_scale says) solves the unscaled systems: it
    equals the in-chunk route with diag_scale=False (1e-12) and the scaled
    run within 1e-8 (float64, 3³ elasticity)."""
    from hommx_tpu_torch.micro.chunk import tensors_chol_batched
    from hommx_tpu_torch.utils.validation import hooke_tensor as th

    A = th(3, lambda x, y: 1.0 + x[0] + 0.5 * torch.sin(2 * torch.pi * y[1]), lambda x, y: 1.0)
    c = torch.as_tensor(np.random.default_rng(4).uniform(0, 1, (5, 3)))
    kw = dict(bs=3, coeff_kind="tensor4", device="cpu")
    off = ht.MicroEngine(ht.create_unit_cube(3), diag_scale=False, **kw)
    on = ht.MicroEngine(ht.create_unit_cube(3), **kw)
    A_off = tensors_chol_batched(off, A, c, chunk=2)
    A_chunk = off.tensors_for_centers(A, c, chunk=2)
    A_on = tensors_chol_batched(on, A, c, chunk=2)
    assert float((A_off - A_chunk).abs().max()) <= 1e-12 * float(A_chunk.abs().max())
    assert float((A_off - A_on).abs().max()) <= 1e-8 * float(A_on.abs().max())


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
        other = ht.MicroEngine(mesh, device="cpu", solver="pcg")
        other.D = None  # what build_operators leaves above its size cap
    else:
        other = ht.MicroEngine(mesh, diag_scale=False, device="cpu", solver="pcg")
    np.testing.assert_allclose(other.tensors_for_centers(TORCH_A, c).numpy(), A_ref.numpy(),
                               rtol=1e-9, atol=0)


@pytest.mark.parametrize("name", ["square33", "cube10"])
def test_large_cells_match_reference(name):
    """Cells above the small K1 instance's reach (33²: n = 1089; 10³: n =
    1000), which the large instance takes on the card: the port's chunk
    route (its plain PCG on the CPU) against the reference's, 4 cells,
    float64, to 1e-9 of max |A*| (the 3D tensor's off-diagonal entries are
    zero up to rounding)."""
    jm = hx.create_unit_square(33) if name == "square33" else hx.create_unit_cube(10)
    je = JaxEngine(jm, dtype=jnp.float64, solver="pcg")
    te = ht.MicroEngine(port_mesh(jm), device="cpu", solver="pcg")
    assert te._k1_route() and te.n_reduced in (1089, 1000)
    centers = np.random.default_rng(23).uniform(0, 1, (4, te.d))
    A_ref = np.asarray(je.tensors_for_centers(JAX_A, jnp.asarray(centers)))
    A = te.tensors_for_centers(TORCH_A, torch.as_tensor(centers)).numpy()
    assert A.shape == A_ref.shape == (4, te.d, te.d)
    assert np.abs(A - A_ref).max() / np.abs(A_ref).max() < 1e-9
