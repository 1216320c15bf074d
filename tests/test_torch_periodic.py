"""Periodic homogenization through the port on the CPU: the golden
``periodic_tensor``, A_hom and the correctors against the JAX package, the
PoissonHMM ≡ PoissonPeriodicHMM identity (tests/test_integration_poisson.py:
104-133), and ElasticityPeriodicHMM against the JAX package, in float64 in
this process."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh
from tests.test_golden import GOLDEN, RTOL

torch.set_num_threads(1)


def _rel(a, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


def jax_lam(y):  # a 2D laminate with a smooth cross term
    return 2.0 + jnp.sin(2 * jnp.pi * y[0]) + 0.3 * jnp.cos(2 * jnp.pi * y[1])


def torch_lam(y):
    return 2.0 + torch.sin(2 * torch.pi * y[0]) + 0.3 * torch.cos(2 * torch.pi * y[1])


def _jax_mu(x, y):
    return jnp.where((y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09, 20.0, 1.0)


def _torch_mu(x, y):
    one = torch.ones((), dtype=y.dtype)
    return torch.where((y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09, 20.0 * one, one)


def _models(kind):
    """(JAX model, port model) of one periodic configuration."""
    if kind == "scalar":
        jmac, jmic = hx.create_unit_square(4), hx.create_unit_square(8)
        return (hx.PoissonPeriodicHMM(jmac, jax_lam, lambda x: 1.0, jmic, 0.1),
                ht.PoissonPeriodicHMM(port_mesh(jmac), torch_lam, lambda x: 1.0,
                                      port_mesh(jmic), 0.1, device="cpu"))
    one = lambda x, y: 1.0  # noqa: E731
    jA, tA = jval.hooke_tensor(2, _jax_mu, one), tval.hooke_tensor(2, _torch_mu, one)
    z = np.zeros(2)
    jmac = hx.create_rectangle([[0.0, 0.0], [1.0, 0.25]], [8, 2])
    jmic = hx.create_unit_square(5)
    return (hx.ElasticityPeriodicHMM(jmac, lambda y: jA(jnp.asarray(z), y),
                                     lambda x: jnp.array([0.0, -0.01]), jmic, 0.1),
            ht.ElasticityPeriodicHMM(port_mesh(jmac), lambda y: tA(torch.as_tensor(z), y),
                                     [0.0, -0.01], port_mesh(jmic), 0.1, device="cpu"))


def test_golden_periodic_tensor_f64():
    """The golden ``periodic_tensor`` (4² macro, 16² micro, A = 2 + sin
    2πy₀) at the goldens' RTOL."""
    ph = ht.PoissonPeriodicHMM(ht.create_unit_square(4),
                               lambda y: 2.0 + torch.sin(2 * torch.pi * y[0]), lambda x: 1.0,
                               ht.create_unit_square(16), device="cpu")
    A = ph.compute_effective_tensor()
    assert A.dtype == torch.float64 and A.shape == (2, 2)
    got = (float(A[0, 0]), float(A[1, 1]))
    for g, w in zip(got, GOLDEN["periodic_tensor"]):
        assert g == pytest.approx(w, rel=RTOL)


@pytest.mark.parametrize("kind", ["scalar", "elasticity"])
def test_effective_tensor_and_correctors_match_reference(kind):
    """A_hom and every corrector (expanded to the full periodic node set)
    against the reference within 1e-10 relative (correctors relative to
    the largest corrector entry)."""
    jm, tm = _models(kind)
    A_ref = np.asarray(jm.compute_effective_tensor())
    A = tm.compute_effective_tensor()
    assert A.shape == A_ref.shape and tm.A_hom is A
    assert _rel(A.numpy(), A_ref) < 1e-10
    assert len(tm.correctors) == len(jm.correctors)
    scale = max(float(np.abs(np.asarray(c.array)).max()) for c in jm.correctors)
    for cj, ct in zip(jm.correctors, tm.correctors):
        assert ct.array.shape == np.asarray(cj.array).shape
        assert float(np.abs(ct.array.numpy() - np.asarray(cj.array)).max()) < 1e-10 * scale


def test_poisson_hmm_matches_periodic_homogenization():
    """For A = A(y), PoissonHMM ≡ PoissonPeriodicHMM: solutions within
    1e-12 in L², assembled matrices within 1e-8 in the Frobenius norm
    (the reference's gates), and both the reference's periodic solution to
    1e-10."""
    jmac, jmic = hx.create_unit_square(8), hx.create_unit_square(8)
    mac, mic = port_mesh(jmac), port_mesh(jmic)
    hmm = ht.PoissonHMM(mac, lambda x, y: torch_lam(y), lambda x: 1.0, mic, 0.1, device="cpu")
    hmm.set_boundary_conditions(tval.zero_dirichlet_bcs(hmm.function_space))
    u_hmm = hmm.solve()
    per = ht.PoissonPeriodicHMM(mac, torch_lam, lambda x: 1.0, mic, 0.1, device="cpu")
    per.set_boundary_conditions(tval.zero_dirichlet_bcs(per.function_space))
    u_per = per.solve()
    assert tval.calc_l2_error(mac, u_hmm, u_per) < 1e-12
    A_hmm, A_per = hmm.matrix_dense(), per.matrix_dense()
    assert A_hmm.shape == A_per.shape == (mac.num_vertices,) * 2
    assert np.linalg.norm(A_hmm - A_per) < 1e-8
    jper = hx.PoissonPeriodicHMM(jmac, jax_lam, lambda x: 1.0, jmic, 0.1)
    jper.set_boundary_conditions(jval.zero_dirichlet_bcs(jper.function_space))
    u_ref = np.asarray(jper.solve().array)
    assert _rel(u_per.array.numpy(), u_ref) < 1e-10
    assert np.abs(A_per - np.asarray(jper.matrix_dense())).max() < 1e-10 * np.abs(A_per).max()


@pytest.mark.parametrize("kind", ["scalar", "elasticity"])
def test_periodic_solve_matches_reference(kind):
    """solve() with a clamped or zero boundary: the reference's solution
    within 1e-10, the macro system float64 on the direct path."""
    jm, tm = _models(kind)
    Vj, Vt = jm.function_space, tm.function_space
    if kind == "scalar":
        jm.set_boundary_conditions(jval.zero_dirichlet_bcs(Vj))
        tm.set_boundary_conditions(tval.zero_dirichlet_bcs(Vt))
    else:
        from hommx_tpu.ops.function_space import boundary_dofs as jbd
        from hommx_tpu_torch.ops.function_space import boundary_dofs as tbd

        clamp = lambda x: np.isclose(x[0], 0)  # noqa: E731
        jm.set_boundary_conditions(hx.dirichletbc(np.zeros(2), jbd(Vj, clamp), Vj))
        tm.set_boundary_conditions(ht.dirichletbc(np.zeros(2), tbd(Vt, clamp), Vt))
    u_ref = np.asarray(jm.solve().array)
    u = tm.solve()
    assert u.array.dtype == torch.float64 and tm.diagnostics["macro_method"] == "direct"
    assert _rel(u.array.numpy(), u_ref) < 1e-10
    tm.set_right_hand_side(2.0 if kind == "scalar" else [0.0, -0.02])
    np.testing.assert_allclose(tm.solve().array.numpy(), 2 * u.array.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_periodic_errors_and_unported_parts():
    """The reference's constructor checks, and matrix_dense and
    plot_solution before a solve."""
    sq = ht.create_unit_square(4)
    with pytest.raises(ValueError):
        ht.PoissonPeriodicHMM(sq, torch_lam, 1.0, ht.create_interval(4), device="cpu")
    per = ht.PoissonPeriodicHMM(sq, torch_lam, 1.0, ht.create_unit_square(4), device="cpu")
    with pytest.raises(RuntimeError):
        per.matrix_dense()
    with pytest.raises(RuntimeError, match="solve"):
        per.plot_solution()
