"""The slice as a whole: ``PoissonHMM.solve()`` through the port against the
frozen golden functionals and against the JAX package's PoissonHMM on the
CG path, plus the macro assembly and the error probes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.models.common import MacroSystem as JaxMacroSystem
from hommx_tpu.models.common import assemble_macro_system as jax_assemble
from hommx_tpu.models.common import merge_bcs as jax_merge_bcs
from hommx_tpu.ops.assembly import assemble_load_vector as jax_load
from hommx_tpu.ops.function_space import FunctionSpace as JaxFunctionSpace
from hommx_tpu_torch.models.common import MacroSystem, assemble_macro_system, merge_bcs
from hommx_tpu_torch.ops.assembly import assemble_load_vector, l2_norm_fn
from tests._torch_parity import port_mesh
from tests.test_golden import GOLDEN, RTOL

torch.set_num_threads(1)

JAX_A = lambda x, y: 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0])
TORCH_A = lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def test_golden_poisson_hmm_f64():
    """The golden poisson_hmm configuration through the port (float64,
    direct macro solve) matches the frozen functionals at RTOL = 1e-8."""
    macro, micro = ht.create_unit_square(8, 8), ht.create_unit_square(8, 8)

    def A(x, y):
        return 0.33 + 0.15 * (torch.sin(2 * torch.pi * x[0]) + torch.sin(2 * torch.pi * y[0]))

    hmm = ht.PoissonHMM(macro, A, lambda x: 1.0, micro, 0.1 / 8, device="cpu")
    u = hmm.solve().array
    assert u.dtype == torch.float64 and hmm._macro_method == "direct"
    l2 = float(l2_norm_fn(torch.as_tensor(macro.vertices), torch.as_tensor(macro.cells), u))
    got = (l2, float(u.abs().max()))
    for g, w in zip(got, GOLDEN["poisson_hmm"]):
        assert g == pytest.approx(w, rel=RTOL), (got, GOLDEN["poisson_hmm"])


def test_cg_slice_matches_reference():
    """40x40 macro, 8x8 micro, float64, Jacobi CG to rtol 1e-12: the
    solution agrees with the JAX package to 1e-8 relative and the CG
    iteration counts agree to one."""
    jmac, jmic = hx.create_unit_square(40), hx.create_unit_square(8)
    hj = hx.PoissonHMM(
        jmac, JAX_A, lambda x: 1.0, jmic, 2**-5,
        options_global_solve=hx.SolverOptions(method="cg", pc="jacobi", rtol=1e-12),
        dedup_cells=False, engine_kwargs={"solver": "pcg"},
    )
    u_ref = np.asarray(hj.solve().array)
    ht_hmm = ht.PoissonHMM(
        port_mesh(jmac), TORCH_A, lambda x: 1.0, port_mesh(jmic), 2**-5,
        options_global_solve=ht.SolverOptions(method="cg", pc="jacobi", rtol=1e-12),
        device="cpu",
    )
    u = ht_hmm.solve().array.numpy()
    assert np.abs(u - u_ref).max() / np.abs(u_ref).max() < 1e-8
    assert abs(ht_hmm.diagnostics["macro_iterations"] - hj.diagnostics["macro_iterations"]) <= 1
    dg = ht_hmm.diagnostics
    assert dg["num_cells"] == 3200 and dg["macro_iterations"] < 10000
    assert dg["diverged_cells"].size == dg["fallback_cells"].size == dg["nan_cells"].size == 0


@pytest.mark.parametrize("macro_f64", [True, False])
def test_macro_assembly_matches_reference(macro_f64):
    """Load vector, per-cell stiffness, ELL assembly and Dirichlet lifting
    on seeded homogenized tensors equal the reference to rounding."""
    jmac = hx.create_unit_square(10)
    V = JaxFunctionSpace(jmac, 1)
    jsys = JaxMacroSystem(V, jnp.float64)
    tsys = MacroSystem(ht.FunctionSpace(port_mesh(jmac)), torch.float64, "cpu")
    rng = np.random.default_rng(9)
    G = rng.standard_normal((jmac.num_cells, 2, 2))
    A_star = np.einsum("cij,ckj->cik", G, G) + np.eye(2)
    f_j, f_t = (lambda x: 1.0 + x[0] * x[1]), (lambda x: 1.0 + x[0] * x[1])
    b_ref = np.asarray(jax_load(jsys.verts64, jsys.cells, f_j))
    b = assemble_load_vector(tsys.verts64, tsys.cells, f_t)
    np.testing.assert_allclose(b.numpy(), b_ref, rtol=1e-13, atol=1e-16)
    dofs = jmac.boundary_vertices()
    jbc = hx.dirichletbc(0.25, dofs, V)
    tbc = ht.dirichletbc(0.25, dofs, tsys.V)
    jmask, jvals = jax_merge_bcs([jbc], V.num_dofs, jnp.float64)
    tmask, tvals = merge_bcs([tbc], V.num_dofs, torch.float64, "cpu")
    jv, jb = jax_assemble(jsys, jnp.asarray(A_star), jnp.asarray(b_ref), jmask, jvals,
                          bs=1, macro_f64=macro_f64)
    tv, tb = assemble_macro_system(tsys, torch.as_tensor(A_star), b, tmask, tvals,
                                   macro_f64=macro_f64)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-13 * np.abs(jv).max())
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-13 * np.abs(jb).max())


def _tiny(**kw):
    return ht.PoissonHMM(
        ht.create_unit_square(4), TORCH_A, 1.0, ht.create_unit_square(4), 0.1, device="cpu",
        **kw
    )


def test_error_probes():
    with pytest.raises(ValueError):
        ht.PoissonHMM(ht.create_unit_square(4), TORCH_A, 1.0, ht.create_unit_cube(2), 0.1,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        _tiny(options_global_solve=ht.SolverOptions(method="cg", pc="mg"))
    with pytest.raises(NotImplementedError, match="A5"):
        _tiny(options_global_solve=ht.SolverOptions(method="cg"))  # pc="auto"
    with pytest.raises(NotImplementedError, match="A7"):
        _tiny(dedup_cells=True)
    # the default method="auto" keeps the direct solve up to 4096 dofs
    h = _tiny()
    assert h._macro_method == "direct"
    assert np.isfinite(h.solve().array.numpy()).all()
