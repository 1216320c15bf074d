"""The PETSc-style options through the port: ``SolverOptions.from_any`` on
dicts and ``cell_problem_engine_kwargs`` against the JAX package over one
table of inputs, the HMM constructor's ``options_cell_problem`` and
``petsc_options_*`` aliases, and the routes the port lacks."""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.utils import options as jopt
from hommx_tpu_torch.utils import options as topt
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

JAX_A = lambda x, y: 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0])
TORCH_A = lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])

DICTS = [
    {},
    {"ksp_atol": 1e-9},
    {"ksp_rtol": 1e-7},
    {"ksp_atol": 1e-9, "ksp_rtol": 1e-6},
    {"ksp_max_it": 250},
    {"ksp_type": "preonly", "pc_type": "lu"},
    {"ksp_type": "cg", "pc_type": "gamg", "ksp_rtol": 1e-8},
    {"ksp_type": "gmres", "pc_type": "hypre"},
    {"ksp_type": "cg", "pc_type": "jacobi"},
    {"pc_type": "mg", "ksp_max_it": 40},
    {"pc_type": "none"},
    {"pc_type": "ilu"},
    {"pc_factor_mat_solver_type": "mumps"},
    {"ksp_monitor": None, "ksp_rtol": 1e-5},
]


def _messages(caplog):
    return [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("d", DICTS, ids=[repr(d) for d in DICTS])
def test_petsc_dict_translation_matches_reference(d, caplog):
    """The same dict gives the same SolverOptions (over a default too), the
    same engine kwargs, and the same log messages in both packages."""
    caplog.set_level(logging.INFO)
    ref_opts = jopt.SolverOptions.from_any(dict(d))
    ref_base = jopt.SolverOptions.from_any(dict(d), jopt.SolverOptions(rtol=1e-5, maxiter=7))
    ref_kw = jopt.cell_problem_engine_kwargs(dict(d))
    ref_log = _messages(caplog)
    caplog.clear()
    opts = topt.SolverOptions.from_any(dict(d))
    base = topt.SolverOptions.from_any(dict(d), topt.SolverOptions(rtol=1e-5, maxiter=7))
    kw = topt.cell_problem_engine_kwargs(dict(d))
    assert dataclasses.asdict(opts) == dataclasses.asdict(ref_opts)
    assert dataclasses.asdict(base) == dataclasses.asdict(ref_base)
    assert kw == ref_kw
    assert _messages(caplog) == ref_log


@pytest.mark.parametrize(
    "fields",
    [{}, {"rtol": 1e-7}, {"atol": 1e-9}, {"maxiter": 99}, {"method": "direct"},
     {"method": "cg", "rtol": 1e-6, "atol": 1e-3}],
)
def test_solver_options_engine_kwargs_match_reference(fields):
    assert topt.cell_problem_engine_kwargs(topt.SolverOptions(**fields)) == \
        jopt.cell_problem_engine_kwargs(jopt.SolverOptions(**fields))


def test_ksp_atol_warns_and_rtol_wins(caplog):
    caplog.set_level(logging.WARNING)
    assert topt.cell_problem_engine_kwargs({"ksp_atol": 1e-9}) == {"pcg_tol": 1e-9}
    assert any("approximated" in m for m in _messages(caplog))
    caplog.clear()
    assert topt.cell_problem_engine_kwargs({"ksp_atol": 1e-9, "ksp_rtol": 1e-6}) == {
        "pcg_tol": 1e-6}
    assert not any("approximated" in m for m in _messages(caplog))
    with pytest.raises(TypeError):
        topt.cell_problem_engine_kwargs(1e-9)


@pytest.mark.parametrize(
    "kw",
    [
        {"options_cell_problem": {"ksp_atol": 1e-9}},
        {"petsc_options_cell_problem": {"ksp_rtol": 1e-10, "ksp_max_it": 500},
         "petsc_options_global_solve": {"ksp_type": "cg", "pc_type": "jacobi",
                                        "ksp_rtol": 1e-9},
         "petsc_options_prefix": "hmm_"},
        {"options_global_solve": {"ksp_type": "preonly"},
         "options_cell_problem": hx.SolverOptions(rtol=1e-9, maxiter=300)},
    ],
    ids=["flagship_example", "aliases", "solver_options"],
)
def test_hmm_takes_the_reference_engine_settings(kw):
    """An HMM built from the same options gets the reference's engine
    tolerance and iteration cap and its macro SolverOptions."""
    tkw = {k: (topt.SolverOptions(**dataclasses.asdict(v))
               if isinstance(v, jopt.SolverOptions) else v) for k, v in kw.items()}
    jkw = dict(kw, engine_kwargs={"solver": "pcg"})
    hj = hx.PoissonHMM(hx.create_unit_square(4), JAX_A, lambda x: 1.0,
                       hx.create_unit_square(4), 0.1, **jkw)
    h = ht.PoissonHMM(port_mesh(hx.create_unit_square(4)), TORCH_A, 1.0,
                      port_mesh(hx.create_unit_square(4)), 0.1, device="cpu", **tkw)
    assert h._engine.pcg_tol == hj._engine.pcg_tol
    assert h._engine.pcg_maxiter == hj._engine.pcg_maxiter
    assert dataclasses.asdict(h._options_global) == dataclasses.asdict(hj._options_global)
    assert dataclasses.asdict(h._options_cell) == dataclasses.asdict(hj._options_cell)
    assert h._macro_method == hj._macro_method


def test_engine_kwargs_win_over_cell_options():
    h = ht.PoissonHMM(ht.create_unit_square(4), TORCH_A, 1.0, ht.create_unit_square(4), 0.1,
                      options_cell_problem={"ksp_rtol": 1e-6}, engine_kwargs={"pcg_tol": 1e-8},
                      device="cpu")
    assert h._engine.pcg_tol == 1e-8


@pytest.mark.parametrize("opts", [{"ksp_type": "preonly"}, {"pc_type": "lu"},
                                  {"pc_factor_mat_solver_type": "mumps"}])
def test_scalar_direct_cell_options_raise_naming_a9(opts):
    """A scalar problem mapped onto the direct cell solve takes the
    reference's per-cell Cholesky route (it raised naming A9 before that
    route was ported): the engine's solver and u are the reference's
    (1e-10)."""
    h = ht.PoissonHMM(port_mesh(hx.create_unit_square(4)), TORCH_A, 1.0,
                      port_mesh(hx.create_unit_square(4)), 0.1, options_cell_problem=opts,
                      dtype=torch.float32, device="cpu")
    hj = hx.PoissonHMM(hx.create_unit_square(4), JAX_A, lambda x: 1.0,
                       hx.create_unit_square(4), 0.1, options_cell_problem=opts)
    assert h._engine.solver == hj._engine.solver == "cholesky"
    h64 = ht.PoissonHMM(port_mesh(hx.create_unit_square(4)), TORCH_A, 1.0,
                        port_mesh(hx.create_unit_square(4)), 0.1, options_cell_problem=opts,
                        device="cpu")
    u, u_ref = h64.solve().array.numpy(), np.asarray(hj.solve().array)
    assert np.abs(u - u_ref).max() <= 1e-10 * np.abs(u_ref).max()