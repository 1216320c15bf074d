"""The port's utilities on the CPU, mirroring tests/test_utils_aux.py and the
JAX package's ``utils``: the checkpoint round trip (and across the two
packages, both ways), the mesh and block-size checks, the debug converters
against the reference's, ``PhaseTimer`` and the ``torch.profiler`` trace,
and plotting: ``plot_solution`` on every model that has it, and the
helpers' ``plot_fem_function`` and ``func_to_png``.  float64 on the CPU;
matplotlib is imported inside the tests that draw."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.utils import debug as jdebug
from hommx_tpu.utils import io as jio
from hommx_tpu_torch.ops.dia import ell_vals_to_dia
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import debug as tdebug
from hommx_tpu_torch.utils import io as tio
from hommx_tpu_torch.utils.profiling import PhaseTimer, trace
from hommx_tpu_torch.utils.validation import hooke_tensor, zero_dirichlet_bcs

torch.set_num_threads(1)


def jax_A(x, y):
    return 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0])


def torch_A(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def _port_hmm(n=8):
    return ht.PoissonHMM(ht.create_unit_square(n), torch_A, 1.0, ht.create_unit_square(6),
                         0.01, device="cpu")


def _jax_hmm(n=8):
    return hx.PoissonHMM(hx.create_unit_square(n), jax_A, lambda x: 1.0,
                         hx.create_unit_square(6), 0.01)


def _no_micro(hmm):
    """Make the micro stage fail if it runs."""
    def fail(*_):
        raise AssertionError("the micro stage ran")

    hmm._micro = fail
    return hmm


# -- checkpoint ---------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    h1 = _port_hmm()
    u1 = h1.solve().array
    path = str(tmp_path / "state.npz")
    tio.save_hmm_state(path, h1)
    with np.load(path) as data:
        assert set(data.files) == {"A_star", "macro_vertices", "macro_cells", "eps", "bs"}
        assert data["A_star"].dtype == np.float64 and data["A_star"].shape == (128, 2, 2)
        assert float(data["eps"]) == 0.01 and int(data["bs"]) == 1
    h2 = _no_micro(_port_hmm())
    tio.load_hmm_state(path, h2)
    assert h2._A_star.dtype == torch.float64 and h2._A_star.device.type == "cpu"
    u2 = h2.solve().array
    assert float((u1 - u2).abs().max()) < 1e-14


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A checkpoint saved by one package loads into the other, whose solve
    (without a micro stage) gives the writer's u within 1e-12."""
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        hj = _jax_hmm()
        u_writer = np.asarray(hj.solve().array)
        jio.save_hmm_state(path, hj)
        h = _no_micro(_port_hmm())
        tio.load_hmm_state(path, h)
        u_reader = h.solve().array.numpy()
    else:
        h = _port_hmm()
        u_writer = h.solve().array.numpy()
        tio.save_hmm_state(path, h)
        hj = _jax_hmm()
        jio.load_hmm_state(path, hj)
        u_reader = np.asarray(hj.solve().array)
    assert np.abs(u_reader - u_writer).max() <= 1e-12 * np.abs(u_writer).max()


@pytest.mark.parametrize("mismatch", ["mesh", "block size"])
def test_checkpoint_mismatch_raises(tmp_path, mismatch):
    h1 = _port_hmm(8)
    path = str(tmp_path / "state.npz")
    tio.save_hmm_state(path, h1)
    if mismatch == "mesh":
        target = _port_hmm(10)
    else:
        with np.load(path) as data:
            fields = dict(data)
        fields["bs"] = np.asarray(2)
        np.savez(path, **fields)
        target = _port_hmm(8)
    with pytest.raises(ValueError, match=mismatch):
        tio.load_hmm_state(path, target)
    assert target._A_star is None


# -- debug converters ---------------------------------------------------------


def test_debug_converters_match_reference():
    """ELL, DIA and vector converters on the 8² system after a solve equal
    the reference's converters on the same arrays, and the ELL and DIA
    matrices are the same matrix."""
    h = _port_hmm()
    u = h.solve()
    vals, cols = h._last_vals_bc, h._sys.cols
    dense = tdebug.ell_matrix_to_numpy(vals, cols)
    assert isinstance(dense, np.ndarray) and dense.shape == (81, 81)
    np.testing.assert_array_equal(dense, jdebug.ell_matrix_to_numpy(
        jnp.asarray(vals.numpy()), jnp.asarray(cols.numpy())))
    np.testing.assert_array_equal(dense, h.matrix_dense())
    dia = h._sys.dia
    dvals = ell_vals_to_dia(dia, vals)
    dense_dia = tdebug.dia_matrix_to_numpy(dvals, dia.offsets)
    np.testing.assert_array_equal(dense_dia, jdebug.dia_matrix_to_numpy(
        dvals.numpy(), list(np.asarray(dia.offsets))))
    np.testing.assert_array_equal(dense_dia, dense)
    vec = tdebug.vector_to_numpy(u)
    np.testing.assert_array_equal(vec, jdebug.vector_to_numpy(jnp.asarray(u.array.numpy())))
    vec[0] += 1.0  # a copy, not a view
    assert float(u.array[0]) != vec[0]
    np.testing.assert_array_equal(tdebug.vector_to_numpy(u.array), u.array.numpy())


# -- profiling ----------------------------------------------------------------


def test_phase_timer_and_trace(tmp_path, monkeypatch):
    """Each phase is a span of its name in the trace file, beside the
    solve's own spans; where CUDA is initialised the timer synchronises the
    device at both edges of a phase (here a stand-in records the calls)."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    timer = PhaseTimer()
    with timer.phase("setup"):
        h = _port_hmm(4)
    assert len(syncs) == 2
    dirname = str(tmp_path / "trace")
    with trace(dirname) as prof, timer.phase("solve"):
        h.solve()
    with timer.phase("setup"):
        pass
    assert len(syncs) == 6
    assert set(timer.totals) == {"setup", "solve"} and all(v > 0 for v in timer.totals.values())
    lines = timer.summary().splitlines()
    assert len(lines) == 2 and lines[0].split()[0] == "solve" and lines[0].endswith("%")
    files = os.listdir(dirname)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(dirname, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names)
    assert {"solve", "hommx.micro", "hommx.macro.assemble", "hommx.macro.solve"} <= names
    assert "setup" not in names  # no profiler ran around the set-up phases
    assert len(prof.key_averages()) > 0


# -- plotting -----------------------------------------------------------------


def _stratified_dt(x):
    z, o = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return torch.stack([torch.stack([o, -0.5 * torch.cos(2 * torch.pi * x[0])]),
                        torch.stack([z, o])])


def _beam_rotation(x):
    c, s = torch.cos(0.5 * x[1]), torch.sin(0.5 * x[1])
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])]).T


def _clamped(h, dim):
    V = h.function_space
    h.set_boundary_conditions(ht.dirichletbc(
        np.zeros(dim), boundary_dofs(V, lambda x: np.isclose(x[0], 0.0)), V))
    return h


def _model(name):
    sq4, cube2 = ht.create_unit_square(4), ht.create_unit_cube(2)
    mu = lambda x, y: 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0])  # noqa: E731
    if name == "PoissonHMM":
        return ht.PoissonHMM(sq4, torch_A, 1.0, sq4, 0.1, device="cpu"), {}
    if name == "PoissonStratifiedHMM":
        return ht.PoissonStratifiedHMM(sq4, torch_A, 1.0, sq4, 0.1, _stratified_dt,
                                       device="cpu"), {}
    box = ht.create_box([[0, 0, 0], [1.0, 0.4, 0.4]], [3, 2, 2])
    f3 = torch.tensor([0.0, 0.0, -0.01], dtype=torch.float64)
    if name == "LinearElasticityHMM":
        h = ht.LinearElasticityHMM(box, hooke_tensor(3, mu, lambda x, y: 1.0), lambda x: f3,
                                   cube2, 0.1, device="cpu")
        return _clamped(h, 3), {"warp": 5.0}
    if name == "LinearElasticityStratifiedHMM":
        h = ht.LinearElasticityStratifiedHMM(box, hooke_tensor(3, mu, lambda x, y: 1.0),
                                             lambda x: f3, cube2, 0.1, _beam_rotation,
                                             device="cpu")
        return _clamped(h, 3), {}
    if name == "PoissonFEM":
        return ht.PoissonFEM(ht.create_unit_cube(3), lambda x: 1.0 + x[0], 1.0,
                             device="cpu"), {}
    per = ht.PoissonPeriodicHMM(sq4, lambda y: 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0]),
                                1.0, sq4, device="cpu")
    per.set_boundary_conditions(zero_dirichlet_bcs(per.function_space))
    return per, {}


MODELS = ["PoissonHMM", "PoissonStratifiedHMM", "LinearElasticityHMM",
          "LinearElasticityStratifiedHMM", "PoissonFEM", "PoissonPeriodicHMM"]


def _png_ok(path) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == b"\x89PNG\r\n\x1a\n" and os.path.getsize(path) > 1000


@pytest.mark.parametrize("backend", ["matplotlib", "raster"])
@pytest.mark.parametrize("name", MODELS)
def test_plot_solution_writes_png(tmp_path, monkeypatch, name, backend):
    """Every model with the reference's ``plot_solution`` draws its solution:
    2D contours, the 3D scalar FEM's mid-plane slices, and the elasticity
    beams' boundary surface (LinearElasticityHMM warped); with matplotlib,
    and with the numpy raster backend (what runs where matplotlib is not
    installed), whose PNG decodes to the image it returns."""
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    from hommx_tpu_torch.utils import plotting

    if backend == "raster":
        monkeypatch.setattr(plotting, "_has_matplotlib", lambda: False)
    h, kw = _model(name)
    h.solve()
    path = tmp_path / f"{name}.png"
    out = h.plot_solution(filename=str(path), title=name, **kw)
    assert _png_ok(path)
    if backend == "matplotlib":
        n_axes = {"PoissonFEM": 4}.get(name, 2)  # the panels and the colorbar
        assert len(out.axes) == n_axes
        plt.close(out)
        return
    assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
    decoded = mpimg.imread(str(path))
    np.testing.assert_array_equal(np.round(decoded * 255).astype(np.uint8), out)
    drawn = (out != 255).any(axis=2)
    assert drawn.mean() > 0.2  # not a blank picture
    assert len({tuple(c) for c in out[drawn][:: max(1, drawn.sum() // 4000)]}) > 8


def test_helpers_plot_fem_function_and_func_to_png(tmp_path):
    import matplotlib.pyplot as plt

    from hommx_tpu_torch import helpers
    from hommx_tpu_torch.utils.plotting import func_to_png, plot_fem_function

    assert helpers.plot_fem_function is plot_fem_function
    V = ht.FunctionSpace(ht.create_unit_square(6), 1)
    u = ht.Function(V, torch.as_tensor(np.sin(np.pi * V.tabulate_dof_coordinates()[:, 0])))
    fig = helpers.plot_fem_function(V, u, filename=str(tmp_path / "u.png"), cmap="magma")
    plt.close(fig)
    assert _png_ok(tmp_path / "u.png")
    fig = func_to_png(str(tmp_path / "laminate"), V, u, title="u")
    plt.close(fig)
    assert _png_ok(tmp_path / "laminate.png")
    fig = func_to_png(str(tmp_path / "unsaved"), V, u, save=False)
    plt.close(fig)
    assert not (tmp_path / "unsaved.png").exists()


def test_plotting_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed, plot_fem_function draws with the
    raster backend; ``show`` then raises."""
    from hommx_tpu_torch.utils import plotting

    monkeypatch.setattr(plotting, "_has_matplotlib", lambda: False)
    V = ht.FunctionSpace(ht.create_unit_square(6), 1)
    u = ht.Function(V, torch.as_tensor(V.tabulate_dof_coordinates()[:, 0]))
    img = plotting.func_to_png(str(tmp_path / "u"), V, u)
    assert isinstance(img, np.ndarray) and _png_ok(tmp_path / "u.png")
    # the 2D picture of u = x runs from viridis' low end to its high end
    np.testing.assert_array_equal(img[10, 0], [68, 1, 84])
    np.testing.assert_array_equal(img[10, 1023], [253, 231, 37])
    with pytest.raises(ImportError):
        plotting.plot_fem_function(V, u, show=True)
