"""The port's spans and K1's per-block iteration counter
(``hommx_tpu_torch/utils/profiling.py::span``,
``micro/stencil_pcg.py::BLOCK_ITERS``): names and nesting of the spans of a
step and of ``solve()`` under ``torch.profiler``, one ``prepare``/``solve``/
``astar`` a chunk, the adjoint solves of a backward pass, no span a user
annotation, nothing recorded without a profiler.  On the card: the logged
counts against ``stencil_pcg_cuda(..., per_block=True)``, each K1 large
kernel after the span that launched it, and the roofline's operation count
against ``chip_smoke.py``'s."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hommx_tpu_torch as ht
from hommx_tpu_torch.micro import stencil_pcg
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import profiling
from hommx_tpu_torch.utils.validation import hooke_tensor

REPO = Path(__file__).resolve().parents[1]
#: each span and the span it opens inside, in a step
PARENT = {"hommx.step": None, "hommx.micro": "hommx.step",
          "hommx.micro.prepare": "hommx.micro", "hommx.micro.solve": "hommx.micro",
          "hommx.micro.astar": "hommx.micro", "hommx.macro.assemble": "hommx.step",
          "hommx.macro.solve": "hommx.step"}
CHUNK = 24


def _poisson(device="cpu", n=8, micro=8):
    """A float32 PoissonHMM on K1's route (its plain version on the CPU)."""
    return ht.PoissonHMM(
        ht.create_unit_square(n), lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0]),
        lambda x: 1.0, ht.create_unit_square(micro), 2**-5, dtype=torch.float32, device=device,
        chunk=CHUNK, dedup_cells=False)


def _beam(device="cpu"):
    """A float32 stratified rotated-fibre beam on the chunk Cholesky route."""
    def mu(x, y):
        one = torch.ones((), dtype=y.dtype, device=y.device)
        fibre = (y[1] - 0.5) ** 2 + (y[2] - 0.5) ** 2 < 0.1
        return torch.where(fibre, 100.0 * one, 0.001 * one)

    def rotation(x):
        g = 0.5 * torch.pi * x[1] / 0.3
        c, s = torch.cos(g), torch.sin(g)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                            torch.stack([-s, z, c])]).T

    f = torch.tensor([0.0, 0.0, -0.008], dtype=torch.float64)
    h = ht.LinearElasticityStratifiedHMM(
        ht.create_box([[0, 0, 0], [1.0, 0.3, 0.1]], [4, 1, 1]),
        hooke_tensor(3, mu, lambda x, y: 1.0), lambda x: f, ht.create_unit_cube(2), 2**-5,
        rotation, dtype=torch.float32, device=device, chunk=CHUNK, dedup_cells=False)
    V = h.function_space
    h.set_boundary_conditions(ht.dirichletbc(
        np.zeros(3), boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V))
    return h


MODELS = {"poisson": _poisson, "beam": _beam}


def _spans(prof):
    """The ``hommx.*`` host events as (name, start, end, parent), the parent
    the innermost ``hommx.*`` event that encloses it."""
    evs = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("hommx.")]
    out = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs),
                 key=lambda t: (t[1], -t[2]))
    rows = []
    for i, (name, s, e) in enumerate(out):
        outer = [o for o in out[:i] if o[1] <= s and e <= o[2]]
        rows.append((name, s, e, min(outer, key=lambda o: o[2] - o[1])[0] if outer else None))
    return rows, evs


def _count(rows, name):
    return sum(r[0] == name for r in rows)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_step_spans_names_and_nesting(model):
    """One ``hommx.step`` a call, each span inside the span the table
    names, one ``prepare``/``solve``/``astar`` a chunk; no span is a user
    annotation (the profiler would mirror it onto the device's timeline)."""
    h = MODELS[model]()
    step, centers = h.build_pipeline()
    chunks = -(-centers.shape[0] // CHUNK)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        step(centers)
        step(centers)
    rows, evs = _spans(prof)
    assert {r[0] for r in rows} == set(PARENT)
    assert all(PARENT[name] == parent for name, _, _, parent in rows)
    assert _count(rows, "hommx.step") == 2
    assert _count(rows, "hommx.micro") == _count(rows, "hommx.macro.assemble") == 2
    assert _count(rows, "hommx.macro.solve") == 2
    for name in ("hommx.micro.prepare", "hommx.micro.solve", "hommx.micro.astar"):
        assert _count(rows, name) == 2 * chunks, name
    assert not any(e.is_user_annotation() for e in evs)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_solve_opens_the_same_spans_but_step(model):
    h = MODELS[model]()
    centers = h._sys.centers
    chunks = -(-centers.shape[0] // CHUNK)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        h.solve()
    rows, _ = _spans(prof)
    assert {r[0] for r in rows} == set(PARENT) - {"hommx.step"}
    assert _count(rows, "hommx.micro") == _count(rows, "hommx.macro.solve") == 1
    for name in ("hommx.micro.prepare", "hommx.micro.solve", "hommx.micro.astar"):
        assert _count(rows, name) == chunks, name
        assert all(r[3] == "hommx.micro" for r in rows if r[0] == name)


def test_backward_opens_the_adjoint_solves():
    """The backward pass's adjoint cell solves and macro solve each open
    their span; nothing else of the table runs there."""
    h = _poisson()
    step, centers = h.build_pipeline()
    chunks = -(-centers.shape[0] // CHUNK)
    centers = centers.clone().requires_grad_(True)
    loss = (step(centers) ** 2).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (g,) = torch.autograd.grad(loss, centers)
    rows, _ = _spans(prof)
    assert torch.isfinite(g).all()
    assert {r[0] for r in rows} == {"hommx.micro.solve", "hommx.macro.solve"}
    assert _count(rows, "hommx.micro.solve") == chunks and _count(rows, "hommx.macro.solve") == 1


def test_nothing_recorded_without_a_profiler():
    """Outside a profiler a span is the shared no-op context and K1's list
    stays empty; inside one, a span is a record of its own."""
    stencil_pcg.BLOCK_ITERS.clear()
    assert profiling.span("hommx.step") is profiling._NO_SPAN
    assert profiling.span("hommx.micro") is profiling._NO_SPAN
    step, centers = _poisson().build_pipeline()
    with torch.no_grad():
        step(centers)
    assert stencil_pcg.BLOCK_ITERS == []
    with profile(activities=[ProfilerActivity.CPU]):
        inside = profiling.span("hommx.step")
    assert inside is not profiling._NO_SPAN


def test_span_without_fast_record_function(monkeypatch):
    """Where torch has no fast record function, every span is the shared
    no-op, even inside a profiler (never ``record_function``)."""
    monkeypatch.setattr(profiling, "_RecordFunctionFast", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("hommx.step") as ctx:
            torch.ones(3).sum()
    assert ctx is None
    assert not any(e.name().startswith("hommx.") for e in prof.profiler.kineto_results.events())


# -- on the card --------------------------------------------------------------


def _roofline():
    path = REPO / "portbench" / "roofline" / "stencil_pcg_large.py"
    spec = importlib.util.spec_from_file_location("stencil_pcg_large_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs only there")


@pytest.mark.cuda
@pytest.mark.parametrize("micro", [16, 64])
def test_k1_logged_counts_equal_per_block(micro):
    """The counts K1 logs under a profiler are those
    ``stencil_pcg_cuda(..., per_block=True)`` returns on the same chunk, the
    small instance (16²) and the large (64²); no entry without a
    profiler."""
    _needs_card()
    from hommx_tpu_torch.micro.chunk import chunk_system

    eng = ht.MicroEngine(ht.create_unit_square(micro), device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(0)
    centers = torch.as_tensor(rng.uniform(0, 1, (37, 2)), dtype=torch.float32, device="cuda")
    cs = chunk_system(eng, lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0]), centers)
    ws_s, Fs = cs.scaled()
    args = (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)
    stencil_pcg.BLOCK_ITERS.clear()
    _, per_block = stencil_pcg.stencil_pcg_cuda(*args, per_block=True)
    assert stencil_pcg.BLOCK_ITERS == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, it_max = stencil_pcg.stencil_pcg_cuda(*args)
    (entry,) = stencil_pcg.BLOCK_ITERS
    stencil_pcg.BLOCK_ITERS.clear()
    cfg = stencil_pcg.launch_config(eng.n_reduced, eng.s, 37)
    large = "hommx_stencil_pcg_large_f32"
    assert entry["launcher"] == (large if cfg.large else "hommx_stencil_pcg_f32")
    assert (entry["n"], entry["s"], entry["K"], entry["cells"], entry["cells_per_block"]) == (
        eng.n_reduced, eng.s, len(cs.st.offsets), 37, cfg.cells_per_block)
    assert torch.equal(entry["iters"], per_block)
    assert int(it_max) == int(per_block.max())


@pytest.mark.cuda
def test_k1_large_kernels_start_inside_their_spans():
    """Each ``stencil_pcg_large_kernel`` starts after the start of the
    ``hommx.micro.solve`` span that launched it: the spans and the device's
    kernels share one clock."""
    _needs_card()
    step, centers = _poisson("cuda", n=4, micro=64).build_pipeline()
    with torch.no_grad():
        step(centers)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(centers)
            torch.cuda.synchronize()
    stencil_pcg.BLOCK_ITERS.clear()
    evs = prof.profiler.kineto_results.events()
    spans = sorted(e.start_ns() for e in evs if e.name() == "hommx.micro.solve")
    kernels = sorted(e.start_ns() for e in evs
                     if "stencil_pcg_large_kernel" in e.name()
                     and e.device_type() == torch.autograd.DeviceType.CUDA)
    assert len(kernels) == len(spans) == -(-centers.shape[0] // CHUNK)
    assert all(k > s for k, s in zip(kernels, spans))


@pytest.mark.cuda
def test_k1_large_roofline_counts_chip_smoke_gflop():
    """The roofline's operation count of one 64² chunk at the kernel's
    per-block counts equals ``chip_smoke.py``'s ``gflop`` of that chunk."""
    _needs_card()
    import chip_smoke

    eng = ht.MicroEngine(ht.create_unit_square(64), device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(1)
    centers = torch.as_tensor(rng.uniform(0, 1, (100, 2)), dtype=torch.float32, device="cuda")
    rec, _ = chip_smoke._k1_case(eng, centers, timed=True)
    iters = [kernel for kernel, *_ in rec["iters_per_block"]]
    ops = _roofline().flops(rec["n"], rec["s"], rec["K"], rec["cells"], rec["cells_per_block"],
                            iters)
    assert rec["large"] and ops == pytest.approx(rec["gflop"] * 1e9, rel=1e-12)
