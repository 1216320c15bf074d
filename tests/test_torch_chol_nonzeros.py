"""The chunk-Cholesky route on the operators' nonzeros (CPU).

On the gather assembly route a chunk's cell operators Kc stay as their
nonzeros: the equilibration and the A* contraction run there, and the dense
layout is written once, as the Ks the solver reads.  Held here against the
dense computation it replaced: Ks and the scaling bit for bit, A* to
rounding; the scatter route, which keeps Kc dense, by the same contraction.
Cells: the 4³ elasticity cube (n = 192, 8,640 nonzeros, 45 a row), the 6²
square (n = 72, 14 a row) and the P2 square, whose rows differ in width."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import hommx_tpu_torch as ht
from hommx_tpu_torch.micro import chunk
from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_plain
from hommx_tpu_torch.utils import validation as tval

torch.set_num_threads(1)

C = 5
DTYPES = {"float32": (torch.float32, 1e-5), "float64": (torch.float64, 1e-12)}


def _fibre(a, b):
    da = torch.arccos(torch.cos(2 * torch.pi * (a - 0.5)))
    db = torch.arccos(torch.cos(2 * torch.pi * (b - 0.5)))
    return (da**2 + db**2) < ((2 * torch.pi) ** 2 / 16)


def _mu3(x, y):
    one = torch.ones((), dtype=y.dtype)
    return torch.where(_fibre(y[1], y[2]), 100.0 * (1.0 + 0.001 * x[0]) * one, 0.001 * one)


def _mu2(x, y):
    inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09
    return torch.where(inc, 50.0 * (1.0 + 0.2 * x[0]),
                       0.5 + 0.3 * torch.sin(2 * torch.pi * y[1]))


def _rotation(x):
    g = 0.5 * torch.pi * x[1] / 0.4
    c, s = torch.cos(g), torch.sin(g)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])]).T


ONE = lambda x, y: 1.0  # noqa: E731
CELLS = {
    # name: (mesh, bs, micro_degree, coefficient, G_fn)
    "cube4": (lambda: ht.create_unit_cube(4), 3, 1, tval.hooke_tensor(3, _mu3, ONE), _rotation),
    "square6": (lambda: ht.create_unit_square(6, 6), 2, 1, tval.hooke_tensor(2, _mu2, ONE), None),
    "square3_p2": (lambda: ht.create_unit_square(3, 3), 2, 2, tval.hooke_tensor(2, _mu2, ONE),
                   None),
}


def _setup(monkeypatch, route, cell, dtype=torch.float64):
    """(engine, coefficient, G_fn, centers) with the Kc assembly ``route``."""
    monkeypatch.setenv("HOMMX_KC_ASSEMBLY", route)
    mesh, bs, degree, coeff, G_fn = CELLS[cell]
    eng = ht.MicroEngine(mesh(), bs=bs, coeff_kind="tensor4", dtype=dtype, micro_degree=degree,
                         device="cpu")
    assert eng._chol_route()
    centers = torch.as_tensor(np.random.default_rng(28).uniform(0, 1, (C, mesh().dim)),
                              dtype=dtype)
    return eng, coeff, G_fn, centers


def _dense_kc(eng, system):
    """Kc in the dense layout: the dense operator itself, or the nonzeros
    gathered by the inverse of their positions (each dense entry's
    position among them, an appended zero where it has none)."""
    if system.pattern is None:
        return system.K
    nz, n = chunk._get_kc_gather(eng).nz, eng.n_reduced
    inv = np.full(n * n, nz.size, dtype=np.int64)
    inv[nz] = np.arange(nz.size)
    vals = torch.cat([system.K, system.K.new_zeros(system.K.shape[0], 1)], dim=1)
    return vals.index_select(1, torch.as_tensor(inv)).reshape(-1, n, n)


def _dense_astar(eng, system, Kc, sc, Xs):
    """A* by the bilinear expansion in the unscaled X = S·Xs, F and Kc."""
    X = (Xs * sc[:, None, :]).permute(2, 0, 1)
    F = system.F.permute(2, 0, 1)
    XtF = X.transpose(1, 2) @ F
    XtKX = X.transpose(1, 2) @ (Kc @ X)
    term1 = torch.einsum("rs,crt,tm->csm", eng.E, system.Abar, eng.E)
    return eng._expand_astar((term1 - XtF - XtF.transpose(1, 2) + XtKX) / eng.volume_Y)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", ["gather", "scatter"])
def test_scaled_nonzeros_equal_dense_equilibration(monkeypatch, route, dtype, cell):
    """Ks placed from the scaled operator and the scaling sc are equal, bit
    for bit, to Kc·sc_i·sc_j and sc computed on the dense Kc; A* from the
    scaled quantities (on the gather route from the nonzeros) agrees with
    the dense unscaled bilinear expansion within 1e-12 (float64) or 1e-5
    (float32) of its largest entry."""
    dt, tol = DTYPES[dtype]
    eng, coeff, G_fn, centers = _setup(monkeypatch, route, cell, dt)
    with torch.no_grad():
        system = chunk.chol_system(eng, coeff, centers, G_fn)
        assert (system.pattern is not None) == (route == "gather")
        if route == "gather":
            assert system.K.shape == (C, system.pattern.pos.numel())
            assert (system.pattern.width == 0) == (cell == "square3_p2")
        Kc = _dense_kc(eng, system)
        sc_d = eng._scale_from_diag(torch.diagonal(Kc, dim1=1, dim2=2).T)
        scm = sc_d.T
        Ks_d = Kc * scm[:, :, None] * scm[:, None, :]
        ks, Fs, sc = system.scaled(eng)
        Ks = system.dense(ks)
        assert torch.equal(sc, sc_d)
        assert torch.equal(Ks, Ks_d)
        assert torch.equal(Fs, system.F * sc_d[:, None, :])
        Xs = fused_chol_solve_plain(Ks, Fs)
        got = system.astar(eng, Xs, ks, Fs)
        ref = _dense_astar(eng, system, Kc, sc, Xs)
    assert got.dtype == dt
    assert float((got - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_gather_route_matches_scatter_route(monkeypatch, cell):
    """Whole chunks on both assembly routes, float64: A* within 1e-12."""
    out = {}
    for route in ("scatter", "gather"):
        eng, coeff, G_fn, centers = _setup(monkeypatch, route, cell)
        out[route] = chunk.tensors_chunk_chol(eng, coeff, centers, G_fn)
    ref = out["scatter"]
    assert float((out["gather"] - ref).abs().max() / ref.abs().max()) < 1e-12


def test_row_sums_general_and_uniform_agree(monkeypatch):
    """Kc·X from the nonzeros: the one reduction of equal rows and the
    general fixed-order row sums (``row_plan``) give the dense product."""
    from hommx_tpu_torch.ops.assembly import GatherPlan, invert_scatter

    eng, coeff, G_fn, centers = _setup(monkeypatch, "gather", "cube4")
    system = chunk.chol_system(eng, coeff, centers, G_fn)
    pat = system.pattern
    assert pat.width == 45 and pat.row_plan is None
    general = chunk.KcPattern(**{**pat.__dict__, "width": 0, "row_plan": GatherPlan(
        invert_scatter(pat.rows, pat.n), pat.rows.numel())})
    gen = torch.Generator().manual_seed(1)
    X = torch.randn(C, pat.n, eng.s, dtype=torch.float64, generator=gen)
    ref = _dense_kc(eng, system) @ X
    for each in (pat, general):
        got = each.matmul(system.K, X)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-13


class _DenseCount(TorchDispatchMode):
    """Counts the op outputs of ``numel`` elements that are new tensors (no
    view, no in-place op) while ``active``."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.count, self.active = numel, 0, True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.active and not func.is_view and not func._schema.is_mutable:
            self.count += sum(isinstance(t, torch.Tensor) and t.numel() == self.numel
                              for t in tree_flatten(out)[0])
        return out


@pytest.mark.parametrize("cell", ["cube4", "square6"])
def test_gather_chunk_writes_one_dense_operator(monkeypatch, cell):
    """One tensors_chunk_chol call on the gather route makes exactly one
    tensor of C·n² elements, outside the solver: the Ks it reads."""
    eng, coeff, G_fn, centers = _setup(monkeypatch, "gather", cell, torch.float32)
    n = eng.n_reduced
    chunk.tensors_chunk_chol(eng, coeff, centers, G_fn)  # tables built before counting
    mode = _DenseCount(C * n * n)
    solver = chunk.fused_chol_solve

    def uncounted(K, F):
        assert K.shape == (C, n, n)
        mode.active = False
        try:
            return solver(K, F)
        finally:
            mode.active = True

    monkeypatch.setattr(chunk, "fused_chol_solve", uncounted)
    with torch.no_grad(), mode:
        chunk.tensors_chunk_chol(eng, coeff, centers, G_fn)
    assert mode.count == 1


@pytest.mark.parametrize("cell", ["cube4", "square6"])
@pytest.mark.parametrize("route", ["gather", "scatter"])
def test_identical_chunks_give_bitwise_equal_astar(monkeypatch, route, cell):
    """Two identical float32 chunks give A* and correctors equal bit for
    bit: every sum on the route has a fixed order."""
    eng, coeff, G_fn, centers = _setup(monkeypatch, route, cell, torch.float32)
    a = chunk.tensors_chunk_chol(eng, coeff, centers, G_fn, with_correctors=True)
    b = chunk.tensors_chunk_chol(eng, coeff, centers, G_fn, with_correctors=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_gradient_through_diag_on_both_routes(monkeypatch):
    """d(ΣA*²)/dθ through the chunk on the gather route (the scaling
    differentiated through diag(Kc) on the nonzeros) equals the scatter
    route's within 1e-10 and a central difference within 1e-6."""
    cell = "cube4"

    def loss(route, theta):
        eng, _, G_fn, centers = _setup(monkeypatch, route, cell)

        def mu(x, y):
            return theta * _mu3(x, y)

        coeff = tval.hooke_tensor(3, mu, ONE)
        return (chunk.tensors_chunk_chol(eng, coeff, centers, G_fn) ** 2).sum()

    grads = {}
    for route in ("scatter", "gather"):
        th = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        (grads[route],) = torch.autograd.grad(loss(route, th), th)
    g = float(grads["gather"])
    assert abs(g - float(grads["scatter"])) < 1e-10 * abs(g)
    h = 1e-5
    with torch.no_grad():
        fd = (float(loss("gather", torch.tensor(1.0 + h, dtype=torch.float64)))
              - float(loss("gather", torch.tensor(1.0 - h, dtype=torch.float64)))) / (2 * h)
    assert abs(g - fd) < 1e-6 * abs(g)
