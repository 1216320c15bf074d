"""The micro chunk loops make no host-device sync in steady state: the Voigt
index of ``MicroEngine._expand_astar`` / ``_expand_cols`` lives on the
device, one copy a device; the scalar stencil's pinned rows are filled by a
scalar argument; ``hooke_tensor`` keeps a Python-number Lamé value on the
host.  Each does the same arithmetic bit for bit.  On the card: every chunk
route that the benchmark's cells run, after one warm call, under
``torch.cuda.set_sync_debug_mode("error")``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import hommx_tpu_torch as ht
from hommx_tpu_torch.micro import engine as engine_mod
from hommx_tpu_torch.micro.stencil import stencil_weights
from hommx_tpu_torch.utils.validation import hooke_tensor


def _elastic(d):
    mesh = ht.create_unit_square(2) if d == 2 else ht.create_unit_cube(1)
    return ht.MicroEngine(mesh, bs=d, coeff_kind="tensor4", device="cpu")


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_expand_equals_numpy_index(d, lead):
    """Bit for bit the indexing by the host's numpy index."""
    eng = _elastic(d)
    g = torch.Generator().manual_seed(d)
    e = torch.from_numpy(eng.sym_expand)
    A = torch.randn(*lead, eng.s, eng.s, generator=g, dtype=torch.float64)
    X = torch.randn(*lead, eng.s, generator=g, dtype=torch.float64)
    out = eng._expand_astar(A)
    assert out.shape == (*lead, d * d, d * d)
    assert torch.equal(out, A[..., e[:, None], e[None, :]])
    assert torch.equal(eng._expand_cols(X), X[..., e])


def test_index_built_once_per_device(monkeypatch):
    """Each device gets the index at its first use, on that device, and no
    later call makes another."""
    eng = _elastic(3)
    made = []
    real = torch.as_tensor

    def counting(*args, **kwargs):
        made.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_mod.torch, "as_tensor", counting)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    A = torch.ones(4, eng.s, eng.s, dtype=torch.float64)
    for _ in range(3):
        eng._expand_astar(A)
        eng._expand_cols(A[:, 0])
    assert made == [cpu]
    assert eng._sym_index(cpu).device == eng.device
    for _ in range(3):
        assert eng._expand_astar(A.to(meta)).device == meta
        eng._expand_cols(A[:, 0].to(meta))
    assert made == [cpu, meta]
    assert eng._sym_index(meta).device == meta
    assert eng._sym_index(cpu) is eng._sym_index(cpu)


def test_scalar_engine_returns_input():
    eng = ht.MicroEngine(ht.create_unit_square(2), device="cpu")
    assert eng.sym_expand is None and eng._sym_expand_dev == {}
    A, X = torch.ones(3, 2, 2), torch.ones(3, 2)
    assert eng._expand_astar(A) is A
    assert eng._expand_cols(X) is X


def test_stencil_pinned_rows_filled():
    """The self weight's pinned rows read 1.0 and every other entry is the
    unpinned product's, as the index assignment gave."""
    eng = ht.MicroEngine(ht.create_unit_square(4), device="cpu", solver="pcg")
    st = eng._get_stencil()
    g = torch.Generator().manual_seed(3)
    a = 0.5 + torch.rand(6, eng.nE, generator=g, dtype=torch.float64)
    ws = stencil_weights(st, a)
    pinned = st.pinned
    st.pinned = pinned[:0]
    try:
        raw = stencil_weights(st, a)
    finally:
        st.pinned = pinned
    assert pinned.size == 1
    want = raw[st.self_k].clone()
    want[torch.as_tensor(st.pinned), :] = 1.0
    assert torch.equal(ws[st.self_k], want)
    assert all(torch.equal(w, r) for k, (w, r) in enumerate(zip(ws, raw)) if k != st.self_k)


@pytest.mark.parametrize("mu, lam", [(100.0, 1.0), (3, 0.25), (np.float32(2.5), 1.0)])
def test_hooke_number_stays_on_host(mu, lam):
    """A Python number enters as a 0-d host tensor (no copy to the point's
    device) and gives the tensor its device copy gave."""
    H = hooke_tensor(3, lambda x, y: mu, lambda x, y: lam)
    y = torch.full((3,), 0.25, dtype=torch.float64)
    assert H(y, y.to("meta")).device == torch.device("meta")
    dt = torch.float64
    I = torch.eye(3, dtype=dt)
    want = torch.as_tensor(lam).to(dt) * torch.einsum("ij,kl->ijkl", I, I) + torch.as_tensor(
        mu).to(dt) * (torch.einsum("ik,jl->ijkl", I, I) + torch.einsum("il,jk->ijkl", I, I))
    assert torch.equal(H(y, y), want)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync check reads the card's stream")


def _mu(x, y):
    one = torch.ones((), dtype=y.dtype, device=y.device)
    fibre = (y[1] - 0.5) ** 2 + (y[2] - 0.5) ** 2 < 0.0625
    return torch.where(fibre, 100.0 * (1.0 + 0.001 * x[0]) * one, 0.001 * one)


def _rotation(x):
    g = 0.5 * torch.pi * x[1] / 0.4
    c, s = torch.cos(g), torch.sin(g)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])]).T


#: engine cases: (mesh, bs, cells, chunk, batched), each at least 3 chunks
CASES = {
    "elasticity_4cube_k3_small": (lambda: ht.create_unit_cube(4), 3, 30, 10, False),
    "elasticity_4cube_k3_batched": (lambda: ht.create_unit_cube(4), 3, 30, 10, True),
    "elasticity_8cube_k3_large": (lambda: ht.create_unit_cube(8), 3, 9, 3, False),
    "poisson_64square_k1_large": (lambda: ht.create_unit_square(64), 1, 60, 20, False),
    "poisson_16square_k1_small": (lambda: ht.create_unit_square(16), 1, 60, 20, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_chunk_loop_makes_no_sync_on_card(case, monkeypatch):
    """After one warm call (the lazy tables built), ``tensors_for_centers``
    over 3 chunks or more makes no synchronising CUDA call, and its A*
    equals the warm call's bit for bit."""
    _needs_card()
    mesh, bs, cells, chunk, batched = CASES[case]
    if batched:
        monkeypatch.setenv("HOMMX_CHOL_SOLVE_BATCH", "1")
    dev = torch.device("cuda", 0)
    if bs == 1:
        eng = ht.MicroEngine(mesh(), device=dev, dtype=torch.float32)
        coeff, G_fn = (lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])), None
        assert eng._k1_route()
    else:
        eng = ht.MicroEngine(mesh(), bs=3, coeff_kind="tensor4", device=dev, dtype=torch.float32)
        coeff, G_fn = hooke_tensor(3, _mu, lambda x, y: 1.0), _rotation
        assert eng._chol_route()
    rng = np.random.default_rng(11)
    centers = torch.as_tensor(rng.uniform(0, 1, (cells, eng.d)), dtype=torch.float32,
                              device=dev)
    with torch.no_grad():
        warm = eng.tensors_for_centers(coeff, centers, G_fn, chunk=chunk)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            A = eng.tensors_for_centers(coeff, centers, G_fn, chunk=chunk)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(A, warm)
