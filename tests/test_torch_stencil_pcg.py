"""K1 module parity: the plain fused-stencil PCG of the port
(``stencil_pcg_plain``) against the JAX package's Krylov loop
(``_chunk_pcg_raw``, float64) and its Pallas kernel in interpret mode
(``stencil_pcg_pallas``, float32), on raw and on scaling-folded weights,
in 2D and 3D.  Inputs are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.micro.krylov import _chunk_pcg_raw as jax_chunk_pcg_raw
from hommx_tpu.micro.stencil import scale_weights as jax_scale_weights
from hommx_tpu.micro.stencil import stencil_matvec as jax_stencil_matvec
from hommx_tpu.micro.stencil import stencil_weights as jax_stencil_weights
from hommx_tpu.micro.stencil_pcg import stencil_pcg_pallas
from hommx_tpu_torch.micro import stencil_pcg as k1
from hommx_tpu_torch.micro.stencil import scale_weights, stencil_weights
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

MESHES = {"square6": lambda m: m.create_unit_square(6), "cube3": lambda m: m.create_unit_cube(3)}


def _inputs(name, dtype):
    """(jax engine, port engine, a, F, sc2) with a seeded coefficient batch,
    pinned-row-free loads and a positive scaling (1 at pinned rows)."""
    jm = MESHES[name](hx)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    je = JaxEngine(jm, dtype=jdt, solver="pcg")
    te = ht.MicroEngine(port_mesh(jm), dtype=dtype, device="cpu")
    rng = np.random.default_rng(7)
    C, s, n = 5, te.s, te.n_reduced
    a = rng.uniform(0.5, 3.0, (C, te.nE))
    F = rng.standard_normal((n, s, C)) * (~te.pin_np)[:, None, None]
    sc2 = np.where(te.pin_np[:, None], 1.0, rng.uniform(0.5, 2.0, (n, C)))
    return je, te, a, F, sc2


def _both_weights(je, te, a, sc2, scaled, jdt, tdt):
    jst, tst = je._get_stencil(), te._get_stencil()
    jws = jax_stencil_weights(jst, jnp.asarray(a, jdt))
    tws = stencil_weights(tst, torch.as_tensor(a, dtype=tdt))
    if scaled:
        jws = jax_scale_weights(jst, jws, jnp.asarray(sc2, jdt))
        tws = scale_weights(tst, tws, torch.as_tensor(sc2, dtype=tdt))
    return jst, tst, jws, tws


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_plain_f64_matches_jax_loop(name, scaled):
    """float64: same iterates to 1e-10 and the same iteration count."""
    je, te, a, F, sc2 = _inputs(name, torch.float64)
    jst, tst, jws, tws = _both_weights(je, te, a, sc2, scaled, jnp.float64, torch.float64)
    n, s, C = F.shape
    Minv = je._get_K0inv()
    X_ref, it_ref = jax_chunk_pcg_raw(
        lambda P: jax_stencil_matvec(jst, jws, P),
        lambda R: (Minv @ R.reshape(n, -1)).reshape(n, s, C),
        jnp.asarray(F), 1e-11, 200,
    )
    X, it = k1.stencil_pcg_plain(
        tws, torch.as_tensor(F), te._get_K0inv(), tst.shape, tst.offsets, 1e-11, 200
    )
    assert it == int(it_ref)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_ref), rtol=0, atol=1e-10)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_plain_f32_matches_pallas_kernel(name, scaled):
    """float32 against the TPU kernel run by the Pallas interpreter: the
    two sum in different orders, so iterates agree to 5e-5 (the kernel's
    bar in the reference) and the iteration count is the same.  The stop
    tolerance is the engine's float32 default, 1e-5; nearer the float32
    floor (1e-6) the lockstep stop can land one iteration apart."""
    je, te, a, F, sc2 = _inputs(name, torch.float32)
    jst, tst, jws, tws = _both_weights(je, te, a, sc2, scaled, jnp.float32, torch.float32)
    F32 = F.astype(np.float32)
    X_pl, it_pl = stencil_pcg_pallas(
        jws, jnp.asarray(F32), je._get_K0inv().astype(jnp.float32), jst.shape,
        jst.offsets, 1e-5, 200, interpret=True,
    )
    X, it = k1.stencil_pcg(
        tws, torch.as_tensor(F32), te._get_K0inv(), tst.shape, tst.offsets, 1e-5, 200
    )
    assert it == int(it_pl)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_pl), rtol=0, atol=5e-5)


def test_dispatch_is_by_device_and_kernel_module_imports_without_cuda():
    """A CPU tensor goes to the plain version (nothing is built: this host
    has no nvcc and no card); the CUDA entry refuses CPU tensors instead of
    falling back."""
    _, te, a, F, _ = _inputs("square6", torch.float32)
    st = te._get_stencil()
    ws = stencil_weights(st, torch.as_tensor(a, dtype=torch.float32))
    args = (ws, torch.as_tensor(F, dtype=torch.float32), te._get_K0inv(), st.shape, st.offsets, 1e-6, 200)
    X1, it1 = k1.stencil_pcg(*args)
    X2, it2 = k1.stencil_pcg_plain(*args)
    assert it1 == it2 and torch.equal(X1, X2)
    assert k1.KERNEL._lib is None and k1.KERNEL.launches == 0
    with pytest.raises(TypeError):
        k1.stencil_pcg_cuda(*args)


def _chunk(C, seed=11):
    """A float32 square6 chunk of C cells: (args without tol/maxiter)."""
    te = ht.MicroEngine(port_mesh(hx.create_unit_square(6)), dtype=torch.float32, device="cpu")
    st = te._get_stencil()
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 3.0, (C, te.nE))
    F = rng.standard_normal((te.n_reduced, te.s, C)) * (~te.pin_np)[:, None, None]
    ws = stencil_weights(st, torch.as_tensor(a, dtype=torch.float32))
    return ws, torch.as_tensor(F, dtype=torch.float32), te._get_K0inv(), st.shape, st.offsets


def test_plain_block_of_whole_chunk_is_bitwise_unblocked():
    """``block=C`` runs the one lockstep loop of the unblocked version."""
    args = (*_chunk(37), 1e-5, 200)
    X0, it0 = k1.stencil_pcg_plain(*args)
    X1, it1 = k1.stencil_pcg_plain(*args, block=37)
    assert it1 == it0 and torch.equal(X1, X0)


def test_plain_block16_equals_blocks_solved_apart():
    """``block=16`` on 37 cells is the three runs 0:16, 16:32, 32:37 solved
    apart: concatenated iterates, the largest count, and the per-block
    counts with ``per_block``."""
    ws, F, Minv, shape, offsets = _chunk(37)
    X, it = k1.stencil_pcg_plain(ws, F, Minv, shape, offsets, 1e-5, 200, block=16)
    _, its = k1.stencil_pcg_plain(ws, F, Minv, shape, offsets, 1e-5, 200, block=16,
                                  per_block=True)
    parts = [
        k1.stencil_pcg_plain([w[:, a:b] for w in ws], F[:, :, a:b], Minv, shape, offsets,
                             1e-5, 200)
        for a, b in ((0, 16), (16, 32), (32, 37))
    ]
    assert its == [k for _, k in parts] and it == max(its)
    assert torch.equal(X, torch.cat([Xb for Xb, _ in parts], dim=2))


@pytest.mark.parametrize(
    "n, s, K, want",
    [
        # CB 16, 512 threads (64 rows of 8 column groups, 4 rows a thread):
        # R 256·32·4 + P 256·32·4 + 2 slabs 2·256·20·4 + column sums of
        # 16 warps · 8 groups a warp · 2 quantities · 4 columns · 4 B
        (256, 2, 7, (16, 512, 4, 32768 + 32768 + 40960 + 4096)),
        # s·CB = 48 at CB 16 fits no thread count (R + P alone 192 KB); CB 8,
        # 384 threads (64 rows of 6 groups, 8 rows a thread): R 512·24·4 +
        # P 512·24·4 + 2 slabs 2·512·20·4 + 12 warps · 2 groups a warp ·
        # 2 · 4 · 4 B
        (512, 3, 15, (8, 384, 8, 49152 + 49152 + 81920 + 768)),
    ],
)
def test_launch_config_matches_hand_count(n, s, K, want):
    """The main path's (16² torus, K = 7) and the 8³ mesh's (K = 15)
    configuration; K does not enter (weights and neighbours stay in global
    memory).  Shared memory within the H100's 227 KB."""
    cfg = k1.launch_config(n, s)
    got = (cfg.cells_per_block, cfg.threads, cfg.rows_per_thread, cfg.smem_bytes)
    assert got == want
    assert cfg.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("n, s, limit", [(256, 4, "s = 4"), (1000, 3, "shared memory")])
def test_launch_config_raises_above_its_limit(n, s, limit):
    """Four right-hand sides, or R, P and the Minv slabs past 227 KB at the
    narrowest block, raise and name the limit; no other route is taken."""
    with pytest.raises(ValueError, match=limit):
        k1.launch_config(n, s)


def test_neighbour_table_is_the_torus_roll():
    """The kernel's (K, n) neighbour table reproduces roll(P, -Δ_k)."""
    for name in sorted(MESHES):
        te = ht.MicroEngine(port_mesh(MESHES[name](hx)), device="cpu")
        st = te._get_stencil()
        offs = tuple(tuple(int(o) for o in off) for off in st.offsets)
        nbr = k1._neighbour_table(tuple(st.shape), offs, "cpu").long()
        P = torch.arange(te.n_reduced, dtype=torch.float64)
        for k, off in enumerate(offs):
            rolled = torch.roll(
                P.reshape(st.shape), tuple(-o for o in off), tuple(range(len(off)))
            ).reshape(-1)
            assert torch.equal(P[nbr[k]], rolled)


@pytest.mark.parametrize("form", ["dense", "gather"])
@pytest.mark.parametrize("mapped", [False, True])
def test_stencil_weights_and_rhs_match_reference(form, mapped):
    """Stencil weights and generator loads, in the dense-matmul and the
    gather form, unmapped and with a per-cell gradient map (B_K = GᵀG,
    TE = GᵀE), equal the reference's to rounding (float64)."""
    import dataclasses

    from hommx_tpu.micro.stencil import stencil_rhs as jax_stencil_rhs
    from hommx_tpu_torch.micro.stencil import stencil_rhs

    jm = hx.create_unit_square(6)
    je = JaxEngine(jm, dtype=jnp.float64, solver="pcg")
    te = ht.MicroEngine(port_mesh(jm), device="cpu")
    jst, tst = je._get_stencil(), te._get_stencil()
    if form == "gather":  # the form cell meshes above the dense size gate take
        jst = dataclasses.replace(jst, Wd=None, Wsym=None, WF=None)
        tst = dataclasses.replace(tst, Wd=None, Wsym=None, WF=None, _dev={})
    rng = np.random.default_rng(13)
    C = 4
    a = rng.uniform(0.5, 3.0, (C, te.nE))
    G = rng.standard_normal((C, 2, 2)) if mapped else None
    B = None if G is None else np.einsum("cmr,cmt->crt", G, G)
    TE = None if G is None else np.swapaxes(G, 1, 2)  # E = I
    jws = jax_stencil_weights(jst, jnp.asarray(a), None if B is None else jnp.asarray(B))
    tws = stencil_weights(tst, torch.as_tensor(a), None if B is None else torch.as_tensor(B))
    for k in range(len(jws)):
        np.testing.assert_allclose(tws[k].numpy(), np.asarray(jws[k]), rtol=1e-13, atol=1e-13)
    jF = jax_stencil_rhs(jst, jnp.asarray(a), je.E, None if TE is None else jnp.asarray(TE))
    tF = stencil_rhs(tst, torch.as_tensor(a), te.E, None if TE is None else torch.as_tensor(TE))
    np.testing.assert_allclose(tF.numpy(), np.asarray(jF), rtol=1e-13, atol=1e-13)
