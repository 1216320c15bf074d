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


@pytest.mark.parametrize(
    "n, s, limit", [(256, 4, "s = 4"), (4097, 1, "n <= 4096"), (4097, 3, "n <= 4096")]
)
def test_launch_config_raises_above_its_limit(n, s, limit):
    """Four right-hand sides, or more than 4096 unknowns (the 64² square,
    the 16³ cube), raise and name the limit and ROADMAP B7; no other route
    is taken."""
    with pytest.raises(ValueError, match=limit) as err:
        k1.launch_config(n, s)
    assert "B7" in str(err.value) or s == 4


def _warp_cols(cg):
    return next(w for w in (8, 4, 2, 1) if cg % w == 0)


def _hand_smem(n, s, cfg):
    """The shared memory each instance's launcher counts, by hand: the
    small one's R (n padded to 16), P, two Minv slabs of n rows of 20
    floats and the column sums; the large one's ring (a 16 x 128 Minv tile
    and 16 rows of R, tile_cols wide, a stage) and the column sums of 16
    thread rows x 2 quantities x tile_cols."""
    if not cfg.large:
        nc = s * cfg.cells_per_block
        red = (cfg.threads // 32) * _warp_cols(nc // 4) * 8
        return 4 * (-(-n // 16) * 16 * nc + n * nc + 2 * n * 20 + red)
    return 4 * (cfg.stages * 16 * (128 + cfg.tile_cols) + 32 * cfg.tile_cols)


@pytest.mark.parametrize("s", [1, 2, 3])
def test_launch_config_covers_every_cell_up_to_4096(s):
    """Every n from 1 to 4096 has a configuration within the shared memory
    a block may take, counted as the launcher counts it; above the small
    instance's reach the large one, 16 columns a block (12 at s = 3), and
    at every chunk size product tiles of 8 blocks (4 at s = 3), two threads
    a tile column."""
    last_small = {1: 1198, 2: 1024, 3: 896}[s]
    for n in range(1, 4097):
        cfg = k1.launch_config(n, s)
        assert cfg.smem_bytes <= k1.SMEM_LIMIT
        assert cfg.smem_bytes == _hand_smem(n, s, cfg)
        assert cfg.large == (n > last_small)
        if cfg.large:
            nc = s * cfg.cells_per_block
            assert nc == (12 if s == 3 else 16)
            for cells in (1, 37, 442, 2048):
                c = k1.launch_config(n, s, cells)
                assert c.cells_per_block == cfg.cells_per_block
                assert c.tile_cols == (4 * nc if s == 3 else 8 * nc)
                assert c.threads == 2 * c.tile_cols and c.smem_bytes == _hand_smem(n, s, c)


@pytest.mark.parametrize(
    "n, s, want",
    [
        (256, 2, (16, 512, 4, 110592)),  # the main path's 16² torus
        (512, 3, (8, 384, 8, 180992)),  # the 8³ mesh
        (1198, 1, (4, 256, 8, 230304)),  # the small instance's edges
        (1024, 2, (4, 512, 4, 230400)),
        (896, 3, (4, 384, 8, 229760)),
    ],
)
def test_small_instance_configurations_are_kept(n, s, want):
    """Where the small instance had a configuration it keeps it, whatever
    the chunk's size: the same K1Config, the same launch."""
    for cells in (0, 37, 2048):
        cfg = k1.launch_config(n, s, cells)
        assert cfg == k1.K1Config(*want) and not cfg.large


def _state_floats(n, nb, nc, bn):
    """The large instance's state by hand: 16 control words and 2048 flags
    of the grid barrier; R, P, X and 8 product arrays (k pieces) of column
    tiles x n (padded to 16) x bn; the column sums of 128-row product tiles
    and of the passes' 32 segments (2 quantities each); their totals (4),
    fnorm, rz and best rel by parity (5): 9 a column; four counters a block
    slot, one a column tile, one a product tile."""
    bpt = bn // nc
    ct = -(-nb // bpt)
    npad, rt, nct = -(-n // 16) * 16, -(-n // 128), ct * bn
    return (16 + 2048 + 11 * ct * npad * bn + 2 * rt * nct + 64 * nct + 9 * nct
            + 4 * ct * bpt + ct + rt * ct)


@pytest.mark.parametrize(
    "n, s, cells, want",
    [
        # 33²: 209 blocks of 8 cells (16 columns); 128-column tiles (8
        # blocks: 27 column tiles); 256 threads, a ring of 3 x (16 x 128 +
        # 16 x 128) floats and 16 x 2 x 128 column sums; 1 CTA an SM
        # (registers)
        (1089, 2, 1665, (8, 256, 8, 4 * (3 * 16 * 256 + 32 * 128), 3, 128, 132,
                         4 * _state_floats(1089, 209, 16, 128))),
        # 16³: 19 blocks of 4 cells (12 columns); 48-column tiles (4 blocks:
        # 5 column tiles); 96 threads, a ring of 3 x (16 x 128 + 16 x 48);
        # 4 CTAs an SM (registers)
        (4096, 3, 73, (4, 96, 8, 4 * (3 * 16 * 176 + 32 * 48), 3, 48, 528,
                       4 * _state_floats(4096, 19, 12, 48))),
        # 64²: 56 blocks of 8 cells: 7 column tiles
        (4096, 2, 442, (8, 256, 8, 4 * (3 * 16 * 256 + 32 * 128), 3, 128, 132,
                        4 * _state_floats(4096, 56, 16, 128))),
        # 12³: 44 blocks: 11 column tiles
        (1728, 3, 173, (4, 96, 8, 4 * (3 * 16 * 176 + 32 * 48), 3, 48, 528,
                        4 * _state_floats(1728, 44, 12, 48))),
    ],
)
def test_large_launch_config_matches_hand_count(n, s, cells, want):
    assert k1.launch_config(n, s, cells) == k1.K1Config(*want)


@pytest.mark.parametrize(
    "n, s, cells", [(4096, 2, 442), (4096, 3, 73), (1089, 2, 1665), (1728, 3, 173),
                    (4096, 2, 37), (1199, 1, 2048), (2000, 3, 5)]
)
def test_large_schedule_covers_each_block_once(n, s, cells):
    """On the H100's grid and on smaller ones: the product's pieces cover
    every (row, column, k tile) of every block once, in column tiles of
    whole blocks; each CTA's k tiles differ from any other's by at most
    one, a tile's pieces are its CTAs in order and at most 8; the vector
    passes' segments cover every (block, row) once, each CTA's rows differ
    from any other's by at most one, at most 32 a block."""
    cb = {1: 16, 2: 8, 3: 4}[s]
    nc, nb, kt = s * cb, -(-cells // cb), -(-n // 16)
    cfg = k1.launch_config(n, s, cells)
    bn = cfg.tile_cols
    for grid in (cfg.grid, 132, 97):
        product, passes = k1.large_schedule(n, s, cells, cfg, grid)
        load, tiles = {}, {}
        for c, rows, cols, ks, pc in product:
            assert cols[0] % nc == 0 and (cols[1] - cols[0]) % nc == 0  # whole blocks
            load[c] = load.get(c, 0) + ks[1] - ks[0]
            tiles.setdefault((rows, cols), []).append((c, pc, ks))
        want = {((r, min(n, r + 128)), (c, c + bn))
                for r in range(0, n, 128) for c in range(0, nb * nc, bn)}
        assert set(tiles) == want  # every row and block column once
        assert max(load.values()) - min(load.values()) <= 1
        for owners in tiles.values():  # the k tiles end to end, piece by piece
            assert [pc for _, pc, _ in owners] == list(range(len(owners))) and len(owners) <= 8
            edges = [k for _, _, ks in owners for k in ks]
            assert edges[0] == 0 and edges[-1] == kt
            assert all(edges[i] == edges[i + 1] for i in range(1, len(edges) - 1, 2))
        rows, load, segs = np.zeros((-(-nb * nc // bn) * bn // nc, n), dtype=np.int64), {}, {}
        for c, b, (r0, r1), pc in passes:
            rows[b, r0:r1] += 1
            load[c] = load.get(c, 0) + r1 - r0
            segs.setdefault(b, []).append(pc)
        assert (rows == 1).all() and max(load.values()) - min(load.values()) <= 1
        assert all(pcs == list(range(len(pcs))) and len(pcs) <= 32 for pcs in segs.values())


def test_tiled_minv_layout():
    """The large instance's Minv: [row tile][k tile][k][row] with tiles of
    128 rows and 16 columns, zero past n."""
    import itertools

    n = 1100
    M = torch.as_tensor(np.random.default_rng(5).standard_normal((n, n)))
    Mt = k1._tiled(M)
    assert Mt.shape == (-(-n // 128), -(-n // 16), 16, 128)
    for rt, kt, kk, r in itertools.product(
        range(Mt.shape[0]), (0, 7, Mt.shape[1] - 1), range(16), (0, 13, 127)
    ):
        row, col = rt * 128 + r, kt * 16 + kk
        assert Mt[rt, kt, kk, r] == (M[row, col] if row < n and col < n else 0.0)


def test_plain_large_block_on_33x33_chunk():
    """The large instance's block size on a 33² chunk (n = 1089, 8 cells a
    block): the plain version is ``_chunk_pcg_raw`` run on each block
    alone, bitwise, and its A* lies within 5e-5 of the unblocked loop's."""
    from hommx_tpu_torch.micro.chunk import chunk_system
    from hommx_tpu_torch.micro.krylov import _chunk_pcg_raw, shared_prec
    from hommx_tpu_torch.micro.stencil import torus_matvec

    te = ht.MicroEngine(ht.create_unit_square(33, 33), device="cpu", solver="pcg")
    block = k1.launch_config(te.n_reduced, te.s).cells_per_block
    assert te.n_reduced == 1089 and block == 8
    A = lambda x, y: 1.5 + x[0] + torch.sin(2 * torch.pi * y[0]) * torch.cos(2 * torch.pi * y[1])
    centers = torch.as_tensor(np.random.default_rng(21).uniform(0, 1, (12, 2)))
    cs = chunk_system(te, A, centers)
    ws, F = cs.scaled()
    st, tol, maxiter = cs.st, te.pcg_tol, te.pcg_maxiter
    X, its = k1.stencil_pcg_plain(ws, F, cs.Minv, st.shape, st.offsets, tol, maxiter,
                                  block=block, per_block=True)
    for b, a in enumerate(range(0, 12, block)):
        cols = slice(a, min(a + block, 12))
        wb = [w[:, cols] for w in ws]
        Xb, kb = _chunk_pcg_raw(lambda P: torus_matvec(st.shape, st.offsets, wb, P),
                                lambda R: shared_prec(cs.Minv, R), F[:, :, cols], tol, maxiter)
        assert kb == its[b] and torch.equal(Xb, X[:, :, cols])
    X1, it1 = k1.stencil_pcg_plain(ws, F, cs.Minv, st.shape, st.offsets, tol, maxiter)
    A_blocked, A_whole = cs.astar(te, X, max(its)), cs.astar(te, X1, it1)
    assert float((A_blocked - A_whole).abs().max() / A_whole.abs().max()) < 5e-5


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
