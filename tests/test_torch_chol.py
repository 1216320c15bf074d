"""K3's plain version and the blocked Cholesky under it: the port's
``fused_chol_solve_plain`` and ``blocked_solve_spd`` against the JAX
package's (the Pallas kernel in interpret mode, rolled body) and against
numpy in float64, the clamped pivots on an indefinite cell, and the
wrapper's dispatch by device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu_torch as ht
from hommx_tpu.ops.batched_chol import blocked_solve_spd as jax_blocked_solve_spd
from hommx_tpu.ops.chol_kernel import fused_chol_solve as jax_fused_chol_solve
from hommx_tpu_torch.ops import chol_kernel as k3
from hommx_tpu_torch.ops.batched_chol import blocked_solve_spd

torch.set_num_threads(1)


def _spd_batch(C, n, s, seed=0):
    """(K (C, n, n), F (C, n, s)) in float64: well-conditioned SPD cells."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((C, n, n))
    K = np.einsum("cij,ckj->cik", A, A) + n * np.eye(n)[None]
    return K, rng.standard_normal((C, n, s))


def _cell_minor(F):
    return np.moveaxis(F, 0, -1)  # (C, n, s) -> (n, s, C)


@pytest.mark.parametrize("C,n,s", [(5, 40, 3), (9, 33, 2), (4, 81, 6)])
def test_plain_f32_matches_jax_kernel(C, n, s):
    """float32, the JAX fused kernel in interpret mode: within 5e-6
    relative (the same algorithm in another summation order).  (4, 81, 6)
    is the CUDA kernel's shape class: the beam's s and padding across
    three panels."""
    K, F = _spd_batch(C, n, s)
    K32, F32 = K.astype(np.float32), _cell_minor(F).astype(np.float32)
    X_ref = np.asarray(jax_fused_chol_solve(jnp.asarray(K32), jnp.asarray(F32), body="rolled"))
    X = k3.fused_chol_solve_plain(torch.as_tensor(K32), torch.as_tensor(F32))
    assert X.shape == (n, s, C) and X.dtype == torch.float32
    err = np.abs(X.numpy() - X_ref).max() / np.abs(X_ref).max()
    assert err < 5e-6, err


@pytest.mark.parametrize("C,n,s", [(5, 40, 3), (9, 33, 2)])
def test_plain_f64_matches_numpy_solve(C, n, s):
    K, F = _spd_batch(C, n, s, seed=1)
    X = k3.fused_chol_solve_plain(torch.as_tensor(K), torch.as_tensor(_cell_minor(F)))
    X_ref = _cell_minor(np.linalg.solve(K, F))
    assert np.abs(X.numpy() - X_ref).max() / np.abs(X_ref).max() < 1e-12


def test_plain_indefinite_cell_is_finite():
    """A cell with a negative pivot: clamped pivots √max(p, 1e-30) give
    finite output and no exception; the other cells are untouched."""
    K, F = _spd_batch(4, 40, 3, seed=2)
    K[2, -1, -1] = -K[2, -1, -1]
    X = k3.fused_chol_solve_plain(torch.as_tensor(K), torch.as_tensor(_cell_minor(F))).numpy()
    assert np.isfinite(X).all()
    ok = [0, 1, 3]
    X_ref = _cell_minor(np.linalg.solve(K[ok], F[ok]))
    assert np.abs(X[:, :, ok] - X_ref).max() / np.abs(X_ref).max() < 1e-12


@pytest.mark.parametrize("n", [64, 81])
def test_blocked_solve_spd_matches_jax(n):
    """The blocked factor+solve (with padding at n = 81) in float32 against
    the JAX package's, within 5e-6 relative."""
    K, F = _spd_batch(6, n, 4, seed=3)
    K32, F32 = K.astype(np.float32), F.astype(np.float32)
    X_ref = np.asarray(jax_blocked_solve_spd(jnp.asarray(K32), jnp.asarray(F32), nb=32))
    X = blocked_solve_spd(torch.as_tensor(K32), torch.as_tensor(F32), nb=32).numpy()
    assert np.abs(X - X_ref).max() / np.abs(X_ref).max() < 5e-6


def test_dispatch_is_by_device():
    """A CPU tensor goes to the plain version without building the kernel;
    the CUDA entry refuses CPU tensors instead of falling back."""
    K, F = _spd_batch(3, 20, 2, seed=4)
    Kt, Ft = torch.as_tensor(K, dtype=torch.float32), torch.as_tensor(_cell_minor(F), dtype=torch.float32)
    assert torch.equal(k3.fused_chol_solve(Kt, Ft), k3.fused_chol_solve_plain(Kt, Ft))
    assert k3.KERNEL._lib is None and k3.KERNEL.launches == 0
    with pytest.raises(TypeError):
        k3.fused_chol_solve_cuda(Kt, Ft)


def test_kernel_size_limit():
    """The small instance holds a cell's lower 32 x 32 tiles (P(P+1)/2 of
    them, P = ceil(n/32)) and two (32 P, s) right-hand-side arrays in shared
    memory: at n = 192, s = 6, 21 tiles and 2 x 192 x 6 floats.  9 panels
    (n = 288) fit the 232,448 bytes a block may take, 10 do not; there the
    large instance takes over with the same bytes as its global workspace.
    The engine's host-side guard admits every n (n = 375 and 1536 at s = 6
    run the large instance, by outer panels of 4 tile columns in 27 tiles
    of shared memory) and refuses only s outside 1..8, naming the range,
    before any device work."""
    assert k3.kernel_smem_bytes(192, 6) == 4 * (21 * 32 * 32 + 2 * 192 * 6) == 95232
    assert k3.max_small_n(6) == 288
    assert k3.kernel_smem_bytes(288, 6) == 4 * (45 * 1024 + 2 * 288 * 6) == 198144 <= 232448
    assert k3.kernel_smem_bytes(289, 6) == 4 * (55 * 1024 + 2 * 320 * 6) == 240640 > 232448
    assert k3.chol_launch_config(289, 6).workspace_bytes == 240640
    for n in (375, 1536):
        cfg = k3.check_k3_fits(n, 6)
        assert cfg.large and cfg.panels == -(-n // 32) and cfg.outer == 4
        assert cfg.workspace_bytes == k3.kernel_smem_bytes(n, 6)
        assert cfg.smem_bytes == 4 * (10 + 4 * 4 + 1) * 1024
    assert not k3.check_k3_fits(288, 6).large and k3.check_k3_fits(288, 6).outer == 0
    with pytest.raises(NotImplementedError, match="takes 1 to 8 right-hand sides"):
        k3.check_k3_fits(375, 9)


@pytest.mark.parametrize(
    "n,s,panels,smem,blocks",
    [
        # 21 tiles + 2 x 192 x 6 floats; two blocks: 2 x (95,232 + 1,024) <= 233,472
        (192, 6, 6, 4 * (21 * 1024 + 2 * 192 * 6), 2),
        # n = 81 pads to 96: 6 tiles + 2 x 96 x 6 floats
        (81, 6, 3, 4 * (6 * 1024 + 2 * 96 * 6), 2),
        # the 2D 4x4 square: one tile + 2 x 32 x 3 floats
        (32, 3, 1, 4 * (1024 + 2 * 32 * 3), 2),
        # the limit: 45 tiles + 2 x 288 x 6 floats, one block an SM
        (288, 6, 9, 4 * (45 * 1024 + 2 * 288 * 6), 1),
    ],
)
def test_chol_launch_config_hand_counts(n, s, panels, smem, blocks):
    cfg = k3.chol_launch_config(n, s)
    assert cfg == k3.K3Config(threads=256, panels=panels, tile_stride=32, smem_bytes=smem,
                              blocks_per_sm=blocks)
    assert cfg.smem_bytes == k3.kernel_smem_bytes(n, s)


def test_chol_launch_config_raises_above_limit():
    """The switch: n = 288 is the small instance's last size at s = 6, n =
    289 the large instance's first (10 panels, 55 tiles in its workspace).
    s outside 1..8 still raises ValueError naming the range; the CUDA
    wrapper refuses such shapes before it builds anything."""
    assert not k3.chol_launch_config(288, 6).large
    cfg = k3.chol_launch_config(289, 6)
    assert cfg.large and cfg.panels == 10
    assert cfg.workspace_bytes == 4 * (55 * 1024 + 2 * 320 * 6)
    with pytest.raises(ValueError, match="takes 1 to 8"):
        k3.chol_launch_config(32, 9)
    with pytest.raises(ValueError, match="takes 1 to 8"):
        k3.chol_launch_config(3000, 9)


@pytest.mark.parametrize(
    "n,s,cells,panels,tiles,cluster,apart",
    [
        # the 13² square (1440-cell chunk): 11 panels; 1440 = 5 x 264 + 120,
        # a last wave of 120 cells fits 264 slots at 2 CTAs a cell: 660
        # clusters of 2 solve 1320 cells a CTA each, the last 120 cells take
        # two CTAs each
        (338, 3, 1440, 11, 66, 2, 660),
        # the 5³ cube (720-cell chunk): 720 = 2 x 264 + 192 > 132, one CTA a cell
        (375, 6, 720, 12, 78, 1, 0),
        # the 16² square (720-cell chunk)
        (512, 3, 720, 16, 136, 1, 0),
        # the 6³ cube: 309 = 264 + 45 cells: 132 clusters of 2 solve 264
        # cells a CTA each, then 45 cells on two CTAs each
        (648, 6, 309, 21, 231, 2, 132),
        # the 8³ cube: 76 cells, two CTAs a cell give 152 >= 132
        (1536, 6, 76, 48, 1176, 2, 0),
        # one 8³ cell (high_res_micro's sequence): a cluster of 8
        (1536, 6, 1, 48, 1176, 8, 0),
        # n = 3000: 94 panels, 24 outer panels (the last 2 tile columns
        # wide); 40 cells, four CTAs a cell give 160
        (3000, 6, 40, 94, 4465, 4, 0),
    ],
)
def test_large_launch_config_hand_counts(n, s, cells, panels, tiles, cluster, apart):
    """The large instance: 256 threads, P = ceil(n/32) panels, P(P+1)/2
    packed tiles of 4 KB and two (32 P, s) arrays of global workspace a
    cell, outer panels of 4 tile columns, and 27 tiles of shared memory
    (110,592 B) at every n: the strip's lower diagonal block (4 x 5 / 2 =
    10 tiles), a group of 4 rows of 4 tiles (16) and its part of the first
    forward substitution (4 x 8 x 32 floats: 1); the trailing update's
    operands (4 x 4 tiles of B, 2 x 4 of A: 24) and the substitutions'
    staging (1 + 16 + 6.5) fit in them.  So two CTAs an SM (2 x (110,592 +
    1,024) <= 233,472): 264 slots.  Below 132 cells, the fewest CTAs a cell
    (1, 2, 4, 8) that give each of the 132 SMs one; above a full wave whose
    last wave fits the slots at two CTAs a cell, clusters of 2, a cell a CTA
    in the full waves (``apart`` clusters) and one cell a cluster in the
    last."""
    cfg = k3.chol_launch_config(n, s, cells)
    assert panels * (panels + 1) // 2 == tiles
    assert cfg == k3.K3Config(threads=256, panels=panels, tile_stride=32,
                              smem_bytes=(10 + 4 * 4 + 1) * 32 * 32 * 4, blocks_per_sm=2,
                              cluster=cluster,
                              workspace_bytes=4 * (tiles * 1024 + 2 * 32 * panels * s), outer=4,
                              apart=apart)
    assert cfg.smem_bytes == 110_592 and cfg.large
    last = cells - apart * cluster  # cells a cluster each
    assert apart * cluster + last * cluster >= min(cells, 132)  # CTAs launched
    assert last * cluster <= 264 or apart == 0
    assert (k3.chol_launch_config(n, s).cluster, k3.chol_launch_config(n, s).apart) == (1, 0)


@pytest.mark.parametrize(
    "n,panel_tiles,tiles",
    [
        # the 6³ cube: P = 21; the trailing parts m = 17, 13, 9, 5, 1 after the
        # outer panels at 0, 4, 8, 12, 16: 153 + 91 + 45 + 15 + 1 = 305, and
        # 231 strip tiles
        (648, 1540, 305 + 231),
        # the 8³ cube: P = 48; m = 44, 40, ..., 4: sum of m(m+1)/2 = 4180, and
        # 1176 strip tiles
        (1536, 18424, 4180 + 1176),
        # the 16² square: P = 16; m = 12, 8, 4: 78 + 36 + 10 = 124, and 136
        (512, 680, 124 + 136),
        # the 5³ cube: P = 12; m = 8, 4: 36 + 10 = 46, and 78
        (375, 286, 46 + 78),
    ],
)
def test_workspace_traffic_hand_counts(n, panel_tiles, tiles):
    """The large instance's workspace traffic: each lower tile read and
    written once in its outer panel's strip, and each tile right of a
    strip once in that strip's trailing update, 8 KB a time, per cell.
    The design before it read and wrote every trailing tile once a 32-wide
    panel: sum over p of (P - 1 - p)(P - p)/2 tiles.  The outer panels of
    4 tile columns cut it at least 2.3x at each shape and 2.8x at the 6³
    cube."""
    P = -(-n // 32)
    assert sum((P - 1 - p) * (P - p) // 2 for p in range(P)) == panel_tiles
    assert k3.workspace_traffic_bytes(n, 1) == tiles * 8192
    assert k3.workspace_traffic_bytes(n, 309) == 309 * tiles * 8192
    assert panel_tiles / tiles >= (2.8 if n == 648 else 2.3)
