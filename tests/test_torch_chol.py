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
    """The kernel holds a cell's lower 32 x 32 tiles (P(P+1)/2 of them, P =
    ceil(n/32)) and two (32 P, s) right-hand-side arrays in shared memory:
    at n = 192, s = 6, 21 tiles and 2 x 192 x 6 floats.  9 panels (n = 288)
    fit the 232,448 bytes a block may take, 10 do not.  An f32 CUDA engine
    above the limit refuses at construction, naming it and ROADMAP B5,
    before it touches the device."""
    assert k3.kernel_smem_bytes(192, 6) == 4 * (21 * 32 * 32 + 2 * 192 * 6) == 95232
    assert k3.max_kernel_n(6) == 288
    assert k3.kernel_smem_bytes(288, 6) == 4 * (45 * 1024 + 2 * 288 * 6) == 198144 <= 232448
    assert k3.kernel_smem_bytes(289, 6) == 4 * (55 * 1024 + 2 * 320 * 6) == 240640 > 232448
    with pytest.raises(NotImplementedError, match=r"n = 375 exceeds its limit n <= 288.*B5"):
        ht.MicroEngine(ht.create_unit_cube(5), bs=3, coeff_kind="tensor4",
                       dtype=torch.float32, device="cuda")


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
    """One past the limit, and s outside 1..8, raise ValueError naming the
    limit; the CUDA wrapper refuses such shapes before it builds anything."""
    with pytest.raises(ValueError, match="n = 289 exceeds its shared-memory limit n <= 288 at s = 6"):
        k3.chol_launch_config(289, 6)
    with pytest.raises(ValueError, match="takes 1 to 8"):
        k3.chol_launch_config(32, 9)
