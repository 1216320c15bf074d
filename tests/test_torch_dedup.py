"""Cell dedup through the port (float64 on the CPU): the fingerprint keys
and the class partition against the JAX package's, dedup on and off giving
the same solution, x-varying coefficients declining, and the audit passing
on honest classes and catching a constructed collision."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.models.hmm import BaseHMM
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

BEAM_W = 0.4


def jax_fibre(a, b):
    da = jnp.arccos(jnp.cos(2 * jnp.pi * (a - 0.5)))
    db = jnp.arccos(jnp.cos(2 * jnp.pi * (b - 0.5)))
    return (da**2 + db**2) < (2 * jnp.pi) ** 2 / 16


def torch_fibre(a, b):
    da = torch.arccos(torch.cos(2 * torch.pi * (a - 0.5)))
    db = torch.arccos(torch.cos(2 * torch.pi * (b - 0.5)))
    return (da**2 + db**2) < (2 * torch.pi) ** 2 / 16


def jax_rotation(x):
    g = 0.5 * jnp.pi * x[1] / BEAM_W
    c, s = jnp.cos(g), jnp.sin(g)
    return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]).T


def torch_rotation(x):
    g = 0.5 * torch.pi * x[1] / BEAM_W
    c, s = torch.cos(g), torch.sin(g)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])]).T


def torch_mu(x, y):
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(torch_fibre(y[1], y[2]), 100.0 * one, 0.001 * one)


ONE = lambda x, y: 1.0


def _beam(pkg, dedup=True, **kw):
    """The dedup test's rotated-fibre beam (10x3x3 box, 3³ micro cube)."""
    box = [[0, 0, 0], [1.0, BEAM_W, 0.1]]
    if pkg == "jax":
        mu = lambda x, y: jnp.where(jax_fibre(y[1], y[2]), 100.0, 0.001)
        h = hx.LinearElasticityStratifiedHMM(
            hx.create_box(box, [10, 3, 3]), jval.hooke_tensor(3, mu, ONE),
            lambda x: jnp.array([0.0, 0.0, -0.008]), hx.create_unit_cube(3), 2**-5,
            jax_rotation, dedup_cells=dedup)
        V = h.function_space
        h.set_boundary_conditions(hx.dirichletbc(
            np.zeros(3), jax_boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V))
        return h
    f = torch.tensor([0.0, 0.0, -0.008], dtype=torch.float64)
    h = ht.LinearElasticityStratifiedHMM(
        ht.create_box(box, [10, 3, 3]), tval.hooke_tensor(3, torch_mu, ONE), lambda x: f,
        ht.create_unit_cube(3), 2**-5, torch_rotation, dedup_cells=dedup, device="cpu", **kw)
    V = h.function_space
    h.set_boundary_conditions(ht.dirichletbc(
        np.zeros(3), boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V))
    return h


def _flagship(pkg, n=16, dedup=True, **kw):
    if pkg == "jax":
        return hx.PoissonHMM(hx.create_unit_square(n), lambda x, y: 1.1 + x[0] + jnp.sin(
            2 * jnp.pi * y[0]), lambda x: 1.0, hx.create_unit_square(8), 2**-5,
            dedup_cells=dedup)
    return ht.PoissonHMM(ht.create_unit_square(n), lambda x, y: 1.1 + x[0] + torch.sin(
        2 * torch.pi * y[0]), lambda x: 1.0, ht.create_unit_square(8), 2**-5,
        dedup_cells=dedup, device="cpu", **kw)


def _same_partition(a, b) -> bool:
    """True when the label arrays a and b group the cells identically."""
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


@pytest.mark.parametrize("build, expected", [(_beam, 9), (_flagship, 32)],
                         ids=["beam_10x3x3", "flagship_16"])
def test_dedup_classes_and_keys_match_reference(build, expected):
    """The 16 projections of each cell's inputs equal the reference's keys
    to rounding, and the classes are the reference's up to relabelling."""
    hj, h = build("jax"), build("torch")
    rep_j, inv_j = hj._dedup_classes(hj._sys.centers)
    rep, inv = h._dedup_classes(h._sys.centers)
    keys_j = np.asarray(hj._fp_jit(hj._sys.centers))
    keys = h._fingerprint()(h._sys.centers).numpy()
    assert keys.shape == keys_j.shape == (h._sys.centers.shape[0], 16)
    np.testing.assert_allclose(keys, keys_j, rtol=0, atol=1e-12 * np.abs(keys_j).max())
    assert h._n_unique == hj._n_unique == len(rep) == expected
    assert _same_partition(inv, inv_j)
    # every class holds cells with equal keys, its representative among them
    assert np.array_equal(inv[rep], np.arange(expected))
    np.testing.assert_array_equal(keys, keys[rep][inv])


@pytest.mark.parametrize("build", [_beam, _flagship], ids=["beam_10x3x3", "flagship_16"])
def test_dedup_on_and_off_agree(build):
    """Solving one representative per class gives the full solve's u to
    1e-9 relative; the diagnostics count the classes."""
    h1, h0 = build("torch"), build("torch", dedup=False)
    u1, u0 = h1.solve().array.numpy(), h0.solve().array.numpy()
    assert np.abs(u1 - u0).max() / np.abs(u0).max() < 1e-9
    assert h1.diagnostics["unique_cells"] < h1.diagnostics["num_cells"]
    assert h0.diagnostics["unique_cells"] == h0.diagnostics["num_cells"]
    assert h0._dedup_cache is False  # never fingerprinted


def test_x_varying_coefficients_decline():
    """A coefficient varying in both macro coordinates gives every cell its
    own problem: dedup declines and every cell is solved."""
    h = ht.PoissonHMM(ht.create_unit_square(12), lambda x, y: 1.1 + x[0] + 0.37 * x[1]
                      + torch.sin(2 * torch.pi * y[0]), lambda x: 1.0,
                      ht.create_unit_square(8), 2**-4, device="cpu")
    h.solve()
    assert h.diagnostics["unique_cells"] == h.diagnostics["num_cells"] == 288
    assert h._dedup_cache is None and h._n_unique is None
    # under 16 cells dedup is not attempted
    small = ht.PoissonHMM(ht.create_unit_square(2), lambda x, y: 2.0 + torch.sin(
        2 * torch.pi * y[0]), 1.0, ht.create_unit_square(4), 0.1, device="cpu")
    assert small._dedup_classes(small._sys.centers) is None and small._fp_fn is None


def _stripes(x, y):
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(x[0] < 0.5, one, 3.0 * one) + torch.sin(2 * torch.pi * y[0])


def test_dedup_audit_passes_and_catches_collisions(monkeypatch):
    """The audit re-solves class members and passes on honest classes; a
    constructed collision (all cells forced into one class) raises."""
    args = (ht.create_unit_square(4), _stripes, lambda x: 1.0, ht.create_unit_square(6), 0.01)
    h = ht.PoissonHMM(*args, dedup_verify=4, device="cpu")
    h.solve()
    assert h.diagnostics["unique_cells"] == 2

    h2 = ht.PoissonHMM(*args, dedup_verify=4, device="cpu")
    real_classes = BaseHMM._dedup_classes

    def colliding(self, centers):
        real_classes(self, centers)
        self._n_unique = 1
        nc = centers.shape[0]
        return np.zeros(1, dtype=np.int64), np.zeros(nc, dtype=np.int64)

    monkeypatch.setattr(BaseHMM, "_dedup_classes", colliding)
    with pytest.raises(RuntimeError, match="collision"):
        h2.solve()
