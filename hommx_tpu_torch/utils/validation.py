"""Validation utilities: L² and H¹ norms and errors, cross-mesh comparison,
the zero box-boundary BC, and the Hooke-tensor builder (torch port of
``hommx_tpu/utils/validation.py``; ``l2_norm_space`` takes P1 and P2
spaces, the rest P1).

Norms are evaluated in float64 on the host, whatever the device and dtype
of the function they measure.
"""

from __future__ import annotations

import numbers
from typing import Callable, Optional

import numpy as np
import torch

from hommx_tpu_torch.ops.assembly import h1_seminorm_fn, l2_norm_fn
from hommx_tpu_torch.ops.elements import p1_basis_at, quad_points_physical
from hommx_tpu_torch.ops.function_space import (
    FunctionSpace,
    dirichletbc,
    eval_at_points,
    locate_dofs_geometrical,
)
from hommx_tpu_torch.ops.interpolation import interpolate_nonmatching
from hommx_tpu_torch.ops.p2 import p2_basis
from hommx_tpu_torch.ops.quadrature import simplex_rule

__all__ = [
    "calc_l2_error",
    "calc_l2_norm",
    "l2_norm_space",
    "calc_h1_error",
    "zero_dirichlet_bcs",
    "relative_l2_vs_reference",
    "relative_h1_vs_reference",
    "hooke_tensor",
]


def _host64(u) -> torch.Tensor:
    arr = u.array if hasattr(u, "array") else u
    return torch.as_tensor(arr).detach().cpu().to(torch.float64)


def _geometry(mesh):
    return torch.as_tensor(mesh.vertices, dtype=torch.float64), torch.as_tensor(mesh.cells)


def calc_l2_error(mesh, u1, u2, bs: int = 1) -> float:
    """L² norm of the difference of two P1 functions on the same mesh."""
    return float(l2_norm_fn(*_geometry(mesh), _host64(u1) - _host64(u2), bs=bs))


def calc_l2_norm(mesh, u, bs: int = 1, exact: Optional[Callable] = None) -> float:
    """L² norm of a P1 function, or of (u − exact) for a callable exact."""
    return float(l2_norm_fn(*_geometry(mesh), _host64(u), bs=bs, exact=exact))


def l2_norm_space(u, exact: Optional[Callable] = None, degree: int = 4) -> float:
    """L² norm of a Function (or of u − exact) on its own space, P1 or P2:
    the space's basis evaluated at the quadrature points."""
    V = u.space
    verts, cells = _geometry(V.mesh)
    xq, wq, _ = quad_points_physical(verts, cells, degree)
    xi = torch.as_tensor(simplex_rule(V.mesh.dim, degree)[0], dtype=torch.float64)
    phi = p1_basis_at(xi) if V.degree == 1 else p2_basis(xi, V.mesh.dim)[0]
    uv = _host64(u).reshape(-1, V.bs)[torch.as_tensor(V.cell_nodes()).long()]  # (nc, nb, bs)
    uq = torch.einsum("qk,ckb->cqb", phi, uv)
    if exact is not None:
        uq = uq - eval_at_points(exact, xq).reshape(uq.shape).to(uq.dtype)
    return float(torch.sqrt((wq * (uq * uq).sum(dim=-1)).sum()))


def calc_h1_error(mesh, u1, u2, bs: int = 1) -> float:
    """H¹ seminorm of the difference of two P1 functions on the same mesh."""
    return float(h1_seminorm_fn(*_geometry(mesh), _host64(u1) - _host64(u2), bs=bs))


def relative_h1_vs_reference(u_coarse, u_fine) -> float:
    """Relative H¹-seminorm difference against a fine solution
    interpolated onto the coarse space."""
    V = u_coarse.space
    u_ref_i = interpolate_nonmatching(V, u_fine)
    err = calc_h1_error(V.mesh, u_coarse, u_ref_i, bs=V.bs)
    return err / float(h1_seminorm_fn(*_geometry(V.mesh), _host64(u_ref_i), bs=V.bs))


def zero_dirichlet_bcs(V: FunctionSpace):
    """Zero Dirichlet BC on the bounding-box boundary."""
    mesh = V.mesh
    lo, hi = mesh.bounding_box()

    def marker(x):
        m = np.zeros(x.shape[1], dtype=bool)
        for k in range(mesh.dim):
            m |= np.isclose(x[k], lo[k]) | np.isclose(x[k], hi[k])
        return m

    dofs = locate_dofs_geometrical(V, marker)
    return [dirichletbc(0.0 if V.bs == 1 else np.zeros(V.bs), dofs, V)]


def relative_l2_vs_reference(u_coarse, u_fine) -> float:
    """Relative L² difference against a fine solution interpolated onto the
    coarse space."""
    V = u_coarse.space
    u_ref_i = interpolate_nonmatching(V, u_fine)
    err = calc_l2_error(V.mesh, u_coarse, u_ref_i, bs=V.bs)
    return err / calc_l2_norm(V.mesh, u_ref_i, bs=V.bs)


def _lame(value, device) -> torch.Tensor:
    """A Lamé callable's value as a tensor: a Python number as a 0-d host
    tensor, which enters the device's arithmetic as a scalar (a copy to a
    card would wait for the card), anything else on ``device``."""
    if isinstance(value, numbers.Number):
        return torch.as_tensor(value)
    return torch.as_tensor(value, device=device)


def hooke_tensor(dim: int, mu_fn: Callable, lam_fn: Callable) -> Callable:
    """Isotropic Hooke tensor A_ijkl = λ δij δkl + μ (δik δjl + δil δjk)
    with x,y-dependent Lamé callables.  It computes in the promoted type
    of μ, λ and the point y, so float64 points give a float64 tensor (a
    Lamé callable that returns float32, such as ``torch.where`` on two
    Python numbers, rounds its own values)."""

    def A(x, y):
        mu = _lame(mu_fn(x, y), y.device)
        lam = _lame(lam_fn(x, y), y.device)
        dt = torch.promote_types(torch.promote_types(mu.dtype, lam.dtype), y.dtype)
        I = torch.eye(dim, dtype=dt, device=y.device)
        return lam.to(dt) * torch.einsum("ij,kl->ijkl", I, I) + mu.to(dt) * (
            torch.einsum("ik,jl->ijkl", I, I) + torch.einsum("il,jk->ijkl", I, I)
        )

    return A
