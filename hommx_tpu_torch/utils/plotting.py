"""Host-side plotting helpers (torch port of ``hommx_tpu/utils/plotting.py``;
matplotlib, in place of the reference's pyvista warped-surface plots,
``hmm.py:493-511`` / ``helpers.py:305-315``).

2D meshes: filled tricontour.  3D scalar functions: three mid-plane slices.
3D vector functions: the domain's boundary surface rendered as a
Poly3DCollection colored by the magnitude, optionally warped by the
solution (the matplotlib analogue of ``pyvista.warp_by_vector``).  The
function's values move to host numpy first, so a Function on the card
plots as one on the CPU.  A P2 function is drawn through its vertex values.

Where matplotlib is not installed, the same pictures are drawn by numpy
alone and written as PNG (``utils/raster.py``; no text): the function then
returns the RGB image instead of a figure.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_fem_function", "func_to_png"]


def _vertex_values(V, u) -> np.ndarray:
    """(num_vertices, bs) float64 host values of a P1/P2 function (P2 dofs
    list the vertices first)."""
    arr = u.array.detach().cpu().numpy() if hasattr(u, "array") else np.asarray(u)
    return arr.astype(np.float64).reshape(-1, V.bs)[: V.mesh.num_vertices]


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def plot_fem_function(
    V, u, filename=None, title=None, cmap="viridis", show=False, warp=0.0
):
    """Plot a P1 function: 2D filled contours, 3D mid-plane slices
    (scalar) or the colored boundary surface (vector).

    Vector functions are colored by magnitude; with ``warp`` nonzero a 3D
    vector solution also displaces the surface by ``warp * u``.  Uses the
    Agg backend unless ``show``.  Returns the figure; where matplotlib is
    not installed, the (H, W, 3) uint8 image of the raster backend
    (viridis only, no title).
    """
    if not _has_matplotlib():
        if show:
            raise ImportError("show=True needs matplotlib")
        return _plot_raster(V, u, filename, warp)
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    mesh = V.mesh
    vals = _vertex_values(V, u)
    scalar = vals[:, 0] if V.bs == 1 else np.linalg.norm(vals, axis=1)
    if mesh.dim == 2:
        import matplotlib.tri as tri

        triang = tri.Triangulation(mesh.vertices[:, 0], mesh.vertices[:, 1], mesh.cells)
        fig, ax = plt.subplots(figsize=(8, 8))
        mappable = ax.tricontourf(triang, scalar, levels=100, cmap=cmap)
        ax.set_aspect("equal")
    elif mesh.dim == 3 and V.bs == 1:
        # scalar 3D: three orthogonal mid-plane slices (with Dirichlet BCs the
        # boundary surface is constant; the interior carries the signal)
        from hommx_tpu_torch.ops.interpolation import eval_p1

        lo, hi = mesh.bounding_box()
        mid = 0.5 * (lo + hi)
        fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
        nres = 96
        slices = []
        for k in range(3):
            ai, bi = [i for i in range(3) if i != k]
            aa = np.linspace(lo[ai], hi[ai], nres)
            bb = np.linspace(lo[bi], hi[bi], nres)
            A2, B2 = np.meshgrid(aa, bb, indexing="ij")
            pts = np.empty((nres * nres, 3))
            pts[:, ai], pts[:, bi] = A2.ravel(), B2.ravel()
            pts[:, k] = mid[k]
            sl = eval_p1(u, pts).numpy().reshape(nres, nres)
            slices.append((ai, bi, aa, bb, sl))
        vmin = min(s[-1].min() for s in slices)
        vmax = max(s[-1].max() for s in slices)
        names = "xyz"
        for ax, (k, (ai, bi, aa, bb, sl)) in zip(axes, enumerate(slices)):
            mappable = ax.pcolormesh(
                aa, bb, sl.T, cmap=cmap, vmin=vmin, vmax=vmax, shading="gouraud"
            )
            ax.set_aspect("equal")
            ax.set_xlabel(names[ai])
            ax.set_ylabel(names[bi])
            ax.set_title(f"{names[k]} = {mid[k]:.3g}")
        ax = axes  # the colorbar spans all three slice panels
        if title:
            fig.suptitle(title)
            title = None
    elif mesh.dim == 3:
        from matplotlib import cm
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        verts = mesh.vertices.copy()
        if warp and V.bs == mesh.dim:
            verts = verts + float(warp) * vals
        facets = mesh.boundary_facets()  # (nf, 3) vertex triples
        polys = verts[facets]  # (nf, 3, 3)
        fvals = scalar[facets].mean(axis=1)
        vmin, vmax = float(fvals.min()), float(fvals.max())
        norm = plt.Normalize(vmin, vmax if vmax > vmin else vmin + 1.0)
        cmap_obj = matplotlib.colormaps[cmap] if isinstance(cmap, str) else cmap
        fig = plt.figure(figsize=(9, 8))
        ax = fig.add_subplot(projection="3d")
        ax.add_collection3d(
            Poly3DCollection(polys, facecolors=cmap_obj(norm(fvals)), edgecolors="none")
        )
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        ax.set_box_aspect(hi - lo + 1e-12)
        mappable = cm.ScalarMappable(norm=norm, cmap=cmap_obj)
        mappable.set_array(fvals)
    else:
        raise NotImplementedError("plotting is implemented for 2D/3D meshes")
    if title:
        ax.set_title(title)
    fig.colorbar(mappable, ax=ax, shrink=0.85)
    if filename:
        fig.savefig(filename, dpi=200, bbox_inches="tight")
    if show:
        plt.show()
    return fig


def _plot_raster(V, u, filename, warp):
    from hommx_tpu_torch.utils import raster

    mesh = V.mesh
    vals = _vertex_values(V, u)
    scalar = vals[:, 0] if V.bs == 1 else np.linalg.norm(vals, axis=1)
    if mesh.dim == 2:
        img = raster.render_2d(mesh, scalar)
    elif mesh.dim == 3 and V.bs == 1:
        img = raster.render_slices(u, mesh)
    elif mesh.dim == 3:
        verts = mesh.vertices + float(warp) * vals if warp and V.bs == 3 else mesh.vertices
        facets = mesh.boundary_facets()
        img = raster.render_surface(verts, facets, scalar[facets].mean(axis=1))
    else:
        raise NotImplementedError("plotting is implemented for 2D/3D meshes")
    if filename:
        raster.write_png(filename, img)
    return img


def func_to_png(filename, V, v, save=True, cmap="viridis", title=None, **_):
    """The reference examples' wrapper (``examples/diffusion/laminate.py:15``):
    writes ``filename``.png when ``save``."""
    return plot_fem_function(
        V, v, filename=f"{filename}.png" if save else None, title=title, cmap=cmap
    )
