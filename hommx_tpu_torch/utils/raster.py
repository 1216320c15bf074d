"""A matplotlib-free renderer for :func:`~hommx_tpu_torch.utils.plotting.plot_fem_function`.

Where matplotlib is not installed, a P1 function is drawn by numpy alone and written as an 8-bit RGB PNG
through ``zlib``: the same three pictures as the matplotlib backend, with
a colour bar strip and no text.

- 2D: the function interpolated at every pixel centre (each pixel located
  in its cell; pixels outside the mesh stay white).
- 3D scalar: three mid-plane slices side by side, through ``eval_p1``.
- 3D vector: the boundary surface (warped if asked), flat-shaded facets
  coloured by the magnitude, drawn with a depth buffer in an orthographic
  view from matplotlib's default angle (azimuth −60°, elevation 30°).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["colormap", "write_png", "render_2d", "render_slices", "render_surface"]

# viridis at 17 evenly spaced points (matplotlib's table), interpolated linearly
_VIRIDIS = np.array(
    [[68, 1, 84], [72, 24, 106], [71, 45, 123], [66, 64, 134], [59, 82, 139],
     [51, 99, 141], [44, 114, 142], [38, 130, 142], [33, 145, 140], [31, 160, 136],
     [40, 174, 128], [63, 188, 115], [94, 201, 98], [132, 212, 75], [173, 220, 48],
     [216, 226, 25], [253, 231, 37]], dtype=np.float64)
_WHITE = 255


def colormap(t: np.ndarray) -> np.ndarray:
    """float array in [0, 1] -> uint8 RGB (..., 3), viridis."""
    x = np.clip(np.nan_to_num(np.asarray(t, dtype=np.float64)), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(x.astype(np.int64), len(_VIRIDIS) - 2)
    w = (x - i)[..., None]
    return np.round(_VIRIDIS[i] * (1 - w) + _VIRIDIS[i + 1] * w).astype(np.uint8)


def _normalise(v: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    return (v - vmin) / (vmax - vmin if vmax > vmin else 1.0)


def write_png(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as a PNG (filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(chunk(b"IEND", b""))


def _with_colorbar(img: np.ndarray, gap: int = 16, width: int = 24) -> np.ndarray:
    """Append a white gap and a vertical colour bar (low at the bottom)."""
    h = img.shape[0]
    bar = colormap(np.linspace(1.0, 0.0, h))[:, None, :].repeat(width, axis=1)
    white = np.full((h, gap, 3), _WHITE, np.uint8)
    return np.concatenate([img, white, bar], axis=1)


def _pixel_grid(lo, hi, width: int):
    """Pixel centres (H*W, 2) over the box [lo, hi] (rows from the top)."""
    span = np.maximum(hi - lo, 1e-300)
    height = max(1, int(round(width * span[1] / span[0])))
    xs = lo[0] + (np.arange(width) + 0.5) / width * span[0]
    ys = hi[1] - (np.arange(height) + 0.5) / height * span[1]
    X, Y = np.meshgrid(xs, ys)
    return np.stack([X.ravel(), Y.ravel()], axis=1), height


def render_2d(mesh, scalar: np.ndarray, width: int = 1024) -> np.ndarray:
    """The P1 interpolant of vertex values ``scalar`` on a 2D mesh, pixel
    by pixel (white outside the mesh), with a colour bar."""
    from hommx_tpu_torch.ops.interpolation import locate_cells

    lo, hi = mesh.bounding_box()
    pts, height = _pixel_grid(lo, hi, width)
    cells = locate_cells(mesh, pts)
    cp = mesh.vertices[mesh.cells[cells]]  # (np, 3, 2)
    T = np.swapaxes(cp[:, 1:, :] - cp[:, :1, :], 1, 2)
    xi = np.linalg.solve(T, (pts - cp[:, 0, :])[..., None])[..., 0]
    lam = np.concatenate([1.0 - xi.sum(axis=1, keepdims=True), xi], axis=1)
    vals = np.einsum("pa,pa->p", lam, scalar[mesh.cells[cells]])
    img = colormap(_normalise(vals, scalar.min(), scalar.max()))
    img[lam.min(axis=1) < -1e-9] = _WHITE
    return _with_colorbar(img.reshape(height, width, 3))


def render_slices(u, mesh, nres: int = 256, gap: int = 16) -> np.ndarray:
    """Three mid-plane slices (x, y, z = mid) of a 3D scalar function, side
    by side on one colour scale, with a colour bar."""
    from hommx_tpu_torch.ops.interpolation import eval_p1

    lo, hi = mesh.bounding_box()
    mid = 0.5 * (lo + hi)
    slices = []
    for k in range(3):
        ai, bi = [i for i in range(3) if i != k]
        aa = np.linspace(lo[ai], hi[ai], nres)
        bb = np.linspace(hi[bi], lo[bi], nres)  # image rows from the top
        B2, A2 = np.meshgrid(bb, aa, indexing="ij")
        pts = np.empty((nres * nres, 3))
        pts[:, ai], pts[:, bi], pts[:, k] = A2.ravel(), B2.ravel(), mid[k]
        slices.append(eval_p1(u, pts).numpy().reshape(nres, nres))
    vmin = min(s.min() for s in slices)
    vmax = max(s.max() for s in slices)
    white = np.full((nres, gap, 3), _WHITE, np.uint8)
    panels = []
    for s in slices:
        panels += [colormap(_normalise(s, vmin, vmax)), white]
    return _with_colorbar(np.concatenate(panels[:-1], axis=1))


def render_surface(verts: np.ndarray, facets: np.ndarray, fvals: np.ndarray,
                   width: int = 1024, azim: float = -60.0, elev: float = 30.0) -> np.ndarray:
    """Boundary facets (nf, 3) of a 3D mesh with vertices ``verts``,
    coloured by ``fvals`` (nf,) and flat-shaded, in an orthographic view
    with a depth buffer; white background, with a colour bar."""
    a, e = np.deg2rad(azim), np.deg2rad(elev)
    # camera axes: right, up and towards the viewer (matplotlib's convention)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    toward = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    up = np.cross(toward, right)
    c = verts - verts.mean(axis=0)
    sx, sy, depth = c @ right, c @ up, c @ toward
    lo = np.array([sx.min(), sy.min()])
    span = max(sx.max() - lo[0], sy.max() - lo[1], 1e-300)
    margin = 0.05 * width
    scale = (width - 2 * margin) / span
    px = margin + (sx - lo[0]) * scale
    py = margin + (sy.max() - sy) * scale  # image rows from the top
    height = int(np.ceil(margin * 2 + (sy.max() - lo[1]) * scale))
    zbuf = np.full((height, width), -np.inf)
    img = np.full((height, width, 3), _WHITE, np.uint8)

    tri = verts[facets]
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True), 1e-300)
    light = 0.55 + 0.45 * np.abs(normal @ toward)
    colors = (colormap(_normalise(fvals, fvals.min(), fvals.max())) * light[:, None]).astype(np.uint8)

    for f in range(facets.shape[0]):
        v = facets[f]
        x, y, z = px[v], py[v], depth[v]
        x0, x1 = int(np.floor(x.min())), int(np.ceil(x.max())) + 1
        y0, y1 = int(np.floor(y.min())), int(np.ceil(y.max())) + 1
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, width), min(y1, height)
        det = (y[1] - y[2]) * (x[0] - x[2]) + (x[2] - x[1]) * (y[0] - y[2])
        if x0 >= x1 or y0 >= y1 or abs(det) < 1e-12:
            continue  # seen edge-on
        X, Y = np.meshgrid(np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5)
        l0 = ((y[1] - y[2]) * (X - x[2]) + (x[2] - x[1]) * (Y - y[2])) / det
        l1 = ((y[2] - y[0]) * (X - x[2]) + (x[0] - x[2]) * (Y - y[2])) / det
        l2 = 1.0 - l0 - l1
        zf = l0 * z[0] + l1 * z[1] + l2 * z[2]
        sub = zbuf[y0:y1, x0:x1]
        hit = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9) & (zf > sub)
        sub[hit] = zf[hit]
        img[y0:y1, x0:x1][hit] = colors[f]
    return _with_colorbar(img)
