"""Native (C++) host runtime: ctypes bindings with numpy fallbacks (port of
``hommx_tpu/native/__init__.py``).

The port's device path is PyTorch with hand-written CUDA kernels; this
package is the host runtime around it: four setup hot paths in C++
(``hostruntime.cpp``), each with a numpy version beside its dispatcher
(site: dispatcher, numpy version):

- ``ell_pattern``: ``ops/sparse.py::build_ell_pattern``,
  ``build_ell_pattern_numpy``;
- ``periodic_match``: ``micro/periodic.py::build_periodic_map_points``,
  ``build_periodic_map_points_numpy``;
- ``greedy_aggregate``: ``ops/amg.py::_greedy_aggregate`` (its sweep),
  ``_greedy_sweep_numpy``;
- ``locate_cells``: ``ops/interpolation.py::_locate_binned``,
  ``_locate_binned_numpy``.

The library is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at first
use into ``hommx_tpu_torch/_build/``, named by the hash of its source and
flags (an edited source is rebuilt), through a per-process temporary file
renamed into place, so that concurrent processes never load a partial
library.  There is no ``-march=native``: a library built on one host may be
loaded on another.  ``HOMMX_TPU_NO_NATIVE=1`` (read at every call) switches
the native routes off.  A failed build logs the compiler's stderr and keeps
it in ``build_error``; ``calls[site]`` counts the calls of each route, so a
run can show which route its setup took (``reset_calls()`` zeroes them).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "available",
    "calls",
    "reset_calls",
    "build_ell_pattern_native",
    "periodic_match_native",
    "greedy_aggregate_native",
    "locate_cells_native",
]

_SRC = Path(__file__).resolve().parent / "hostruntime.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
SITES = ("ell_pattern", "periodic_match", "greedy_aggregate", "locate_cells")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: the compiler's (or loader's) message when the library could not be built
build_error: Optional[str] = None
#: seconds the first use spent building (or finding) and loading the library
build_seconds: Optional[float] = None
calls = {site: {"native": 0, "numpy": 0} for site in SITES}


def reset_calls() -> None:
    for counts in calls.values():
        counts["native"] = counts["numpy"] = 0


def note(site: str, route: str) -> None:
    """Count one call of ``site`` through ``route`` ('native' or 'numpy')."""
    calls[site][route] += 1


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libhostruntime-{digest}.so"


def _build() -> Optional[Path]:
    global build_error
    lib = library_path()
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.build.{os.getpid()}")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = f"{' '.join(cmd)}: {e}"
    else:
        if res.returncode == 0:
            os.replace(tmp, lib)
            return lib
        build_error = res.stderr
    tmp.unlink(missing_ok=True)
    logger.warning("native host runtime build failed, numpy routes in use:\n%s", build_error)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    lib.hr_ell_width.restype = i64
    lib.hr_ell_width.argtypes = [i32p, i64, i32, i64, i32p]
    lib.hr_ell_fill.restype = i32
    lib.hr_ell_fill.argtypes = [i32p, i64, i32, i64, i64, i32p, i32p, i32p]
    lib.hr_periodic_match.restype = i64
    lib.hr_periodic_match.argtypes = [f64p, i64, i32, f64, f64, i64p, i8p]
    lib.hr_locate_cells.restype = i32
    lib.hr_locate_cells.argtypes = [f64p, i64, i32p, i64, i32, f64p, i64, i32p]
    lib.hr_greedy_aggregate.restype = i64
    lib.hr_greedy_aggregate.argtypes = [i64p, i64p, i64, i64, i64p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built at the first call (None if it cannot be)."""
    global _lib, _tried, build_error, build_seconds
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            t0 = time.perf_counter()
            path = _build()
            if path is not None:
                try:
                    _lib = _bind(ctypes.CDLL(str(path)))
                except OSError as e:
                    build_error = str(e)
                    logger.warning("native host runtime load failed, numpy routes in use: %s", e)
            build_seconds = time.perf_counter() - t0
            _tried = True
    return _lib


def _enabled() -> Optional[ctypes.CDLL]:
    if os.environ.get("HOMMX_TPU_NO_NATIVE") == "1":
        return None
    return _load()


def __getattr__(name):
    # ``native.available``: the library is built and not switched off
    if name == "available":
        return _enabled() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def build_ell_pattern_native(cell_dofs: np.ndarray, num_dofs: int):
    """Native ELL pattern build; returns (cols, slots, diag, K) or None."""
    lib = _enabled()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cell_dofs, dtype=np.int32)
    nc, nb = cells.shape
    counts = np.zeros(num_dofs, dtype=np.int32)
    K = lib.hr_ell_width(cells, nc, nb, num_dofs, counts)
    if K <= 0:
        return None
    cols = np.zeros((num_dofs, int(K)), dtype=np.int32)
    slots = np.zeros((nc, nb, nb), dtype=np.int32)
    diag = np.zeros(num_dofs, dtype=np.int32)
    if lib.hr_ell_fill(cells, nc, nb, num_dofs, int(K), cols, slots, diag) != 0:
        return None
    note("ell_pattern", "native")
    return cols, slots, diag, int(K)


def periodic_match_native(vertices: np.ndarray, rtol=1e-5, atol=1e-8):
    """Native slave→master matching; returns (masters, is_slave) or None.
    Raises ValueError on unmatched slaves (as the numpy route does)."""
    lib = _enabled()
    if lib is None:
        return None
    verts = np.ascontiguousarray(vertices, dtype=np.float64)
    nv, dim = verts.shape
    masters = np.zeros(nv, dtype=np.int64)
    is_slave = np.zeros(nv, dtype=np.int8)
    note("periodic_match", "native")
    unmatched = lib.hr_periodic_match(verts, nv, dim, rtol, atol, masters, is_slave)
    if unmatched != 0:
        raise ValueError(
            f"periodic master not found for {unmatched} vertices; "
            "micro mesh faces do not match periodically"
        )
    return masters, is_slave.astype(bool)


def greedy_aggregate_native(rows_sorted, cols_sorted, n_nodes: int):
    """Native greedy AMG aggregation sweep; returns (agg, n_aggregates) or
    None.  The COO adjacency must be sorted by row; the output is that of
    ``ops/amg.py::_greedy_sweep_numpy``."""
    lib = _enabled()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows_sorted, dtype=np.int64)
    cols = np.ascontiguousarray(cols_sorted, dtype=np.int64)
    agg = np.zeros(n_nodes, dtype=np.int64)
    na = lib.hr_greedy_aggregate(rows, cols, rows.shape[0], n_nodes, agg)
    if na < 0:
        return None
    note("greedy_aggregate", "native")
    return agg, int(na)


def locate_cells_native(vertices, cells, points):
    """Native binned point→cell location on a 2D or 3D simplex mesh;
    returns cell indices or None (any other shape: the numpy route)."""
    lib = _enabled()
    verts = np.ascontiguousarray(vertices, dtype=np.float64)
    cls = np.ascontiguousarray(cells, dtype=np.int32)
    pts = np.ascontiguousarray(points, dtype=np.float64)
    dim = verts.shape[1]
    if lib is None or dim not in (2, 3) or cls.shape[1] != dim + 1 or pts.shape[1] != dim:
        return None
    out = np.zeros(pts.shape[0], dtype=np.int32)
    rc = lib.hr_locate_cells(verts, verts.shape[0], cls, cls.shape[0], verts.shape[1],
                             pts, pts.shape[0], out)
    if rc != 0:
        return None
    note("locate_cells", "native")
    return out
