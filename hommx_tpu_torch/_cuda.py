"""Build-at-first-use loader for the hand-written CUDA kernels.

Each kernel source under ``*/csrc/*.cu`` exposes ``extern "C"`` launchers
that take raw device pointers and a CUDA stream and return the
``cudaError_t`` of the launch.  The source is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library under ``hommx_tpu_torch/_build/``
(named by the source's content hash, so an edited source is rebuilt) and
bound with ``ctypes``.  Nothing is built at import time: a module that owns
a kernel imports cleanly where there is no ``nvcc`` and no GPU, and builds
only when its wrapper first sees a CUDA tensor.  A failed build raises.

The launch path is kept short, since a small kernel (the DIA SpMV: a few
microseconds of device time) runs once per macro CG iteration: each ctypes
function is resolved once, the stream is the raw handle of the device's
current stream (no ``torch.cuda.Stream`` object per call), and the device
context is entered only when the tensor is not on the current device.  The
launch neither synchronises nor allocates, so it is safe inside a CUDA
graph capture, where the current stream is the capture stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["CudaKernel", "nvcc_path"]

_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use"
    )


class CudaKernel:
    """One ``.cu`` source, its ``extern "C"`` launchers and a launch count.

    Args:
        source: path of the CUDA C++ file.
        signatures: launcher name -> list of ctypes argument types (every
            launcher returns ``int``, the launch's ``cudaError_t``).

    ``launches`` counts successful launches made through :meth:`launch` or
    a function from :meth:`launcher`; a run sets it to 0 and reads it back to
    show which kernels it used.
    """

    def __init__(self, source: Path, signatures: dict):
        self.source = Path(source)
        self.signatures = dict(signatures)
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._launchers = {}

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = self._build()
        return self._lib

    def _build(self) -> ctypes.CDLL:
        src = self.source.read_bytes()
        digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = _BUILD_DIR / f"{self.source.stem}-{digest}.so"
        t0 = time.perf_counter()
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".so.build.{os.getpid()}")
            cmd = [nvcc_path(), *_NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {self.source.name}:\n{self.build_log}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        return lib

    def launcher(self, name: str):
        """The launch function of launcher ``name``, resolved once (the
        first call builds the library): ``launch(device_index, *args)``
        calls it with ``args`` and the device's current stream as its last
        argument, raises if the launch was refused, and counts it."""
        launch = self._launchers.get(name)
        if launch is None:
            launch = self._launchers[name] = self._bind(name)
        return launch

    def _bind(self, name: str):
        fn = getattr(self.library(), name)
        # the raw cudaStream_t of the current stream; torch.cuda.Stream
        # would build an object on every call
        raw_stream = torch._C._cuda_getCurrentRawStream
        current_device = torch.cuda.current_device

        def launch(device: int, *args) -> None:
            if device == current_device():
                rc = fn(*args, raw_stream(device))
            else:
                with torch.cuda.device(device):
                    rc = fn(*args, raw_stream(device))
            if rc != 0:
                raise RuntimeError(
                    f"{self.source.name}:{name} launch failed with cudaError_t {rc}"
                )
            self.launches += 1

        return launch

    def launch(self, name: str, device: int, *args) -> None:
        """Launch ``name`` on ``device``'s current stream (see
        :meth:`launcher`)."""
        self.launcher(name)(device, *args)
