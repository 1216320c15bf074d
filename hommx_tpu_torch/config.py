"""Numerical configuration for hommx_tpu_torch.

Precision policy (mirrors ``hommx_tpu/config.py:69-79``): float64 on the
CPU — the parity path that the tests hold against the JAX package — and
float32 on CUDA, the serving path.  Every public solver takes an explicit
``dtype`` and ``device``; nothing here sets a global default device.

TF32 stays off.  On the TPU, matmul inputs rounded to bf16 cost 3.3e-3
relative error on A* (ROADMAP "Accuracy lessons"); TF32 rounds the same
way (10-bit mantissa), so float32 products here run in full float32.
Quadrature coordinates stay float64 even on float32 runs (see
``micro/engine.py``).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["default_dtype", "as_device", "same_device", "sync"]


def as_device(device) -> torch.device:
    return device if isinstance(device, torch.device) else torch.device(device)


def same_device(a, b) -> bool:
    """Whether two devices are one: a CUDA device without an index is the
    current one."""
    a, b = as_device(a), as_device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda" and (a.index is None) != (b.index is None):
        cur = torch.cuda.current_device()
        return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)
    return a.index == b.index


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on CUDA."""
    return torch.float32 if as_device(device).type == "cuda" else torch.float64


def sync(device) -> None:
    """Wait for queued device work (host timings of CUDA work need it)."""
    if as_device(device).type == "cuda":
        torch.cuda.synchronize(device)
