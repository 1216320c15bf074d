"""The benchmark's reading of a ``torch.profiler`` trace: the device's
kernel and copy intervals, their union (busy time), the longest idle gaps
with the host operation that ran during each, and device time by kernel
name.  Per-layer metric readers (``portbench/metrics/``) get a
:class:`Trace`."""

from __future__ import annotations

import bisect
import collections
import importlib.util
import json
from pathlib import Path

__all__ = ["Trace", "union_seconds", "gaps", "from_profiler"]

_PKG = Path(__file__).resolve().parent
#: host events of the profiler itself, not of the program
_PROFILER_OWN = ("Activity Buffer Request",)


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(intervals, start: float, end: float) -> list:
    """The idle ``(start, end)`` stretches of [start, end] that no interval
    covers, longest first."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


class Trace:
    """What a traced window read: ``solves`` completed in ``window_s``
    seconds; the device's kernels ``(name, start_s, end_s)`` and copies;
    the program's ``counters``; the configuration's ``work``; the table of
    ``peaks`` of the device ``kind``."""

    def __init__(self, solves: int, window_s: float, kernels: list, copies: list, host: list,
                 counters: dict, work: dict, kind: str, span: tuple):
        self.solves = solves
        self.window_s = window_s
        self.kernels = kernels
        self.copies = copies
        self.host = host  # (name, start_s, end_s) of the host's operations
        self.counters = counters
        self.work = work
        self.kind = kind
        self.span = span
        ivs = [(s, e) for _, s, e in kernels] + [(s, e) for _, s, e in copies]
        self.busy_s = union_seconds(ivs)
        self._ivs = ivs
        peaks = json.loads((_PKG / "roofline" / "peaks.json").read_text())["devices"]
        self.peaks = next((p for name, p in peaks.items() if kind.startswith(name)), None)

    def kernel_seconds(self, fragment: str):
        """(launches, device seconds) of the kernels whose name holds
        ``fragment``."""
        hits = [e - s for name, s, e in self.kernels if fragment in name]
        return len(hits), sum(hits)

    def roofline(self, name: str):
        """The operation and byte counts of kernel ``name``
        (``portbench/roofline/<name>.py``)."""
        path = _PKG / "roofline" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_roofline_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the innermost host operation running at its
        middle (``host: no recorded op`` where none was, as in Python between operations)."""
        by_name = collections.defaultdict(float)
        for name, s, e in self.kernels + self.copies:
            by_name[name[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        named = []
        for g0, g1 in gaps(self._ivs, *self.span)[:top]:
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, i - 4000):i] if h[2] >= mid]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host: no recorded op"
            named.append([name[:160], g1 - g0])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def from_profiler(prof, solves, window_s, counters, work, kind, span=(0.0, 0.0)) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    window is the host event ``portbench.window`` (``span`` where the trace
    has none); device intervals are clipped to it.  Times are seconds from
    the trace's first event."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    base = min((ev.start_ns() for ev in evs), default=0)
    kernels, copies, host = [], [], []
    for ev in evs:
        name, on_card = ev.name(), ev.device_type() == DeviceType.CUDA
        s = (ev.start_ns() - base) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if on_card and name.startswith("portbench."):
            continue  # the benchmark's own annotation, mirrored on the device's timeline
        if on_card:
            (copies if name.startswith(("Memcpy", "Memset")) else kernels).append((name, s, e))
        elif name not in _PROFILER_OWN:
            host.append((name, s, e))
    marks = [h for h in host if h[0] == "portbench.window"]
    t0, t1 = (marks[0][1], marks[0][2]) if marks else span

    def clip(evs):
        return [(n, max(s, t0), min(e, t1)) for n, s, e in evs if e > t0 and s < t1]

    return Trace(solves, window_s, clip(kernels), clip(copies), host, counters, work, kind,
                 (t0, t1))
