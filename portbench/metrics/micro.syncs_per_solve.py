"""micro.syncs_per_solve: host waits on the device inside the program's
micro stage, over the solves completed in the traced window.  Counted are
the CUDA runtime calls that block the host until the device has drained
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, the blocking ``cudaMemcpy``) whose start lies in
the window inside a span ``hommx.micro``; the asynchronous calls
(``cudaMemcpyAsync``, ``cudaLaunchKernel``) are not.  Nothing where the
program records no such span."""

import bisect
import re

from portbench.spans import merged

#: a blocking runtime call, with the version or per-thread-stream suffix
#: some CUDA releases append to its name
BLOCKING = re.compile(
    r"(cudaStreamSynchronize|cudaDeviceSynchronize|cudaEventSynchronize|cudaMemcpy)"
    r"(_v\d+|_ptds|_ptsz)*")


def read(trace):
    if trace.solves < 1:
        return None
    t0, t1 = trace.span
    spans = merged((max(s, t0), min(e, t1)) for name, s, e in trace.host
                   if name == "hommx.micro" and e > t0 and s < t1)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    count = 0
    for name, s, _ in trace.host:
        if BLOCKING.fullmatch(name) and t0 <= s < t1:
            i = bisect.bisect_right(starts, s) - 1
            count += i >= 0 and s < spans[i][1]
    return count / trace.solves
