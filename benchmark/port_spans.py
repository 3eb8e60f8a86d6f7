"""Readings of the port's own spans (``gmpi_tpu_torch.utils.inspect.
profile_scope``: ``loader.wait``, ``host_draw.*``, ``render.*``,
``sampler.mpi``) in a traced window, for the per-layer metrics that put the
card's idle and busy time down to a port layer.

Spans carry no request ids: a span belongs to whatever unit ran at its time,
and each reading is per unit of the window (``trace.n``).  A reading is None
where the trace holds none of the spans it reads: a program without them
(an older checkout) reports nothing rather than a zero.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from benchmark import yardstick

# the host's kernel-launch calls, as the profiler names the entry points of
# the CUDA runtime (cuda*) and of the lower-level CUDA API (cu*)
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaGraphLaunch"})


def host_ranges(trace, names: Sequence[str]) -> List[Tuple[float, float]]:
    """Merged host ranges, clipped to the window, of the host spans whose
    names start with any of ``names`` (on any thread)."""
    lo, hi = trace.window
    prefixes = tuple(names)
    return yardstick.merged((max(s, lo), min(e, hi)) for name, s, e, _ in trace.host
                            if name.startswith(prefixes) and e > lo and s < hi)


def idle_ms(trace, names: Sequence[str]) -> Optional[float]:
    """Milliseconds a unit in which the card ran nothing while the host was
    inside the spans ``names``: their merged host ranges less the device-busy
    time inside them."""
    ranges = host_ranges(trace, names)
    if not ranges or not trace.n:
        return None
    idle = sum((e - s) - yardstick.busy_between(trace.busy, trace.busy_starts, s, e)
               for s, e in ranges)
    return idle / 1e3 / trace.n


def device_ms(trace, names: Sequence[str]) -> Optional[float]:
    """Device-busy milliseconds a unit inside the device ranges of the spans
    ``names`` (``yardstick.spans_busy``; a backward's span on the autograd
    thread has its own device range)."""
    prefixes = tuple(names)
    if not trace.n or not any(name.startswith(prefixes) for name, _, _ in trace.annotations):
        return None
    return yardstick.spans_busy(trace, names) / 1e3 / trace.n


def launches(trace, names: Sequence[str]) -> Optional[float]:
    """Kernel-launch calls a unit that start inside the host ranges of the
    spans ``names``, assigned by time and not by thread."""
    ranges = host_ranges(trace, names)
    if not ranges or not trace.n:
        return None
    starts = [s for s, _ in ranges]
    count = 0
    for name, s, _, _ in trace.host:
        if name in LAUNCH_CALLS:
            i = bisect.bisect_right(starts, s) - 1
            count += i >= 0 and s < ranges[i][1]
    return count / trace.n
