"""``gen_device_ms.fid``: device milliseconds a request inside the port's
``sampler.mpi`` span (``eval/harness.py``: the z draw and the generator at
batch 1), read from the trace with no synchronize."""

from benchmark import port_spans


def read(trace, runner):
    return port_spans.device_ms(trace, ["sampler.mpi"])
