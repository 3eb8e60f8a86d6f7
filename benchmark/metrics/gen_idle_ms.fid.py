"""``gen_idle_ms.fid``: milliseconds a request in which the card ran nothing
while the host was in the port's ``sampler.mpi`` span: the time the batch-1
generator is bound by its dispatch."""

from benchmark import port_spans


def read(trace, runner):
    return port_spans.idle_ms(trace, ["sampler.mpi"])
