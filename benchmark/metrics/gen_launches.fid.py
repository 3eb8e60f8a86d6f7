"""``gen_launches.fid``: kernel-launch calls a request that the host makes
inside the port's ``sampler.mpi`` span (``port_spans.LAUNCH_CALLS``, counted
by time): what fusing the generator's kernels or a CUDA graph would cut."""

from benchmark import port_spans


def read(trace, runner):
    return port_spans.launches(trace, ["sampler.mpi"])
