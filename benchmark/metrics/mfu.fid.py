"""``mfu.fid``: a request's least time (the generator's FLOPs at batch 1,
counted from the frozen reference and stored in the configuration file,
each over the peak of its stated precision) over the measured time a
request, in percent."""

from benchmark import yardstick


def read(trace, runner):
    flops = runner.ctx.cell.config["flops"]["fid_request"]
    if not trace.n:
        return None
    least = yardstick.least_seconds_flops(flops, trace.peaks)
    return 100.0 * least / (runner.window_s / trace.n)
