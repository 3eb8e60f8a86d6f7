"""``mfu.train``: the step's least time (its convolutions' and matrix
products' FLOPs, counted from the frozen reference and stored in the
configuration file, each over the peak of its stated precision) over the
measured time a step, in percent."""

from benchmark import yardstick


def read(trace, runner):
    flops = runner.ctx.cell.config["flops"]["train_step"]
    if not trace.n:
        return None
    least = yardstick.least_seconds_flops(flops, trace.peaks)
    return 100.0 * least / (runner.window_s / trace.n)
