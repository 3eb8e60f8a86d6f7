"""``render_roofline.fid``: the least time of one request's render (one view
of every eval plane, ``yardstick.render_cost``: every texel read once, the
image written once) over the device time of the kernels inside the
benchmark's ``bench.render`` span, in percent.  Counted at every plane, it
is the least work of a route that reads every plane (the tiled warp): the
fused kernel stops a pixel once no light reaches further, so its least work
depends on each request's data and this count does not bound it."""

from benchmark import yardstick


def read(trace, runner):
    cfg = runner.ctx.cfg
    us = yardstick.spans_busy(trace, ["bench.render"])
    if us <= 0 or not trace.n:
        return None
    res = cfg.resolution
    cost = yardstick.render_cost(1, cfg.eval_n_planes, res, res, res, res)
    least = yardstick.least_seconds_render(cost, trace.peaks)
    return 100.0 * least / (us / 1e6 / trace.n)
