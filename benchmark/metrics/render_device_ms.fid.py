"""``render_device_ms.fid``: device milliseconds a request inside the port's
``render.*`` spans (``core/renderer.py``: the view's warp and composite,
without its pose and rays)."""

from benchmark import port_spans


def read(trace, runner):
    return port_spans.device_ms(trace, ["render."])
