"""``composite_ms.fid``: device milliseconds a request inside the port's
``render.composite`` span (``core/renderer.py``: the over-composite of the
warped planes that follows the banded or gather warp, inside
``render.banded``/``render.gather``).  Nothing to read on the fused route,
whose kernel composites as it warps, or on a program without the span."""

from benchmark import port_spans


def read(trace, runner):
    return port_spans.device_ms(trace, ["render.composite"])
