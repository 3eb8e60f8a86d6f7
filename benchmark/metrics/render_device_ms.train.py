"""``render_device_ms.train``: device milliseconds a step inside the port's
``render.*`` spans (``core/renderer.py``: the warp and composite of every
render of the step; ``render.backward``: the renderer's backward kernels,
launched from the autograd thread)."""

from benchmark import port_spans


def read(trace, runner):
    return port_spans.device_ms(trace, ["render."])
