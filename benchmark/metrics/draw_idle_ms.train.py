"""``draw_idle_ms.train``: milliseconds a step in which the card ran
nothing while the host was in the port's ``host_draw.*`` spans: z
(``train/step.py``), camera and light angles (``core/poses.py``) and the
synthesis noise (``models/layers.py``), each drawn on the host and copied to
the card."""

from benchmark import port_spans


def read(trace, runner):
    return port_spans.idle_ms(trace, ["host_draw."])
