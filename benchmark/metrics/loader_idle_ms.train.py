"""``loader_idle_ms.train``: milliseconds a step in which the card ran
nothing while the host waited in the port's ``loader.wait`` span
(``data/loader.py``: a batch not yet decoded when the step asked for it).
A window in which no batch starved reads 0 where the program marks its
spans (its ``host_draw.*`` spans are there), and nothing where it has none."""

from benchmark import port_spans


def read(trace, runner):
    value = port_spans.idle_ms(trace, ["loader.wait"])
    if value is None and trace.n and port_spans.host_ranges(trace, ["host_draw."]):
        return 0.0
    return value
