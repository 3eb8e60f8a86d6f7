"""``g_phase_ms.train``: device milliseconds a step in the G phase (worst
views, G through the renderer and D, its backward and update), from the
port's ``train_step.*`` spans (``yardstick.train_phases``)."""

from benchmark import yardstick


def read(trace, runner):
    phases = yardstick.train_phases(trace)
    return None if phases is None else phases[1] / 1e3
