"""``d_phase_ms.train``: device milliseconds a step in the D phase (fakes, D
on real and fake with R1, its backward and update), from the port's
``train_step.*`` spans (``yardstick.train_phases``)."""

from benchmark import yardstick


def read(trace, runner):
    phases = yardstick.train_phases(trace)
    return None if phases is None else phases[0] / 1e3
