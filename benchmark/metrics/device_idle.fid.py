"""``device_idle.fid``: the share of the traced window in which no
operation ran on the card (1 - union of device-busy intervals / window), in
percent."""

from benchmark import yardstick


def read(trace, runner):
    window = trace.window[1] - trace.window[0]
    return 100.0 * (1.0 - yardstick.union_length(trace.busy) / window) if window > 0 else None
