"""``data_wait_ms.train``: host milliseconds a step waits in the benchmark's
``bench.data`` span, around ``next()`` of the port's loader and the copy of
the batch to the card; the mean over the window's steps."""


def read(trace, runner):
    waits = runner.data_wait_s
    return 1e3 * sum(waits) / len(waits) if waits else None
