"""``render_ms.fid``: host milliseconds a request in the benchmark's
``bench.render`` span, around ``sample_views``, ``render`` and the
synchronize; the mean over the window's requests (traced runs)."""


def read(trace, runner):
    times = runner.render_s
    return 1e3 * sum(times) / len(times) if times else None
