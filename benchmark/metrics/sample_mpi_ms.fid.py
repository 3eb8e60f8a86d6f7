"""``sample_mpi_ms.fid``: host milliseconds a request in the benchmark's
``bench.sample_mpi`` span, around ``FakeImageGenerator.sample_mpi`` and a
synchronize (traced runs only); the mean over the window's requests."""


def read(trace, runner):
    times = runner.sample_s
    return 1e3 * sum(times) / len(times) if times else None
