"""``loader_item_ms.train``: host milliseconds a step inside the port's
``loader.item`` spans (``data/datasets.py``: one dataset item's decode and
pose conversion, on the loader's threads), summed over threads: the mean
span of the items decoded while the profiler ran, times the items a step
takes (its batch).

The profiler does not trace the loader's threads; the port keeps those
spans itself while a profiler runs (``utils.inspect.KEPT_SPANS``).  A
program without them reports nothing."""


def read(trace, runner):
    try:
        from gmpi_tpu_torch.utils import inspect
    except ImportError:
        return None
    ns = [end - start for name, start, end, _ in getattr(inspect, "KEPT_SPANS", ())
          if name == "loader.item"]
    if not ns or not trace.n:
        return None
    return sum(ns) / len(ns) / 1e6 * runner.bs
