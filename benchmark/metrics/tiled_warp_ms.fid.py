"""``tiled_warp_ms.fid``: device milliseconds a request inside the port's
``tiled_warp.*`` spans (``ops/tiled_warp.py``: patches, hats, the two
contractions).  Nothing to read on a route that bypasses the tiled warp."""

from benchmark import yardstick


def read(trace, runner):
    us = yardstick.spans_busy(trace, ["tiled_warp."])
    return us / 1e3 / trace.n if us > 0 and trace.n else None
