"""The readers of the port's own spans (``port_spans`` and the seven metrics
that use it): hand-counted values on a hand-built trace, nothing on a
trace without the port's spans (an older program), and the spans found in a
traced tiny FID cell on the CPU.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import harness, port_spans, yardstick

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _tiny  # noqa: E402

READERS = ("loader_idle_ms.train", "draw_idle_ms.train", "render_device_ms.train",
           "render_device_ms.fid", "gen_device_ms.fid", "gen_idle_ms.fid", "gen_launches.fid")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read(metric: str, trace):
    return harness.load_module(harness.BENCH_DIR, "metrics", metric).read(trace, None)


def _trace(host, annotations, n=2):
    """Busy 0-10, 20-30, 50-60 and 80-90 of a 100 us window."""
    kernels = [("k1", 0, 10), ("k2", 20, 30), ("k3", 50, 60), ("k4", 80, 90)]
    busy = yardstick.merged((s, e) for _, s, e in kernels)
    return harness.Trace(busy=busy, busy_starts=[s for s, _ in busy], kernels=kernels,
                         annotations=annotations, host=sorted(host, key=lambda h: h[1]),
                         window=(0.0, 100.0), n=n, peaks=yardstick.PEAKS)


HOST = [
    ("bench.sample_mpi", 0, 70, 1),    # the benchmark's own span: read by none
    ("loader.wait", 10, 25, 1),        # busy 20-25: idle 10
    ("loader.wait", 95, 105, 1),       # clipped to 95-100: idle 5
    ("host_draw.z", 30, 40, 1),        # merged with the next: 30-55, busy 50-55: idle 20
    ("host_draw.noise", 35, 55, 2),
    ("host_draw.pose", 60, 70, 1),     # idle 10
    ("sampler.mpi", 0, 45, 1),         # busy 0-10, 20-30: idle 25
    ("sampler.mpi", 50, 70, 1),        # busy 50-60: idle 10
    ("cudaLaunchKernel", 1, 2, 1),     # in sampler.mpi
    ("cudaMemcpyAsync", 5, 6, 1),      # not a launch
    ("cudaLaunchKernelExC", 44, 44.5, 3),  # in sampler.mpi's time, another thread
    ("cuLaunchKernel", 46, 47, 1),     # between the two sampler.mpi spans
    ("cudaGraphLaunch", 55, 56, 1),    # in sampler.mpi
    ("cudaLaunchKernel", 75, 76, 1),   # outside
]
ANNOTATIONS = [
    ("render.fused", 20, 30),          # busy 10
    ("render.backward", 50, 60),       # busy 10 (the autograd thread's span)
    ("sampler.mpi", 0, 45),            # busy 20
    ("sampler.mpi", 50, 70),           # busy 10
    ("train_step.d_fakes", 0, 100),
]


def test_readers_by_hand():
    tr = _trace(HOST, ANNOTATIONS)
    expected = {  # milliseconds (or launches) over the trace's 2 units
        "loader_idle_ms.train": (10 + 5) / 2 / 1e3,
        "draw_idle_ms.train": (20 + 10) / 2 / 1e3,
        "render_device_ms.train": (10 + 10) / 2 / 1e3,
        "render_device_ms.fid": (10 + 10) / 2 / 1e3,
        "gen_device_ms.fid": (20 + 10) / 2 / 1e3,
        "gen_idle_ms.fid": (25 + 10) / 2 / 1e3,
        "gen_launches.fid": 3 / 2,
    }
    assert set(expected) == set(READERS)
    for metric, value in expected.items():
        assert read(metric, tr) == pytest.approx(value), metric
    assert port_spans.host_ranges(tr, ["host_draw."]) == [(30, 55), (60, 70)]


def test_readers_read_nothing_without_the_port_spans():
    """An older program's trace (the benchmark's own spans, kernels and
    launches, no span of the port): every reader returns None."""
    host = [("bench.sample_mpi", 0, 45, 1), ("bench.render", 45, 70, 1),
            ("cudaLaunchKernel", 1, 2, 1), ("aten::normal_", 3, 4, 1)]
    tr = _trace(host, [("bench.sample_mpi", 0, 45), ("tiled_warp.hats", 50, 60)])
    for metric in READERS:
        assert read(metric, tr) is None, metric
    assert read("gen_idle_ms.fid", _trace(HOST, ANNOTATIONS, n=0)) is None


def test_a_window_without_a_starved_batch_reads_no_loader_wait():
    """The port's spans there (a step's draws) but no ``loader.wait``: the
    loader never kept the step waiting, 0 ms."""
    host = [h for h in HOST if h[0] != "loader.wait"]
    assert read("loader_idle_ms.train", _trace(host, ANNOTATIONS)) == 0.0
    assert read("draw_idle_ms.train", _trace(host, ANNOTATIONS)) == pytest.approx(0.015)


def test_traced_tiny_fid_cell_finds_the_port_spans():
    """A tiny fused FID cell's window under the profiler on the CPU (host
    activity only): a ``sampler.mpi`` and a ``render.fused`` span a request,
    the idle reader reads the whole span (no device here), no launches."""
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as w:
        root = Path(d) / "bench"
        root.mkdir()
        bench = _tiny.write_bench(root, 32)
        cell = harness.load_cell("tiny-fid-fused", root=root, bench=bench)
        exp = cell.config["experiment"]
        ctx = harness.Context(cell=cell, seed=2**31 + 7, seconds=0.3, trace=True,
                              device=torch.device("cpu"), exp=exp,
                              cfg=harness.program_config(exp), params=cell.workload["traffic"],
                              limits={}, workdir=w)
        runner = cell.traffic.setup(ctx)
        tr, _ = harness._traced_window(runner, 0.3, yardstick.PEAKS, sync=lambda: None)
    names = [h[0] for h in tr.host]
    assert tr.n >= 1
    assert names.count("sampler.mpi") == tr.n and names.count("render.fused") == tr.n
    assert names.count("host_draw.pose") == tr.n
    idle = read("gen_idle_ms.fid", tr)
    spans = port_spans.host_ranges(tr, ["sampler.mpi"])
    assert idle == pytest.approx(sum(e - s for s, e in spans) / 1e3 / tr.n) and idle > 0
    assert read("gen_launches.fid", tr) == 0
    assert read("gen_device_ms.fid", tr) is None  # no device annotations on the CPU
