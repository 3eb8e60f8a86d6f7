"""The benchmark's harness on the CPU: its files found by name, the contract's
names and units, the frozen arithmetic against hand counts, each traffic
kind driven through the harness on a tiny configuration, a cell that lives
in a folder of its own, the trace's reduction, and ``run.py`` without a
card.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import harness, yardstick

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _tiny  # noqa: E402

REPO = harness.BENCH_DIR.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["config"] == entry["config"] and c.workload["chips"] == entry["chips"]
    assert c.workload["why"] == entry["why"]
    assert callable(c.traffic.setup)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_module(harness.BENCH_DIR, "metrics", m["name"]).read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_is_the_preset(config):
    """The file holds the configuration as it is run: the port's preset,
    field for field, and the FLOPs the frozen reference counts."""
    from gmpi_tpu_torch.config import get_config

    c = harness.load_json(harness.BENCH_DIR, "configs", config)
    assert c["experiment"] == harness.experiment_dict(get_config(c["preset"]))
    assert harness.experiment_dict(harness.program_config(c["experiment"])) == c["experiment"]
    assert c["reduced"] == next(b for b in BENCH["configs"] if b["name"] == config)["reduced"]
    assert c["flops"]["fid_request"] == yardstick.fid_request_flops(c["experiment"])
    assert c["flops"]["train_step"] == yardstick.train_step_flops(c["experiment"])


def test_render_cost_by_hand():
    cost = yardstick.render_cost(2, 3, 4, 5, 6, 7)
    assert cost["bytes"] == 2 * 3 * 4 * 6 * 7 * 4 + 2 * 4 * 4 * 5 * 4
    assert cost["flops"] == 2 * 3 * 4 * 5 * 4 * 21
    least = yardstick.least_seconds_render(cost, yardstick.PEAKS)
    assert least == max(cost["bytes"] / 3.35e12, cost["flops"] / 67e12)


def test_flops_by_precision_by_hand():
    x = torch.empty((2, 3, 8, 8), device="meta")
    w = torch.empty((5, 3, 3, 3), device="meta")
    with yardstick.count_flops() as c:
        torch.nn.functional.conv2d(x, w, padding=1)
        torch.nn.functional.conv2d(x.bfloat16(), w.bfloat16(), padding=1)
        torch.empty((4, 6), device="meta") @ torch.empty((6, 7), device="meta")
    conv = 2 * 2 * 5 * 3 * 9 * 8 * 8
    assert c.flops == {"tf32": conv, "bf16": conv, "fp32": 2 * 4 * 6 * 7}
    assert yardstick.least_seconds_flops(c.flops, yardstick.PEAKS) == pytest.approx(
        conv / 495e12 + conv / 989e12 + 2 * 4 * 6 * 7 / 67e12)


def _run_tiny(cell: str, resolution: int = 32, limits=None, seconds: float = 0.5):
    with tempfile.TemporaryDirectory() as d:
        root = Path(d) / "bench"
        root.mkdir()
        bench = _tiny.write_bench(root, resolution, limits)
        c = harness.load_cell(cell, root=root, bench=bench)
        with tempfile.TemporaryDirectory() as w:
            return harness.run_cell(c, 2**31 + 12345, seconds, False, torch.device("cpu"), 0.0, w)


@pytest.mark.parametrize("cell,resolution,e2e", [
    ("tiny-train", 32, "train_img_s"),
    ("tiny-fid-fused", 32, "fake_img_s"),
    ("tiny-fid-banded", 128, "fake_img_s"),
])
def test_traffic_drives_a_tiny_cell(cell, resolution, e2e):
    """Each traffic kind through the harness's own functions, from a cell
    defined in a folder of its own: the port on the CPU agrees with the
    reference to rounding."""
    compared = [k for kind in ("train", "fid")
                for k in harness.load_module(harness.BENCH_DIR, "traffic", kind).COMPARED]
    r = _run_tiny(cell, resolution, limits={k: 1e-4 for k in compared})
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"][e2e]["value"] > 0 and r["metrics"]["setup_s"]["value"] > 0
    assert r["correct"], r["checks"]


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ffhq256-train",
                           "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                      "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_traced_window_reads_the_profiler():
    """The window under the profiler (host activity only on the CPU): its
    span found, the host's events kept, the units counted."""

    class Runner:
        def run_one(self, i):
            torch.ones(64).sum()

    tr, window_s = harness._traced_window(Runner(), 0.05, yardstick.PEAKS, sync=lambda: None)
    assert tr.n >= 1 and window_s > 0 and tr.window[1] > 0 and not tr.kernels
    assert any(name.startswith("aten::") for name, *_ in tr.host)
    assert harness.breakdown(tr)["idle_gaps"][0][1] > 0


def _trace(kernels, annotations, window=(0.0, 100.0), n=2):
    busy = yardstick.merged((s, e) for _, s, e in kernels)
    return harness.Trace(busy=busy, busy_starts=[s for s, _ in busy], kernels=kernels,
                         annotations=annotations, host=[("bench.data", 40, 55, 1)],
                         window=window, n=n, peaks=yardstick.PEAKS)


def test_trace_reduction():
    kernels = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("a", 60, 70), ("c", 80, 90)]
    ann = [("train_step.d_fakes", 0, 10), ("train_step.worst_views", 30, 40),
           ("train_step.d_fakes", 60, 70), ("train_step.worst_views", 80, 85),
           ("tiled_warp.hats", 5, 20)]
    tr = _trace(kernels, ann)
    assert yardstick.union_length(tr.busy) == 50
    assert yardstick.train_phases(tr) == ((20 + 10) / 2, (10 + 10) / 2)
    assert yardstick.spans_busy(tr, ["tiled_warp."]) == 15
    idle = harness.load_module(harness.BENCH_DIR, "metrics", "device_idle.train").read(tr, None)
    assert idle == pytest.approx(50.0)
    b = harness.breakdown(tr)
    assert b["device_ops"][0][0] == "a" and b["device_ops"][0][1] == pytest.approx(20e-6)
    assert ["bench.data", pytest.approx(20e-6)] in b["idle_gaps"]
    assert yardstick.train_phases(_trace(kernels, [])) is None
