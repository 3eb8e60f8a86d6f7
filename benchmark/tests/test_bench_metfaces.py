"""The ``metfaces1024-fid-banded`` cell on the CPU, on a MetFaces-shaped
configuration cut in size (the preset's camera and planes): the control
(the reference one precision below) fails the cell's limits, and a traced
window opens one ``render.composite`` span a request on the banded route.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import harness, yardstick

CELL = "metfaces1024-fid-banded"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(root: Path, resolution: int) -> harness.Cell:
    """The cell's traffic (fewer requests) and limits on the MetFaces preset
    cut to ``resolution``^2, 6 eval planes and narrow channels."""
    from gmpi_tpu_torch.config import get_config

    for kind in ("traffic", "metrics"):
        shutil.copytree(harness.BENCH_DIR / kind, root / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "workloads"):
        (root / kind).mkdir()
    cfg = get_config("MetFaces")
    cfg = dataclasses.replace(
        cfg, name=f"tiny_metfaces{resolution}", resolution=resolution, eval_n_planes=6,
        planes=dataclasses.replace(cfg.planes, n_planes=4),
        hparams=dataclasses.replace(cfg.hparams, batch_size=2, batch_split=1,
                                    img_size=resolution, tex_size=resolution),
        model=dataclasses.replace(cfg.model, channel_base=8 * resolution, channel_max=32))
    (root / "configs" / "tiny_metfaces.json").write_text(json.dumps(
        {"experiment": harness.experiment_dict(cfg)}))
    real = harness.load_json(harness.BENCH_DIR, "workloads", CELL)
    traffic = dict(real["traffic"], warmup=1, check_sample=2, check_within=3,
                   check_plane_chunk=0)
    (root / "workloads" / "tiny-metfaces.json").write_text(json.dumps(
        {"config": "tiny_metfaces", "traffic": traffic, "chips": 1, "limits": real["limits"]}))
    bench = json.loads((harness.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"] = ["tiny-metfaces"]
    return harness.load_cell("tiny-metfaces", root=root, bench=bench)


def test_control_fails_the_metfaces_limits():
    """At 256^2, so that the top blocks are bfloat16 ones (float8 in the
    control)."""
    from benchmark import control

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as d:
        cell = _cell(Path(d), 256)
        checks = control.checks_of(cell, 2**31 + 22, "control", torch.device("cpu"))
    assert not harness.verdict(checks), checks


def test_traced_tiny_banded_cell_opens_render_composite():
    """A traced window on the CPU (host activity only): one
    ``render.banded`` and one ``render.composite`` a request; the reader
    finds no device annotation there and reads nothing."""
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as w:
        root = Path(d) / "bench"
        root.mkdir()
        cell = _cell(root, 128)
        assert "composite_ms.fid" in {m["name"] for m in cell.per_layer}
        exp = cell.config["experiment"]
        ctx = harness.Context(cell=cell, seed=2**31 + 23, seconds=0.3, trace=True,
                              device=torch.device("cpu"), exp=exp,
                              cfg=harness.program_config(exp), params=cell.workload["traffic"],
                              limits={}, workdir=w)
        runner = cell.traffic.setup(ctx)
        tr, _ = harness._traced_window(runner, 0.3, yardstick.PEAKS, sync=lambda: None)
        reader = harness.load_module(root, "metrics", "composite_ms.fid")
    names = [h[0] for h in tr.host]
    assert tr.n >= 1
    assert names.count("render.banded") == tr.n and names.count("render.composite") == tr.n
    assert reader.read(tr, runner) is None
