"""The ``train_afhq`` traffic and the ``loader_item_ms.train`` reader on the
CPU: the control and the planted half-batch faults fail the
``afhqcat512-train`` limits on a tiny AFHQ-shaped configuration, the
reader's value by hand, and the reference's AFHQ rows import neither the
port nor JAX.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, yardstick

REPO = harness.BENCH_DIR.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_afhq(resolution: int) -> dict:
    """AFHQCat's camera and planes at ``resolution``, 4 planes, batch 2,
    narrow channels."""
    from gmpi_tpu_torch.config import get_config

    cfg = get_config("AFHQCat")
    cfg = dataclasses.replace(
        cfg, name=f"tiny_afhq{resolution}", resolution=resolution, eval_n_planes=6,
        planes=dataclasses.replace(cfg.planes, n_planes=4),
        hparams=dataclasses.replace(cfg.hparams, batch_size=2, img_size=resolution,
                                    tex_size=resolution),
        train=dataclasses.replace(cfg.train, n_view_per_z=2),
        model=dataclasses.replace(cfg.model, channel_base=8 * resolution, channel_max=32))
    return harness.experiment_dict(cfg)


def tiny_cell(root: Path, resolution: int, limits: dict) -> harness.Cell:
    shutil.copytree(harness.BENCH_DIR / "traffic", root / "traffic",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    (root / "configs" / "tiny_afhq.json").write_text(
        json.dumps({"experiment": tiny_afhq(resolution)}))
    traffic = {"kind": "train_afhq", "n_images": 8, "start_step": 2000, "check_steps": 3,
               "loader_workers": 2}
    (root / "workloads" / "tiny-afhq-train.json").write_text(json.dumps(
        {"config": "tiny_afhq", "traffic": traffic, "chips": 1, "limits": limits}))
    bench = {"end_to_end": [], "per_layer": []}
    return harness.load_cell("tiny-afhq-train", root=root, bench=bench)


@pytest.mark.parametrize("judged", ["control", "half_batch", "d_half_batch", "g_half_batch"])
def test_control_fails_the_afhq_limits(judged):
    """The reference one precision below (and the half-batch faults) in the
    program's place come out not correct under ``afhqcat512-train``'s
    limits.  At 256^2, so that the top blocks are bfloat16 ones (float8 in
    the control)."""
    from benchmark import control

    torch.set_num_threads(4)
    limits = harness.load_json(harness.BENCH_DIR, "workloads", "afhqcat512-train")["limits"]
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as w:
        root = Path(d) / "bench"
        root.mkdir()
        cell = tiny_cell(root, 256, limits)
        ctx = control.context(cell, 2**31 + 99, torch.device("cpu"), w)
        checks = cell.traffic.control_checks(ctx, judged)
    assert [k for k, _, _ in checks] == list(cell.traffic.COMPARED)
    assert not harness.verdict(checks), checks


def _trace(n: int) -> harness.Trace:
    return harness.Trace(busy=[], busy_starts=[], kernels=[], annotations=[], host=[],
                         window=(0.0, 100.0), n=n, peaks=yardstick.PEAKS)


def test_loader_item_reader_by_hand(monkeypatch):
    from gmpi_tpu_torch.utils import inspect

    read = harness.load_module(harness.BENCH_DIR, "metrics", "loader_item_ms.train").read
    kept = [("loader.item", 0, 2_000_000, 1), ("loader.item", 5, 4_000_005, 2),
            ("loader.other", 0, 9_000_000, 1)]
    monkeypatch.setattr(inspect, "KEPT_SPANS", kept)
    # the mean item (3 ms) times a batch of 4
    assert read(_trace(3), SimpleNamespace(bs=4)) == pytest.approx(12.0)
    assert read(_trace(0), SimpleNamespace(bs=4)) is None
    monkeypatch.setattr(inspect, "KEPT_SPANS", kept[2:])
    assert read(_trace(3), SimpleNamespace(bs=4)) is None
    monkeypatch.delattr(inspect, "KEPT_SPANS")  # an older program
    assert read(_trace(3), SimpleNamespace(bs=4)) is None


def test_afhq_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.afhq, benchmark.traffic._afhq_data;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'gmpi_tpu', 'gmpi_tpu_torch'));"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
