"""A run whose timed path is broken comes out not correct: the harness's run
(all of it but the look for a card) on a tiny configuration on the CPU, with
the cell's own limits, and one fault planted in the program each time.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import harness

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _tiny  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell: str, real: str):
    limits = harness.load_json(harness.BENCH_DIR, "workloads", real)["limits"]
    assert limits, f"{real} has no limits yet"
    with tempfile.TemporaryDirectory() as d:
        root = Path(d) / "bench"
        root.mkdir()
        bench = _tiny.write_bench(root, 32, limits)
        c = harness.load_cell(cell, root=root, bench=bench)
        with tempfile.TemporaryDirectory() as w:
            return harness.run_cell(c, 2**33 + 7, 0.3, False, torch.device("cpu"), 0.0, w)


def test_sound_runs_are_correct():
    assert _run("tiny-train", "ffhq256-train")["correct"]
    assert _run("tiny-fid-fused", "ffhq1024-fid-fused")["correct"]


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    from gmpi_tpu_torch.train import step as step_mod

    inner = step_mod.TrainStep.__call__

    def unchanged(self, state, *args, **kwargs):
        before = {m: {k: v.clone() for k, v in getattr(state, m).state_dict().items()}
                  for m in ("G", "D")}
        out = inner(self, state, *args, **kwargs)
        for m, sd in before.items():
            getattr(state, m).load_state_dict(sd)
        return out

    monkeypatch.setattr(step_mod.TrainStep, "__call__", unchanged)
    r = _run("tiny-train", "ffhq256-train")
    assert not r["correct"] and r["checks"]["change_median_gap"]["value"] >= 0.99


def test_loss_over_half_the_batch(monkeypatch):
    from gmpi_tpu_torch.train import step as step_mod

    d_inner, g_inner = step_mod.d_gan_loss, step_mod.g_gan_loss
    monkeypatch.setattr(step_mod, "d_gan_loss",
                        lambda r, f: d_inner(r[: len(r) // 2], f[: len(f) // 2]))
    monkeypatch.setattr(step_mod, "g_gan_loss", lambda f: g_inner(f[: max(1, len(f) // 2)]))
    r = _run("tiny-train", "ffhq256-train")
    assert not r["correct"], r["checks"]


def test_g_loss_over_half_the_fakes(monkeypatch):
    """A fault of the G phase alone: G's loss over half of its fakes, D's
    loss whole."""
    from gmpi_tpu_torch.train import step as step_mod

    inner = step_mod.g_gan_loss
    monkeypatch.setattr(step_mod, "g_gan_loss", lambda f: inner(f[: max(1, len(f) // 2)]))
    r = _run("tiny-train", "ffhq256-train")
    assert not r["correct"], r["checks"]
    assert r["checks"]["d_grad_median_gap"]["value"] <= r["checks"]["d_grad_median_gap"]["limit"]


def test_d_loss_over_half_the_batch(monkeypatch):
    """A fault of the D phase alone: D's loss over half of its batch, G's
    loss whole."""
    from gmpi_tpu_torch.train import step as step_mod

    inner = step_mod.d_gan_loss
    monkeypatch.setattr(step_mod, "d_gan_loss",
                        lambda r, f: inner(r[: len(r) // 2], f[: len(f) // 2]))
    r = _run("tiny-train", "ffhq256-train")
    assert not r["correct"], r["checks"]
    assert r["checks"]["g_loss0_gap"]["value"] <= r["checks"]["g_loss0_gap"]["limit"]


def test_answer_altered_where_it_is_produced(monkeypatch):
    from gmpi_tpu_torch.eval import harness as eval_harness

    inner = eval_harness.FakeImageGenerator.sample_mpi
    monkeypatch.setattr(eval_harness.FakeImageGenerator, "sample_mpi",
                        lambda self, seed, batch=1: inner(self, seed + 1, batch))
    r = _run("tiny-fid-fused", "ffhq1024-fid-fused")
    assert not r["correct"], r["checks"]
