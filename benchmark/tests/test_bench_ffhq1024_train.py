"""``ffhq1024-train``'s limits on the CPU: the control (the reference one
precision below) and the three planted half-batch faults, put in the
program's place in a tiny train cell, come out not correct through the
train kind's own comparison.  At 256^2, so that the configuration's top
blocks are bfloat16 ones (float8 in the control).

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


@pytest.mark.parametrize("judged", ["control", "half_batch", "d_half_batch", "g_half_batch"])
def test_control_and_faults_fail_the_ffhq1024_train_limits(judged):
    from benchmark import control

    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        limits = harness.load_json(harness.BENCH_DIR, "workloads", "ffhq1024-train")["limits"]
        with tempfile.TemporaryDirectory() as d:
            root = Path(d) / "bench"
            root.mkdir()
            bench = _tiny.write_bench(root, 256, limits)
            cell = harness.load_cell("tiny-train", root=root, bench=bench)
            checks = control.checks_of(cell, 2**31 + 1024, judged, torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    assert {name for name, _, _ in checks} == set(limits)
    assert not harness.verdict(checks), checks
