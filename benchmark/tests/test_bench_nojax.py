"""No JAX on the benchmark's path: in a fresh process, import ``run.py``'s
harness, every traffic and metric module, and drive each traffic kind
through a tiny CPU run, which loads the port's modules those use; then no
entry of ``sys.modules`` has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``gmpi_tpu`` (``gmpi_tpu_torch`` does not match).

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from benchmark import harness

CHILD = r"""
import sys, tempfile, torch
from pathlib import Path
sys.path.insert(0, '.'); sys.path.insert(0, 'benchmark/tests')
torch.set_num_threads(1)
import runpy
runpy.run_path('benchmark/run.py', run_name='not_main')
from benchmark import harness
import _tiny
for kind in ('traffic', 'metrics'):
    for p in sorted((harness.BENCH_DIR / kind).glob('*.py')):
        if not p.name.startswith('_'):
            harness.load_module(harness.BENCH_DIR, kind, p.stem)
with tempfile.TemporaryDirectory() as d:
    root = Path(d) / 'bench'; root.mkdir()
    bench = _tiny.write_bench(root, 32)
    for cell in ('tiny-train', 'tiny-fid-fused'):
        c = harness.load_cell(cell, root=root, bench=bench)
        with tempfile.TemporaryDirectory() as w:
            harness.run_cell(c, 5, 0.2, False, torch.device('cpu'), 0.0, w)
assert 'gmpi_tpu_torch.train.step' in sys.modules and 'gmpi_tpu_torch.eval.harness' in sys.modules
print(harness.forbidden_modules())
sys.exit(1 if harness.forbidden_modules() else 0)
"""


def test_no_jax_on_the_benchmark_path():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=harness.BENCH_DIR.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("gmpi_tpu_torch_probe", sys)
    try:
        assert "gmpi_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["gmpi_tpu_torch_probe"]
    assert Path(harness.__file__).name == "harness.py"
