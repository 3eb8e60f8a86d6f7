"""The frozen plain reference against gmpi_tpu_torch at a small size on the
CPU (this test imports both; the reference imports neither the port nor
JAX), and the control: the reference one precision below the stated one,
put in the program's place, fails the cell's limits.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import gmpi

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _tiny  # noqa: E402

REPO = harness.BENCH_DIR.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_models_and_renderer_match_the_port():
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import render_mpi
    from gmpi_tpu_torch.models.discriminator import Discriminator
    from gmpi_tpu_torch.models.generator import Generator

    exp = _tiny.tiny_experiment(32)
    cfg = harness.program_config(exp)
    w = weights.make(exp, 7, "cpu")
    G, D = Generator(cfg.generator_cfg()), Discriminator(cfg.discriminator_cfg())
    G.load_state_dict(weights.split(w, "G"))
    D.load_state_dict(weights.split(w, "D"))
    rG, rD = gmpi.build_models(exp, w, "cpu")
    geom = cfg.plane_geometry(device="cpu")
    xyz = cfg.multi_res_xyz(geom)
    rgeom = gmpi.plane_geometry(exp, exp["planes"]["n_planes"], "cpu")
    assert torch.equal(geom.dhw, rgeom.dhw)
    z = torch.randn((2, 512), generator=torch.Generator().manual_seed(1))
    mpi = G(z, None, xyz, 4, noise_mode="random", generator=torch.Generator().manual_seed(2))
    rmpi = rG(z, None, gmpi.conditioning(exp, rgeom, 32), 4, noise_mode="random",
              generator=torch.Generator().manual_seed(2))
    assert (mpi - rmpi).abs().max() <= 1e-5 * mpi.abs().max()
    c2w, _, _ = poses.sample_sphere_poses(torch.Generator().manual_seed(3), 2, cfg.camera,
                                          device="cpu")
    rays = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, 32, 32), c2w)
    out = render_mpi(mpi, geom.dhw, *rays)
    from benchmark.reference import render

    color, depth = render.render(mpi, rgeom.dhw, *rays)
    assert (out.color - color).abs().max() <= 1e-5 and (out.depth - depth).abs().max() <= 1e-5
    color2, depth2 = render.render(mpi, rgeom.dhw, *rays, plane_chunk=3)
    assert (color2 - color).abs().max() <= 1e-6 and (depth2 - depth).abs().max() <= 1e-6
    pose = torch.randn((2, 16), generator=torch.Generator().manual_seed(4))
    imgs = out.color * 2 - 1
    assert (D(imgs, pose) - rD(imgs, pose)).abs().max() <= 1e-5


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.gmpi, benchmark.reference.render;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'gmpi_tpu', 'gmpi_tpu_torch'));"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _control(cell: str, real: str, resolution: int, judged: str):
    """The checks of the cell, under ``real``'s limits, with the reference
    in the program's place."""
    from benchmark import control

    limits = harness.load_json(harness.BENCH_DIR, "workloads", real)["limits"]
    assert limits, f"{real} has no limits yet"
    with tempfile.TemporaryDirectory() as d:
        root = Path(d) / "bench"
        root.mkdir()
        bench = _tiny.write_bench(root, resolution, limits)
        c = harness.load_cell(cell, root=root, bench=bench)
        return control.checks_of(c, 2**31 + 99, judged, torch.device("cpu"))


@pytest.mark.parametrize("cell,judged", [("tiny-train", "control"), ("tiny-train", "half_batch"),
                                         ("tiny-train", "d_half_batch"),
                                         ("tiny-train", "g_half_batch"),
                                         ("tiny-fid-fused", "control")])
def test_control_fails_the_limits(cell, judged):
    """The control (and the planted half-batch faults) come out not correct
    through the cell's own comparison and limits.  At 256^2, so that the
    configuration's top blocks are bfloat16 ones (float8 in the control)."""
    torch.set_num_threads(4)
    real = "ffhq256-train" if cell.endswith("train") else "ffhq1024-fid-fused"
    checks = _control(cell, real, 256, judged)
    assert not harness.verdict(checks), checks
