"""The MetFaces 1024^2 configuration of the benchmark and the route its cell
runs, on the CPU.

The configuration file is the port's ``MetFaces`` preset, uncut, with the
parameter counts of the port's models and the FLOPs the frozen reference
counts.  Eval's default route (the tile-banded warp, bands planned for the
MetFaces camera, then the over-composite) is held against the benchmark's
plain per-pixel reference on a seeded MPI at 128^2 and 8 planes: at the
corners of the camera's truncated pose range, and through the benchmark's
``fid`` traffic and its check.  The ``composite_ms.fid`` reader is checked
on hand-built traces.
"""

import dataclasses
import json
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import harness, weights, yardstick
from benchmark.reference import gmpi as ref_gmpi
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core.bands import bands_for_config
from gmpi_tpu_torch.eval.harness import FakeImageGenerator
from gmpi_tpu_torch.models.discriminator import Discriminator
from gmpi_tpu_torch.models.generator import Generator

RES = 128
SEED = 2**31 + 2207
CONFIG = json.loads((harness.BENCH_DIR / "configs" / "metfaces1024.json").read_text())
CELL = "metfaces1024-fid-banded"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_metfaces(preset: str = "MetFaces"):
    """The preset cut to 128^2, 8 eval planes and narrow channels; its camera
    and planes kept."""
    cfg = get_config(preset)
    return dataclasses.replace(
        cfg, name=f"tiny_{preset.lower()}", resolution=RES, eval_n_planes=8,
        planes=dataclasses.replace(cfg.planes, n_planes=4),
        hparams=dataclasses.replace(cfg.hparams, batch_size=2, batch_split=1, img_size=RES,
                                    tex_size=RES),
        train=dataclasses.replace(cfg.train, z_dim=32, w_dim=32, n_view_per_z=2),
        model=dataclasses.replace(cfg.model, channel_base=8 * RES, channel_max=16))


# -- the configuration file ----------------------------------------------------------


def test_metfaces1024_file_is_the_preset_uncut():
    assert CONFIG["preset"] == "MetFaces" and CONFIG["reduced"] == []
    assert CONFIG["experiment"] == harness.experiment_dict(get_config("MetFaces"))
    cfg = harness.program_config(CONFIG["experiment"])
    assert harness.experiment_dict(cfg) == CONFIG["experiment"]
    assert (cfg.resolution, cfg.eval_n_planes) == (1024, 96)
    assert (cfg.camera.yaw_std, cfg.camera.pitch_std, cfg.camera.n_truncated_stds) == (
        0.339, 0.133, 2.0)
    with torch.device("meta"):
        G, D = Generator(cfg.generator_cfg()), Discriminator(cfg.discriminator_cfg())
    assert sum(p.numel() for p in G.parameters()) == CONFIG["widths"]["generator_parameters"]
    assert sum(p.numel() for p in D.parameters()) == CONFIG["widths"]["discriminator_parameters"]


@pytest.mark.parametrize("unit", ["fid_request", "train_step"])
def test_metfaces1024_flops_are_the_frozen_counts(unit):
    count = {"fid_request": yardstick.fid_request_flops,
             "train_step": yardstick.train_step_flops}[unit]
    assert CONFIG["flops"][unit] == count(CONFIG["experiment"])


def test_load_cell_finds_both_new_cells():
    bench = json.loads((harness.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for name, config, kind in ((CELL, "metfaces1024", "fid"), ("ffhq1024-train", "ffhq1024",
                                                                "train")):
        cell = harness.load_cell(name)
        assert cell.workload["config"] == config and cell.workload["chips"] == 1
        assert cell.workload["traffic"]["kind"] == kind
        assert set(cell.workload["limits"]) == set(cell.traffic.COMPARED)
        entry = next(w for w in bench["workloads"] if w["name"] == name)
        assert (entry["config"], entry["chips"]) == (config, 1)
    assert harness.load_cell(CELL).workload["traffic"]["use_fused"] is False
    composite = next(m for m in bench["per_layer"] if m["name"] == "composite_ms.fid")
    assert composite["workloads"] == ["ffhq256-fid-banded", CELL]


# -- the banded route against the reference -----------------------------------------


@pytest.fixture(scope="module")
def models():
    cfg = tiny_metfaces()
    exp = harness.experiment_dict(cfg)
    w = weights.make(exp, 22, "cpu")
    G = Generator(cfg.generator_cfg())
    G.load_state_dict(weights.split(w, "G"))
    rG = ref_gmpi.build_models(exp, w, "cpu", with_d=False)
    return cfg, exp, G, rG


def test_planner_takes_the_metfaces_camera():
    """The bands come from the camera given: MetFaces' wider yaw and pitch
    ask for bands at least as wide as FFHQ's at the same size, and wider in
    some field."""
    met = bands_for_config(tiny_metfaces(), n_planes=8, device="cpu")
    ffhq = bands_for_config(tiny_metfaces("FFHQ1024"), n_planes=8, device="cpu")
    assert len(met) == len(ffhq) and all(m >= f for m, f in zip(met, ffhq)) and met != ffhq


@pytest.mark.parametrize("yaw_s,pitch_s", [(1, 1), (-1, -1), (1, -1), (-1, 1), (0, 0)])
def test_banded_render_at_the_metfaces_corners_matches_the_reference(models, yaw_s, pitch_s):
    """A seeded MPI through eval's default route (``FakeImageGenerator``
    with tile bands planned for the MetFaces camera) against the
    reference's per-pixel ``grid_sample`` render, at the corners and the
    centre of the truncated pose range."""
    cfg, exp, G, rG = models
    gen = FakeImageGenerator(cfg, G, use_fused=False, device="cpu")
    assert gen.tiled_bands is not None
    sampler = ref_gmpi.Sampler(exp, rG, "cpu")
    mpi = gen.sample_mpi(5)
    assert (mpi - sampler.mpi(5)).abs().max() <= 1e-5 * mpi.abs().max()
    c = cfg.camera
    yaws = torch.tensor([[yaw_s * c.n_truncated_stds * c.yaw_std]])
    pitches = torch.tensor([[pitch_s * c.n_truncated_stds * c.pitch_std]])
    color, depth = gen.render(mpi, yaws, pitches)
    r_color, r_depth = sampler.view(mpi, yaws, pitches)
    assert color.shape == (1, 3, RES, RES) and float(color.std()) > 0
    # float32 rounding: the taps sum a texel's four neighbours in another order than
    # grid_sample, ~1e-5 of the [0, 1] render, doubled by eval's [-1, 1] colour
    assert (color - r_color).abs().max() <= 2e-5
    assert (depth - r_depth).abs().max() <= 1e-5


def _fid_cell(root: Path, limits: dict) -> harness.Cell:
    shutil.copytree(harness.BENCH_DIR / "traffic", root / "traffic",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "workloads"):
        (root / kind).mkdir()
    exp = harness.experiment_dict(tiny_metfaces())
    (root / "configs" / "tiny_metfaces.json").write_text(json.dumps({"experiment": exp}))
    traffic = dict(harness.load_json(harness.BENCH_DIR, "workloads", CELL)["traffic"],
                   warmup=1, check_sample=2, check_within=3)
    (root / "workloads" / "tiny-metfaces-fid-banded.json").write_text(json.dumps(
        {"config": "tiny_metfaces", "traffic": traffic, "chips": 1, "limits": limits}))
    bench = {"end_to_end": [{"name": "fake_img_s", "unit": "images/s"},
                            {"name": "setup_s", "unit": "s"}], "per_layer": []}
    return harness.load_cell("tiny-metfaces-fid-banded", root=root, bench=bench)


def test_fid_traffic_on_the_banded_route_matches_the_reference():
    """The cell's traffic (its own parameters, fewer requests) on the tiny
    MetFaces configuration, through the harness: the sampled requests' MPI
    and view against the reference's, well inside limits of 1e-5."""
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as w:
        cell = _fid_cell(Path(d), {"mpi_gap": 1e-5, "color_gap": 1e-5})
        r = harness.run_cell(cell, SEED, 0.3, False, torch.device("cpu"), 0.0, w)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["fake_img_s"]["value"] > 0
    assert set(r["checks"]) == {"mpi_gap", "color_gap"}
    assert r["correct"], r["checks"]


# -- the reader ----------------------------------------------------------------------


def _trace(annotations, n=2):
    """Busy 0-10, 20-30, 50-60 and 80-90 of a 100 us window."""
    kernels = [("k1", 0, 10), ("k2", 20, 30), ("k3", 50, 60), ("k4", 80, 90)]
    busy = yardstick.merged((s, e) for _, s, e in kernels)
    return harness.Trace(busy=busy, busy_starts=[s for s, _ in busy], kernels=kernels,
                         annotations=annotations, host=[], window=(0.0, 100.0), n=n,
                         peaks=yardstick.PEAKS)


def _read(trace):
    return harness.load_module(harness.BENCH_DIR, "metrics", "composite_ms.fid").read(trace,
                                                                                        None)


@pytest.mark.parametrize("annotations,ms", [
    # nested in the render's span: only the composite's busy time (25-30, 50-55)
    ([("render.banded", 0, 60), ("render.composite", 25, 55)], (5 + 5) / 2 / 1e3),
    # two requests' spans, one overlapping the other: counted once
    ([("render.composite", 0, 10), ("render.composite", 5, 30), ("tiled_warp.sample", 50, 60)],
     (10 + 10) / 2 / 1e3),
    # a span over an idle stretch reads 0, not None
    ([("render.gather", 30, 50), ("render.composite", 35, 45)], 0.0),
])
def test_composite_reader_reads_the_spans_busy_time(annotations, ms):
    assert _read(_trace(annotations)) == pytest.approx(ms)


@pytest.mark.parametrize("annotations,n", [
    ([("render.banded", 0, 60), ("tiled_warp.sample", 0, 10)], 2),  # an older program
    ([("render.fused", 0, 60)], 2),  # the fused route: no composite span
    ([("render.composite", 0, 60)], 0),  # no whole request
])
def test_composite_reader_reads_nothing_without_the_span(annotations, n):
    assert _read(_trace(annotations, n)) is None
