"""The AFHQCat path of the port at a tiny AFHQ-shaped size on the CPU: the
dataset class's rows against the benchmark's plain reference on its seeded
EG3D-posed folder, the first train steps on those rows against the
reference's train step, and the dataset's ``loader.item`` span.

The configuration keeps AFHQCat's camera (sphere radius 2.7, 3 sigma
poses) and planes (2.55-2.8) at 32^2, 4 planes and narrow channels.
"""

import dataclasses
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.reference import afhq as ref_afhq
from benchmark.reference import gmpi as ref_gmpi
from benchmark.traffic import train as train_traffic
from benchmark.traffic._afhq_data import write_afhq_dataset
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.data import ShardedLoader, get_dataset
from gmpi_tpu_torch.utils import inspect

RES = 32
SEED = 2**31 + 4321
TRAFFIC = {"kind": "train_afhq", "n_images": 6, "start_step": 2000, "check_steps": 2,
           "loader_workers": 2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_afhq() -> dict:
    cfg = get_config("AFHQCat")
    cfg = dataclasses.replace(
        cfg, name="tiny_afhq", resolution=RES, eval_n_planes=6,
        planes=dataclasses.replace(cfg.planes, n_planes=4),
        hparams=dataclasses.replace(cfg.hparams, batch_size=2, img_size=RES, tex_size=RES),
        train=dataclasses.replace(cfg.train, n_view_per_z=2),
        model=dataclasses.replace(cfg.model, channel_base=8 * RES, channel_max=32))
    return harness.experiment_dict(cfg)


@pytest.fixture(scope="module")
def fixture_data(tmp_path_factory):
    exp = tiny_afhq()
    root = tmp_path_factory.mktemp("afhq")
    return exp, write_afhq_dataset(str(root), 5, RES, exp["camera"], seed=11)


def dataset_of(exp, data):
    c = exp["camera"]
    return get_dataset("AFHQCat", dataset_path=data.folder, raw_img_size=RES, img_size=RES,
                       pose_data_path=data.folder, sphere_center=c["sphere_center_z"],
                       sphere_r=c["sphere_r"], flat_pose_dim=exp["train"]["d_cond_pose_dim"])


# -- the rows ------------------------------------------------------------------------


def test_afhq_rows_match_the_reference(fixture_data):
    exp, data = fixture_data
    ds = dataset_of(exp, data)
    assert len(ds) == len(data.images) == 5
    flat = ref_afhq.flat_poses(data.c2w, exp)
    real, pose = ref_gmpi.real_batch(data.images, flat, np.arange(5), "cpu")
    for i in range(5):
        x, p, yaw, pitch = ds[i]
        assert x.shape == (3, RES, RES) and p.shape == (16,)
        assert np.abs(x - real[i].numpy()).max() <= 1e-6
        assert np.abs(p - pose[i].numpy()).max() <= 1e-6
        assert abs(yaw) <= 3 * exp["camera"]["yaw_std"] + 1e-4
        assert abs(pitch) <= 3 * exp["camera"]["pitch_std"] + 1e-4


def test_afhq_cameras_look_at_the_sphere_centre(fixture_data):
    """Each written camera, converted, sits at the sphere's radius from its
    centre and looks straight at it."""
    exp, data = fixture_data
    c = exp["camera"]
    w2c = ref_afhq.flat_poses(data.c2w, exp).reshape(-1, 4, 4).astype(np.float64)
    centre = np.array([0.0, 0.0, c["sphere_center_z"], 1.0])
    seen = w2c @ centre
    assert np.allclose(seen[:, :3], [0.0, 0.0, c["sphere_r"]], atol=1e-5)
    labels = json.loads((Path(data.folder) / "dataset.json").read_text())["labels"]
    assert [len(v) for _, v in labels] == [25] * 5
    assert np.array_equal(np.array([v[:16] for _, v in labels]).reshape(-1, 4, 4), data.c2w)


# -- the first train steps -----------------------------------------------------------


def _cell(root: Path, limits: dict) -> harness.Cell:
    exp = tiny_afhq()
    shutil.copytree(harness.BENCH_DIR / "traffic", root / "traffic",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "workloads"):
        (root / kind).mkdir()
    (root / "configs" / "tiny_afhq.json").write_text(json.dumps({"experiment": exp}))
    (root / "workloads" / "tiny-afhq-train.json").write_text(json.dumps(
        {"config": "tiny_afhq", "traffic": TRAFFIC, "chips": 1, "limits": limits}))
    bench = {"end_to_end": [{"name": "train_img_s", "unit": "images/s"},
                            {"name": "setup_s", "unit": "s"}], "per_layer": []}
    return harness.load_cell("tiny-afhq-train", root=root, bench=bench)


def test_first_train_steps_match_the_reference_and_a_fault_does_not():
    """The port's first steps on the folder's rows against the reference's
    ``TrainStep`` on the same weights, rows and draws: each compared number
    small; the reference with D's and G's losses over half the batch reads
    at least 3x the program's worst on one of them."""
    limits = {k: 1e-4 for k in train_traffic.COMPARED}
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as w:
        cell = _cell(Path(d), limits)
        r = harness.run_cell(cell, SEED, 0.3, False, torch.device("cpu"), 0.0, w)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["train_img_s"]["value"] > 0
    prog = {k: c["value"] for k, c in r["checks"].items()}
    assert set(prog) == set(train_traffic.COMPARED)
    assert r["correct"], r["checks"]
    from benchmark import control

    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as w:
        cell = _cell(Path(d), limits)
        fault = dict((k, v) for k, v, _ in cell.traffic.control_checks(
            control.context(cell, SEED, torch.device("cpu"), w), "half_batch"))
    worst = max(prog.values())
    assert any(v >= 3 * max(worst, 1e-6) for v in fault.values()), (prog, fault)


# -- the span ------------------------------------------------------------------------


def _names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_loader_item_span_once_an_item(fixture_data):
    exp, data = fixture_data
    ds = dataset_of(exp, data)
    inspect.KEPT_SPANS.clear()
    for i in range(3):  # no profiler: no span, nothing kept
        ds[i]
    assert not inspect.KEPT_SPANS
    assert inspect.thread_scope("loader.item") is inspect.profile_scope("x")
    # on the thread that runs the profiler: a record_function an item, kept too
    assert _names(lambda: [ds[i] for i in range(3)]).count("loader.item") == 3
    assert [s[0] for s in inspect.KEPT_SPANS] == ["loader.item"] * 3
    # on the loader's threads, which the profiler does not trace: kept
    inspect.KEPT_SPANS.clear()
    loader = ShardedLoader(ds, batch_size=2, seed=3, num_workers=2)
    batches = []
    _names(lambda: batches.extend(loader.epoch(0)))
    assert len(batches) == 2
    kept = list(inspect.KEPT_SPANS)
    assert len(kept) == 4 and all(name == "loader.item" and end >= start
                                  for name, start, end, _ in kept)
    inspect.KEPT_SPANS.clear()
