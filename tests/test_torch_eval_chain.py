"""The port's eval chain end to end on the CPU (``eval_gmpi_torch.run_all``,
the ``gmpi/eval/eval.sh:64-172`` analogue): prepare_real -> prepare_fake ->
fid_kid -> consistency -> geometry on a tiny checkpoint of the port, random
InceptionV3 weights of the port saved as a ``.pth``, and ``chip_smoke``'s
stub adapters standing in for ArcFace / MTCNN / Deep3DFace.  The same
assertions as the JAX package's chain test (``tests/test_eval_chain.py``),
including that a re-run reproduces every number exactly; then the single
tasks, the in-training FID of ``train_gmpi_torch.py --inception_weights``,
and the adapters' ``ImportError`` without their packages.
"""

import json
import os

import numpy as np
import pytest
import torch

import eval_gmpi_torch
import train_gmpi_torch
from gmpi_tpu_torch.data import preprocess
from gmpi_tpu_torch.eval import adapters, inception
from gmpi_tpu_torch.train import checkpoint, init_train_state
from tests.test_torch_train_loop import _ffhq16
from tests.test_torch_train_step import tiny_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain_inputs(tmp_path_factory):
    """A tiny checkpoint (EMA perturbed away from G), random Inception
    weights as a ``.pth`` and an FFHQ-style dataset of 16^2 PNGs."""
    root = tmp_path_factory.mktemp("chain")
    cfg = tiny_config()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    state.ema = {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in state.ema.items()}
    ckpt_dir = str(root / "ckpt")
    os.makedirs(ckpt_dir)
    checkpoint.save_checkpoint(ckpt_dir, state)
    weights = str(root / "inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in inception.random_params(seed=2).items()},
               weights)
    data = _ffhq16(root, n=7)
    return cfg, ckpt_dir, weights, data, state


STUBS = ["--embedder", "chip_smoke:StubEmbedder", "--landmark_detector",
         "chip_smoke:StubDetector", "--pose_estimator", "chip_smoke:StubEstimator"]


def _chain_args(ckpt_dir, weights, data, out):
    return (["--task", "all", "--ckpt", ckpt_dir, "--out", out, "--device", "cpu",
             "--n_imgs", "3", "--n_planes", "4", "--n_consistency", "2", "--n_geometry", "2",
             "--inception_weights", weights] + STUBS + data[2:])  # --data_root, --pose_root


def test_eval_all_chain_with_stub_adapters(tmp_path, chain_inputs):
    cfg, ckpt_dir, weights, data, _ = chain_inputs
    out = str(tmp_path / "eval")
    results = eval_gmpi_torch.main(_chain_args(ckpt_dir, weights, data, out), cfg=cfg)

    assert results == json.load(open(os.path.join(out, "eval_all.json")))
    assert "fid_kid" in results and np.isfinite(results["fid_kid"]["frechet_inception_distance"])
    assert "consistency" in results
    assert -1.0 <= results["consistency"]["consistency_mean"] <= 1.0
    assert "geometry" in results
    assert results["geometry"]["n_evaluated"] == 2
    assert "angle_error_mse" in results["geometry"]
    assert "depth_error_mse" in results["geometry"]
    # artifacts on disk: 3 real images of the 6 usable, fakes at 16^2, geometry at 224^2
    assert len(os.listdir(os.path.join(out, "real"))) == 3
    assert len(os.listdir(os.path.join(out, "fake", "rgb"))) == 3
    assert len(os.listdir(os.path.join(out, "consistency", "rgb"))) == 4
    assert np.load(os.path.join(out, "geometry", "depth", "000000.npy")).shape == (224, 224)

    # determinism: the whole chain re-run reproduces every number EXACTLY
    # (per-image seeds are the reference's reproducibility contract,
    # ``gmpi/eval/prepare_fake_data.py:204``)
    out2 = str(tmp_path / "eval2")
    results2 = eval_gmpi_torch.run_all(
        eval_gmpi_torch.build_parser().parse_args(_chain_args(ckpt_dir, weights, data, out2)),
        cfg=cfg)
    assert results2 == results
    for sub in ("fake/rgb", "consistency/rgb", "geometry/rgb"):
        for name in os.listdir(os.path.join(out, sub)):
            with open(os.path.join(out, sub, name), "rb") as a, \
                    open(os.path.join(out2, sub, name), "rb") as b:
                assert a.read() == b.read(), (sub, name)


def test_single_tasks_and_skips(tmp_path, chain_inputs, capsys):
    cfg, ckpt_dir, weights, data, state = chain_inputs
    base = ["--ckpt", ckpt_dir, "--device", "cpu", "--n_imgs", "3", "--n_planes", "4"]
    fake = str(tmp_path / "fake")
    assert eval_gmpi_torch.main(["--task", "prepare_fake", "--out", fake] + base, cfg=cfg) == {}
    real = str(tmp_path / "real")
    eval_gmpi_torch.main(["--task", "prepare_real", "--out", real, "--n_imgs", "4"] + data[2:],
                         cfg=cfg)
    assert len(os.listdir(real)) == 4
    fid = eval_gmpi_torch.main(["--task", "fid_kid", "--real_dir", real, "--fake_dir",
                                os.path.join(fake, "rgb"), "--inception_weights", weights,
                                "--out", fake, "--device", "cpu"], cfg=cfg)
    assert np.isfinite(fid["frechet_inception_distance"])
    cons = eval_gmpi_torch.main(["--task", "consistency", "--out", str(tmp_path / "c")] + base
                                + STUBS[:2], cfg=cfg)
    assert -1.0 <= cons["consistency_mean"] <= 1.0
    geo = eval_gmpi_torch.main(["--task", "geometry", "--out", str(tmp_path / "g")] + base
                               + STUBS[2:], cfg=cfg)
    assert geo["n_evaluated"] == 3
    for name in ("fid_kid.json", "geometry.json"):
        assert name in os.listdir(fake if name == "fid_kid.json" else tmp_path / "g")

    # the fakes are G's EMA weights rendered: --use_ema pairs them with G's buffers
    g = checkpoint.load_generator(ckpt_dir, cfg, device="cpu")
    for k, p in g.named_parameters():
        assert torch.equal(p, state.ema[k]), k
    for k, b in g.named_buffers():
        assert torch.equal(b, dict(state.G.named_buffers())[k]), k

    # without weights or adapters, all skips those steps (the reference's behaviour)
    capsys.readouterr()
    results = eval_gmpi_torch.main(["--task", "all", "--out", str(tmp_path / "a")] + base,
                                   cfg=cfg)
    assert results == {}
    said = capsys.readouterr().out
    assert "skipping fid_kid" in said and "skipping consistency" in said
    assert "skipping geometry" in said
    with pytest.raises(ValueError, match="landmark_detector"):
        eval_gmpi_torch.main(["--task", "geometry", "--out", str(tmp_path / "x")] + base,
                             cfg=cfg)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            eval_gmpi_torch.main(["--task", "prepare_fake", "--ckpt", ckpt_dir, "--out",
                                  str(tmp_path / "y")], cfg=cfg)


def test_training_cli_logs_fid(tmp_path, chain_inputs):
    cfg, _, weights, data, _ = chain_inputs
    out = str(tmp_path / "run")
    train_gmpi_torch.main(data + ["--output_dir", out, "--device", "cpu", "--total_iters", "2",
                                  "--inception_weights", weights, "--fid_interval", "1",
                                  "--fid_n_imgs", "3", "--sample_interval", "100"], cfg=cfg)
    lines = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    fids = [x["fid"] for x in lines if "fid" in x]
    assert len(fids) == 1 and np.isfinite(fids[0])  # step 1; step 0 computes none


def test_adapters_raise_import_errors_without_their_packages():
    for make in (adapters.MTCNNLandmarkDetector, preprocess.default_detector):
        with pytest.raises(ImportError, match="mtcnn"):
            make()
    with pytest.raises(ImportError, match="deepface"):
        adapters.ArcFaceEmbedder()
    for kw in ({"device": "cpu"}, {}):  # the missing repo is named before the device is resolved
        with pytest.raises(ImportError, match="repo_path"):
            adapters.Deep3DFaceEstimator("/nonexistent/deep3dface", **kw)
    det = adapters.load_adapter("chip_smoke:StubDetector")
    assert isinstance(det, adapters.LandmarkDetector)
    assert isinstance(adapters.load_adapter("chip_smoke:StubEmbedder"), adapters.FaceEmbedder)
    assert isinstance(adapters.load_adapter("chip_smoke:StubEstimator"), adapters.PoseEstimator)
    assert det.detect(np.zeros((10, 20, 3), np.uint8)).shape == (5, 2)
