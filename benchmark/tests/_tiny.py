"""A tiny configuration and cells for the CPU tests, written into a folder
of their own beside copies of the benchmark's traffic and metric modules."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent


def tiny_experiment(resolution: int = 32, **train) -> dict:
    from gmpi_tpu_torch.config import get_config

    cfg = get_config("FFHQ256")
    cfg = dataclasses.replace(
        cfg, name=f"tiny{resolution}", resolution=resolution, eval_n_planes=6,
        planes=dataclasses.replace(cfg.planes, n_planes=4),
        hparams=dataclasses.replace(cfg.hparams, batch_size=2, img_size=resolution,
                                    tex_size=resolution),
        train=dataclasses.replace(cfg.train, n_view_per_z=2, **train),
        model=dataclasses.replace(cfg.model, channel_base=8 * resolution, channel_max=32))
    return harness.experiment_dict(cfg)


def write_bench(root: Path, resolution: int = 32, limits=None) -> dict:
    """Config ``tiny``, cells ``tiny-train``, ``tiny-fid-fused`` and
    ``tiny-fid-banded`` under ``root``; returns their BENCHMARK.json."""
    for kind in ("traffic", "metrics"):
        shutil.copytree(BENCH / kind, root / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    from benchmark import yardstick

    exp = tiny_experiment(resolution)
    config = {"name": "tiny", "experiment": exp,
              "flops": {"train_step": yardstick.train_step_flops(exp),
                        "fid_request": yardstick.fid_request_flops(exp)}}
    (root / "configs" / "tiny.json").write_text(json.dumps(config))
    cells = {
        "tiny-train": {"kind": "train", "n_images": 8, "start_step": 2000, "check_steps": 3,
                       "loader_workers": 2},
        "tiny-fid-fused": {"kind": "fid", "use_fused": True, "warmup": 1, "check_sample": 2,
                           "check_within": 3},
        "tiny-fid-banded": {"kind": "fid", "use_fused": False, "warmup": 1, "check_sample": 2,
                            "check_within": 3},
    }
    for name, traffic in cells.items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tiny", "traffic": traffic, "chips": 1, "why": "a CPU test",
             "limits": limits or {}}))
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    train, fid = ["tiny-train"], ["tiny-fid-fused", "tiny-fid-banded"]
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = train if m["name"].endswith((".train", "train_img_s")) else fid
    return real
