#!/usr/bin/env python
"""Evaluate a checkpoint of the PyTorch port ``gmpi_tpu_torch`` on one CUDA
card (port of ``eval_gmpi.py``; the reference's ``gmpi/eval/eval.sh``).

Tasks: prepare_real | prepare_fake | fid_kid | consistency | geometry | all.

    python eval_gmpi_torch.py --task prepare_fake --dataset FFHQ256 \\
        --ckpt runs/ffhq256/checkpoints --out eval_out --n_imgs 2048
    python eval_gmpi_torch.py --task fid_kid --real_dir eval_real \\
        --fake_dir eval_out/rgb --inception_weights pt_inception.pth
    python eval_gmpi_torch.py --task all --ckpt runs/ffhq256/checkpoints \\
        --data_root ffhq256x256.zip --pose_root ffhq256_deep3dface_coeffs \\
        --inception_weights pt_inception.pth \\
        --embedder gmpi_tpu_torch.eval.adapters:ArcFaceEmbedder \\
        --landmark_detector gmpi_tpu_torch.eval.adapters:MTCNNLandmarkDetector \\
        --pose_estimator my_module:deep3dface_estimator

The flags are those of ``eval_gmpi.py`` plus ``--device`` (``cuda`` by
default; ``cpu`` runs the plain PyTorch path).  ``--ckpt`` is a checkpoint
directory of ``train_gmpi_torch.py``; with ``--use_ema`` (the default) G
renders with its EMA parameters.  FID/KID need local InceptionV3 weights
(``.npz`` or ``.pth`` under torchvision names); identity consistency and
pose estimation take external models through ``"module:attr"`` adapters
(``gmpi_tpu_torch.eval.adapters``), as the reference runs them in separate
environments (``eval.sh:58-62``).  ``--task all`` skips a step whose weights
or adapters are not given, as the reference does.
"""

from __future__ import annotations

import argparse
import copy
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", required=True,
                   choices=["prepare_real", "prepare_fake", "fid_kid",
                            "consistency", "geometry", "all"])
    p.add_argument("--dataset", default="FFHQ256")
    p.add_argument("--ckpt", default=None, help="checkpoint dir (with 'latest')")
    p.add_argument("--use_ema", action="store_true", default=True)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--n_imgs", type=int, default=2048)
    p.add_argument("--n_planes", type=int, default=96)
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--chunk_n_planes", type=int, default=-1)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--fused_renderer", action="store_true",
                   help="render through the fused CUDA kernel (default: the banded path)")
    p.add_argument("--stylegan2_sanity_check", action="store_true",
                   help="force all alphas to 1 (validates renderer+eval plumbing "
                        "against vanilla StyleGAN2; eval.sh:43-47)")
    # prepare_real
    p.add_argument("--data_root", default=None)
    p.add_argument("--pose_root", default=None)
    # fid_kid
    p.add_argument("--real_dir", default=None)
    p.add_argument("--fake_dir", default=None)
    p.add_argument("--inception_weights", default=None)
    # consistency / geometry external-model adapters (gmpi_tpu_torch.eval.adapters)
    p.add_argument("--embedder", default=None,
                   help='"module:attr" FaceEmbedder (e.g. '
                        'gmpi_tpu_torch.eval.adapters:ArcFaceEmbedder)')
    p.add_argument("--embedder_module", default=None,
                   help="legacy: python module exposing embed(img) -> vec")
    p.add_argument("--landmark_detector", default=None,
                   help='"module:attr" LandmarkDetector (e.g. '
                        'gmpi_tpu_torch.eval.adapters:MTCNNLandmarkDetector)')
    p.add_argument("--pose_estimator", default=None,
                   help='"module:attr" PoseEstimator (Deep3DFace glue)')
    p.add_argument("--n_consistency", type=int, default=1024)
    p.add_argument("--n_geometry", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def _config(args, cfg=None):
    from gmpi_tpu_torch.config import get_config

    return cfg or get_config(args.dataset)


def build_generator(args, cfg=None):
    """``(cfg, FakeImageGenerator)`` of the checkpoint under ``args.ckpt``:
    G's saved state, with the EMA parameters when ``args.use_ema``."""
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.train.checkpoint import load_generator

    cfg = _config(args, cfg)
    G = load_generator(args.ckpt, cfg, use_ema=args.use_ema, device=args.device)
    return cfg, FakeImageGenerator(
        cfg, G, n_planes=args.n_planes, img_size=args.img_size,
        chunk_n_planes=args.chunk_n_planes, truncation_psi=args.truncation_psi,
        sanity_full_alpha=args.stylegan2_sanity_check, use_fused=args.fused_renderer,
        device=args.device)


def _dataset(args, cfg):
    from gmpi_tpu_torch.data import get_dataset

    name = "FFHQ" if args.dataset.startswith("FFHQ") else args.dataset
    return get_dataset(
        name, dataset_path=args.data_root, raw_img_size=cfg.resolution,
        img_size=args.img_size or cfg.resolution, pose_data_path=args.pose_root,
        sphere_center=cfg.camera.sphere_center_z, sphere_r=cfg.camera.sphere_r,
        flat_pose_dim=cfg.train.d_cond_pose_dim)


def _feature_fn(args):
    from gmpi_tpu_torch.eval.inception import load_inception, make_feature_fn

    return make_feature_fn(load_inception(args.inception_weights), device=args.device)


def _resolve_embedder(args):
    if args.embedder:
        from gmpi_tpu_torch.eval.adapters import load_adapter

        return load_adapter(args.embedder).embed
    if not args.embedder_module:
        raise ValueError("consistency needs --embedder (module:attr) or --embedder_module")
    import importlib

    return importlib.import_module(args.embedder_module).embed


def _write_json(out_dir: str, name: str, metrics) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics), flush=True)


def run_all(args, cfg=None) -> dict:
    """One-command chain (``gmpi/eval/eval.sh:64-172``): prepare_real ->
    prepare_fake -> fid_kid -> consistency -> geometry.  Steps whose external
    dependency is absent are skipped with a notice.  Writes and returns the
    results (``out/eval_all.json``)."""
    from gmpi_tpu_torch.eval.adapters import load_adapter
    from gmpi_tpu_torch.eval.harness import (
        compute_consistency_dir, compute_fid_kid_dirs, compute_geometry_dir,
        prepare_fake_images, prepare_real_images)

    os.makedirs(args.out, exist_ok=True)
    results = {}

    # 1. real images
    real_dir = args.real_dir or os.path.join(args.out, "real")
    if args.data_root:
        prepare_real_images(_dataset(args, _config(args, cfg)), real_dir, args.n_imgs)

    # 2. fakes + FID/KID
    cfg, gen = build_generator(args, cfg)
    fake_dir = os.path.join(args.out, "fake")
    prepare_fake_images(gen, fake_dir, args.n_imgs, task="fid_kid")
    if args.inception_weights and os.path.isdir(real_dir):
        results["fid_kid"] = compute_fid_kid_dirs(
            real_dir, os.path.join(fake_dir, "rgb"), _feature_fn(args))
    else:
        print("[all] skipping fid_kid (need --inception_weights and real images)")

    # 3. consistency (2 views / z)
    if args.embedder or args.embedder_module:
        cons_dir = os.path.join(args.out, "consistency")
        prepare_fake_images(gen, cons_dir, args.n_consistency, task="consistency")
        results["consistency"] = compute_consistency_dir(
            cons_dir, args.n_consistency, _resolve_embedder(args))
    else:
        print("[all] skipping consistency (need --embedder)")

    # 4. geometry (224^2 renders, depth + angles)
    if args.landmark_detector and args.pose_estimator:
        geo_args = copy.copy(args)
        geo_args.img_size = args.img_size or 224
        _, geo_gen = build_generator(geo_args, cfg)
        geo_dir = os.path.join(args.out, "geometry")
        prepare_fake_images(geo_gen, geo_dir, args.n_geometry, task="geometry")
        results["geometry"] = compute_geometry_dir(
            geo_dir, args.n_geometry,
            load_adapter(args.landmark_detector), load_adapter(args.pose_estimator))
    else:
        print("[all] skipping geometry (need --landmark_detector/--pose_estimator)")

    _write_json(args.out, "eval_all.json", results)
    return results


def main(argv=None, cfg=None) -> dict:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run the task; returns
    its metrics (empty for the two prepare tasks).  ``cfg`` replaces the
    ``--dataset`` preset's config."""
    args = build_parser().parse_args(argv)
    if args.task == "all":
        return run_all(args, cfg)

    from gmpi_tpu_torch.eval import harness

    if args.task == "prepare_real":
        n = harness.prepare_real_images(_dataset(args, _config(args, cfg)), args.out,
                                        args.n_imgs)
        print(f"wrote {n} real images to {args.out}")
        return {}
    if args.task == "prepare_fake":
        _, gen = build_generator(args, cfg)
        harness.prepare_fake_images(gen, args.out, args.n_imgs, task="fid_kid")
        print(f"wrote {args.n_imgs} fake images to {args.out}")
        return {}
    if args.task == "fid_kid":
        if not (args.inception_weights and args.real_dir and args.fake_dir):
            raise ValueError("fid_kid needs --inception_weights, --real_dir and --fake_dir")
        metrics = harness.compute_fid_kid_dirs(args.real_dir, args.fake_dir, _feature_fn(args))
        _write_json(args.out, "fid_kid.json", metrics)
        return metrics
    if args.task == "consistency":
        _, gen = build_generator(args, cfg)
        harness.prepare_fake_images(gen, args.out, args.n_imgs, task="consistency")
        metrics = harness.compute_consistency_dir(args.out, args.n_imgs,
                                                  _resolve_embedder(args))
        _write_json(args.out, "consistency.json", metrics)
        return metrics
    # geometry
    from gmpi_tpu_torch.eval.adapters import load_adapter

    if not (args.landmark_detector and args.pose_estimator):
        raise ValueError("geometry needs --landmark_detector and --pose_estimator adapters")
    if args.img_size is None:
        args.img_size = 224  # the reference renders geometry at 224^2 (eval.sh:61)
    _, gen = build_generator(args, cfg)
    harness.prepare_fake_images(gen, args.out, args.n_imgs, task="geometry")
    metrics = harness.compute_geometry_dir(args.out, args.n_imgs,
                                           load_adapter(args.landmark_detector),
                                           load_adapter(args.pose_estimator))
    _write_json(args.out, "geometry.json", metrics)
    return metrics


if __name__ == "__main__":
    main()
