#!/usr/bin/env python
"""Train GMPI with the PyTorch port ``gmpi_tpu_torch`` on one CUDA card
(port of ``train_gmpi.py``; the reference's ``launch.py`` / ``run_gmpi.py``):

    python train_gmpi_torch.py --dataset FFHQ256 \\
        --data_root ffhq256x256.zip --pose_root ffhq256_deep3dface_coeffs \\
        --output_dir runs/ffhq256 [--warm_start stylegan2_ffhq256_g.npz \\
        --warm_start_d stylegan2_ffhq256_d.npz]

The flags are those of ``train_gmpi.py`` plus ``--device`` (``cuda`` by
default; ``cpu`` runs the plain PyTorch path), ``--sample_interval`` and
``--model_save_interval``.  Warm-start files are flat ``.npz`` state dicts in
the reference's naming (``train.checkpoint.export_torch_style`` of either
package writes them).  ``--inception_weights`` (a local ``.npz`` or ``.pth``
of InceptionV3 under torchvision names) turns on the in-training FID every
``--fid_interval`` steps against the dataset's first ``--fid_n_imgs``
images.  Not ported yet: ``--multihost`` / ``--renderer_*_shards``
(``ROADMAP`` Queue A9).
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True,
                   help="a gmpi_tpu_torch.config.PRESETS key "
                        "(FFHQ256/FFHQ512/FFHQ1024/AFHQCat/MetFaces)")
    p.add_argument("--data_root", required=True, help="image zip/folder path")
    p.add_argument("--pose_root", required=True, help="pose coefficient dir")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--total_iters", type=int, default=None)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--warm_start", default=None,
                   help=".npz state dict (reference naming) to warm start G from")
    p.add_argument("--warm_start_d", default=None,
                   help=".npz state dict to warm start D from (the reference copies BOTH G "
                        "and D from the StyleGAN2 pkl, gmpi/train.py:197-230)")
    p.add_argument("--inception_weights", default=None,
                   help="InceptionV3 weights (.npz/.pth, torchvision names) for "
                        "in-training FID")
    p.add_argument("--fid_interval", type=int, default=5000)
    p.add_argument("--fid_n_imgs", type=int, default=2048)
    p.add_argument("--fused_renderer", action="store_true",
                   help="force the fused CUDA render path (default: fused on a card, the "
                        "gather/banded path on the CPU)")
    p.add_argument("--no_fused_renderer", action="store_true",
                   help="force the gather/banded render path")
    p.add_argument("--renderer_plane_shards", type=int, default=0,
                   help="shard the renderer's plane axis over cards (not ported yet)")
    p.add_argument("--renderer_tile_shards", type=int, default=0,
                   help="shard output pixel rows over cards (not ported yet)")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training (not ported yet)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--sample_interval", type=int, default=200,
                   help="steps between snapshot grids")
    p.add_argument("--model_save_interval", type=int, default=500,
                   help="steps between checkpoints")
    return p


def main(argv=None, cfg=None, stats=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), build the dataset, the
    loader and the warm start, and run ``train``; returns the final
    ``TrainState``.  ``cfg`` replaces the ``--dataset`` preset's config (the
    dataset class still follows ``--dataset``); ``stats`` is a
    ``train.loop.LoopStats`` to fill."""
    p = build_parser()
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from gmpi_tpu_torch.config import PRESETS, get_config
    from gmpi_tpu_torch.data import ShardedLoader, get_dataset
    from gmpi_tpu_torch.train.loop import train
    from gmpi_tpu_torch.utils.device import resolve_device

    if args.dataset not in PRESETS:
        p.error(f"--dataset must be one of {sorted(PRESETS)}")
    if args.multihost or args.renderer_plane_shards > 1 or args.renderer_tile_shards > 1:
        raise NotImplementedError("--multihost and --renderer_*_shards (multi-GPU training) "
                                  "are not ported yet: ROADMAP Queue A9")
    device = resolve_device(args.device)
    cfg = cfg or get_config(args.dataset)
    if args.fused_renderer or args.no_fused_renderer:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, use_fused_renderer=bool(args.fused_renderer)))
    dataset_name = "FFHQ" if args.dataset.startswith("FFHQ") else args.dataset
    dataset = get_dataset(
        dataset_name,
        dataset_path=args.data_root,
        raw_img_size=cfg.resolution,
        img_size=cfg.hparams.img_size,
        pose_data_path=args.pose_root,
        sphere_center=cfg.camera.sphere_center_z,
        sphere_r=cfg.camera.sphere_r,
        flat_pose_dim=cfg.train.d_cond_pose_dim,
    )
    loader = ShardedLoader(dataset, batch_size=cfg.hparams.batch_size, seed=args.seed)

    init_params_g = init_buffers_g = init_params_d = None
    if args.warm_start:
        from gmpi_tpu_torch.models.converter import convert_generator_checkpoint

        with np.load(args.warm_start) as data:
            sd = {k: data[k] for k in data.files}
        init_params_g, init_buffers_g = convert_generator_checkpoint(
            sd, cfg.generator_cfg(), warm_start=True,
            generator=torch.Generator().manual_seed(args.seed))
    if args.warm_start_d:
        from gmpi_tpu_torch.models.converter import convert_discriminator_checkpoint

        with np.load(args.warm_start_d) as data:
            sd_d = {k: data[k] for k in data.files}
        init_params_d = convert_discriminator_checkpoint(
            sd_d, cfg.discriminator_cfg(), warm_start=True,
            generator=torch.Generator().manual_seed(args.seed + 7))

    fid_feature_fn = fid_real_images = None
    if args.inception_weights:
        from gmpi_tpu_torch.eval.inception import load_inception, make_feature_fn

        fid_feature_fn = make_feature_fn(load_inception(args.inception_weights), device=device)
        # the in-training FID's real set: the dataset's first fid_n_imgs images
        # (gmpi/fid_evaluation.py:38-86's real-image cache)
        n_real = min(args.fid_n_imgs, len(dataset))
        fid_real_images = np.stack([np.asarray(dataset[i][0]) for i in range(n_real)])

    return train(
        cfg,
        iter(loader),
        args.output_dir,
        total_iters=args.total_iters,
        resume=not args.no_resume,
        init_params_g=init_params_g,
        init_buffers_g=init_buffers_g,
        init_params_d=init_params_d,
        seed=args.seed,
        sample_interval=args.sample_interval,
        model_save_interval=args.model_save_interval,
        eval_freq=args.fid_interval,
        fid_feature_fn=fid_feature_fn,
        fid_real_images=fid_real_images,
        device=device,
        stats=stats,
    )


if __name__ == "__main__":
    main()
