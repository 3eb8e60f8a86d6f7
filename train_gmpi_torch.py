#!/usr/bin/env python
"""Train GMPI with the PyTorch port ``gmpi_tpu_torch`` on CUDA cards (port of
``train_gmpi.py``; the reference's ``launch.py`` / ``run_gmpi.py``):

    python train_gmpi_torch.py --dataset FFHQ256 \\
        --data_root ffhq256x256.zip --pose_root ffhq256_deep3dface_coeffs \\
        --output_dir runs/ffhq256 [--warm_start stylegan2_ffhq256_g.npz \\
        --warm_start_d stylegan2_ffhq256_d.npz]

On N cards of a host, one process a card:

    python -m torch.distributed.run --nproc_per_node N train_gmpi_torch.py \\
        --multihost [--renderer_plane_shards P --renderer_tile_shards T] ...

``--multihost`` initializes ``torch.distributed`` from the environment that
``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``).  ``--device cuda`` is ``cuda:LOCAL_RANK``,
one card a rank, over NCCL; ``--device cuda:0`` pins every rank to card 0,
and where that puts several ranks of a host on one card (NCCL refuses two
ranks on one device) they talk over ``gloo``, which moves the tensors
through host memory; ``--device cpu`` uses ``gloo`` too.  P x T
ranks render each image together (plane / pixel-row shards) and the rest of
the world splits the global batch (``--dataset``'s ``batch_size``) evenly
over data ranks, each reading its own shard of the data; rank 0 writes every
file (``train.loop``).

The flags are those of ``train_gmpi.py`` plus ``--device`` (``cuda`` by
default; ``cpu`` runs the plain PyTorch path), ``--sample_interval`` and
``--model_save_interval``.  Warm-start files are flat ``.npz`` state dicts in
the reference's naming (``train.checkpoint.export_torch_style`` of either
package writes them).  ``--inception_weights`` (a local ``.npz`` or ``.pth``
of InceptionV3 under torchvision names) turns on the in-training FID every
``--fid_interval`` steps against the dataset's first ``--fid_n_imgs``
images.
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
                   help="shard the renderer's plane axis over this many ranks (params and "
                        "batch replicate over them)")
    p.add_argument("--renderer_tile_shards", type=int, default=0,
                   help="additionally shard output pixel rows over this many ranks "
                        "(plane x tile mesh)")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="initialize torch.distributed from the environment of "
                        "python -m torch.distributed.run (one process a card)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: cuda:LOCAL_RANK with --multihost)")
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

    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from gmpi_tpu_torch.config import PRESETS, get_config
    from gmpi_tpu_torch.utils.device import resolve_device

    if args.dataset not in PRESETS:
        p.error(f"--dataset must be one of {sorted(PRESETS)}")
    device = torch.device(args.device)
    pinned = device.index is not None
    if args.multihost and device.type == "cuda" and not pinned:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = resolve_device(device)
    if not args.multihost:
        return _run(args, cfg, stats, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    shared_card = device.type == "cuda" and pinned and local_ranks > 1
    dist.init_process_group("nccl" if device.type == "cuda" and not shared_card else "gloo",
                            init_method="env://")
    try:
        return _run(args, cfg, stats, device)
    finally:
        dist.destroy_process_group()


def _run(args, cfg, stats, device):
    import numpy as np
    import torch

    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.data import ShardedLoader, get_dataset
    from gmpi_tpu_torch.train.loop import make_train_mesh, train

    cfg = cfg or get_config(args.dataset)
    tr = cfg.train
    if args.fused_renderer or args.no_fused_renderer:
        tr = dataclasses.replace(tr, use_fused_renderer=bool(args.fused_renderer))
    if args.renderer_plane_shards or args.renderer_tile_shards:
        tr = dataclasses.replace(tr, renderer_plane_shards=args.renderer_plane_shards,
                                 renderer_tile_shards=args.renderer_tile_shards)
    cfg = dataclasses.replace(cfg, train=tr)
    mesh = make_train_mesh(cfg, device)
    n_data = mesh.size("data")
    if cfg.hparams.batch_size % n_data:
        raise ValueError(f"batch_size {cfg.hparams.batch_size} does not split over {n_data} "
                         f"data ranks")
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
    # each data rank reads its own shard, a share of the global batch at a time
    loader = ShardedLoader(dataset, batch_size=cfg.hparams.batch_size // n_data,
                           shard_id=mesh.index("data"), num_shards=n_data, seed=args.seed)

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
    if args.inception_weights and mesh.rank == 0:  # rank 0 alone computes the FID
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
        mesh=mesh,
    )


if __name__ == "__main__":
    main()
