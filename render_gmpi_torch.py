#!/usr/bin/env python
"""Render a checkpoint of the PyTorch port ``gmpi_tpu_torch`` on one CUDA
card (port of ``render_gmpi.py``; the reference's
``gmpi/eval/vis/render_video.py`` and ``extract_mesh.py``): a camera-path
video, the middle frame, MPI plane sheets and, with ``--mesh``, a ``.ply``
mesh of the alpha volume.

    python render_gmpi_torch.py --dataset FFHQ256 --ckpt runs/ffhq256/checkpoints \\
        --out vis/ --seed 7 --nplanes 96 [--vertical] [--mesh]

The flags are those of ``render_gmpi.py`` plus ``--device`` (``cuda`` by
default).  G renders with its EMA parameters.  Videos are mp4 when
``imageio`` with its ffmpeg backend is installed, else PNG frame
directories.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="FFHQ256")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nplanes", type=int, default=96)
    p.add_argument("--n_frames", type=int, default=100)
    p.add_argument("--vertical", action="store_true")
    p.add_argument("--chunk_n_planes", type=int, default=-1)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--mesh", action="store_true", help="also extract a .ply mesh")
    p.add_argument("--mesh_planes", type=int, default=128)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def main(argv=None, cfg=None) -> dict:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and write the artifacts;
    returns their paths (``rgb``, ``depth``, and ``mesh`` with its vertex
    and face counts).  ``cfg`` replaces the ``--dataset`` preset's config."""
    args = build_parser().parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.eval.generate import generate_mpi
    from gmpi_tpu_torch.train.checkpoint import load_generator
    from gmpi_tpu_torch.viz.mesh import extract_mesh_from_alpha, mpi_mesh_volume_bounds, save_ply
    from gmpi_tpu_torch.viz.render_video import render_video_artifacts

    cfg = cfg or get_config(args.dataset)
    G = load_generator(args.ckpt, cfg, use_ema=True, device=args.device)
    rgb, depth = render_video_artifacts(
        cfg, G, args.out, seed=args.seed, n_frames=args.n_frames, horizontal=not args.vertical,
        n_planes=args.nplanes, chunk_n_planes=args.chunk_n_planes,
        truncation_psi=args.truncation_psi, device=args.device)
    print(f"wrote video artifacts to {args.out}")
    out = {"rgb": rgb, "depth": depth}

    if args.mesh:
        # dense uniform-depth alpha volume (``eval/common.py:161-222``)
        mesh_cfg = dataclasses.replace(cfg, planes=dataclasses.replace(
            cfg.planes, n_planes=args.mesh_planes, distance_sample_method="uniform"))
        geom = mesh_cfg.plane_geometry(device=args.device)
        z = torch.randn((1, cfg.train.z_dim), generator=torch.Generator().manual_seed(args.seed))
        with torch.no_grad():
            mpi = generate_mpi(G, z, cfg.multi_res_xyz(geom), args.mesh_planes,
                               chunk_n_planes=args.chunk_n_planes,
                               truncation_psi=args.truncation_psi, noise_mode="const")
        alpha = mpi[0, :, 3].cpu().numpy()  # [L, H, W]
        vmin, vmax, _ = mpi_mesh_volume_bounds(geom.dhw.cpu().numpy(), cfg.planes.min_d,
                                               cfg.planes.max_d)
        verts, faces = extract_mesh_from_alpha(alpha, vmin, vmax, iso=0.01)
        ply = os.path.join(args.out, "mesh.ply")
        save_ply(ply, verts, faces)
        print(f"wrote {len(verts)} verts / {len(faces)} faces to {ply}")
        out.update(mesh=ply, n_verts=len(verts), n_faces=len(faces))
    return out


if __name__ == "__main__":
    main()
