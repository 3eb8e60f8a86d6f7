"""Evaluation harness: seeded fake images, real and fake image dumps, and the
metrics over them (port of ``gmpi_tpu/eval/harness.py``).

Mirrors the reference eval pipeline (``gmpi/eval/eval.sh:64-172``):

* ``FakeImageGenerator`` -- seeded MPIs from the generator, views rendered
  at given or sampled poses on the card;
* ``prepare_real_images`` -- dataset images dumped at eval resolution
  (``prepare_real_data.py:17-52``);
* ``prepare_fake_images`` -- n images with per-image seeds (seed = image
  index, ``prepare_fake_data.py:204``) for the tasks ``fid_kid`` (one view
  per z), ``consistency`` (two views per z) and ``geometry`` (224^2 renders
  with depth and (pitch, yaw) arrays);
* ``compute_fid_kid_dirs``, ``compute_consistency_dir`` and
  ``compute_geometry_dir`` -- the metrics over those dumps, through a
  pluggable feature extractor (``eval/inception.py``) and the external-model
  adapters (``eval/adapters.py``).

The dumps and metrics are numpy and PIL, as in the JAX package; only the
generator and the renderer run on the device.  On a CUDA card the sampler's
generator runs as a CUDA graph (``FakeImageGenerator.sample_mpi``): at batch
1 its ~1,200 small kernels cost more to launch one by one than to run.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from gmpi_tpu_torch.config import ExperimentConfig
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core.bands import bands_for_config
from gmpi_tpu_torch.core import poses as poses_mod
from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_fused
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.eval.metrics import (angle_error, cosine_similarity, fid_from_features,
                                         kid_from_features, normalized_depth_error)
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.utils.device import resolve_device
from gmpi_tpu_torch.utils.inspect import profile_scope

# ``FakeImageGenerator.sample_mpi`` calls on a CUDA card by how they ran the
# generator: "capture" (a new CUDA graph, then its first replay) or "replay"
# (a graph captured by an earlier call)
SAMPLER_GRAPH: collections.Counter = collections.Counter()


@dataclasses.dataclass
class _SamplerGraph:
    """A captured generator call: the graph and the static tensors it reads
    (z) and writes (the MPI)."""

    graph: torch.cuda.CUDAGraph
    z: torch.Tensor
    out: torch.Tensor


class FakeImageGenerator:
    """Seeded eval-time sampler around (generator, renderer) for one config.

    ``generator`` is moved to ``device`` (CUDA by default) and put in eval
    mode.  ``use_fused`` renders through the fused warp+composite kernel (on
    the CPU, its plain PyTorch version).  Otherwise the render goes through
    ``render_mpi`` with the static tile bands of ``bands_for_config``, planned
    on ``device`` (the banded path; its patches come through the patch-gather
    kernel when the device is a CUDA card, through an advanced index on the
    CPU), or, for
    images under 128 pixels, for which no bands are planned, through the
    per-pixel gather.  Unlike the JAX class, which falls back to the banded
    path where ``img_size`` is not a multiple of 128 (the geometry task's
    224^2), ``use_fused`` stays fused at any size: the kernel's tiles may be
    ragged.
    ``sanity_full_alpha`` forces every plane opaque, so the render collapses
    to the nearest plane's RGB (the reference's StyleGAN2 sanity mode).

    On a CUDA card ``sample_mpi`` replays CUDA graphs of the generator, one
    for each (batch, plane count, plane chunk, truncation psi, device) it
    has met, and captures them all anew once a parameter, buffer or plane
    coordinate of the generator has moved to other storage (a weight swap
    that is not in place).  A swap in place needs nothing: a graph reads the
    tensors where they are.
    """

    def __init__(self, cfg: ExperimentConfig, generator: Generator,
                 n_planes: Optional[int] = None, img_size: Optional[int] = None,
                 chunk_n_planes: int = -1, truncation_psi: float = 1.0,
                 sanity_full_alpha: bool = False, use_fused: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.G = generator.to(self.device).eval()
        self.n_planes = n_planes or cfg.eval_n_planes
        self.img_size = img_size or cfg.resolution
        self.chunk = chunk_n_planes
        self.psi = truncation_psi
        self.sanity_full_alpha = sanity_full_alpha
        # eval-time plane geometry at the eval plane count
        eval_cfg = dataclasses.replace(
            cfg, planes=dataclasses.replace(cfg.planes, n_planes=self.n_planes))
        self.geom = eval_cfg.plane_geometry(device=self.device)
        self.xyz_dict = cfg.multi_res_xyz(self.geom)
        self.intr = cam.intrinsics_from_fov(cfg.fov_deg, self.img_size, self.img_size)
        self.use_fused = use_fused and cfg.planes.align_corners
        self.tiled_bands = None if self.use_fused else bands_for_config(
            cfg, img_size=self.img_size, n_planes=self.n_planes, device=self.device)
        self._graphs: Dict[tuple, _SamplerGraph] = {}
        self._graph_ptrs: Optional[tuple] = None  # the storage the graphs read

    @torch.no_grad()
    def sample_mpi(self, seed: int, batch: int = 1) -> torch.Tensor:
        """MPI ``[batch, L, 4, R, R]`` from the z of ``seed`` (a
        ``sampler.mpi`` span: the z draw and the generator), a tensor of its
        own: on a CUDA card a copy of the graph's output, which the next
        replay overwrites."""
        with profile_scope("sampler.mpi"):
            z = torch.randn((batch, self.cfg.train.z_dim),
                            generator=torch.Generator().manual_seed(seed))
            if self.device.type == "cuda":
                mpi = self._replay(z)
            else:
                mpi = self._generate(z.to(self.device))
            if self.sanity_full_alpha:
                mpi = torch.cat([mpi[:, :, :3], torch.ones_like(mpi[:, :, 3:4])], dim=2)
            return mpi

    def _generate(self, z: torch.Tensor) -> torch.Tensor:
        return generate_mpi(self.G, z, self.xyz_dict, self.n_planes, chunk_n_planes=self.chunk,
                            truncation_psi=self.psi, noise_mode="const")

    def _replay(self, z: torch.Tensor) -> torch.Tensor:
        """The generator's MPI for the host tensor ``z`` through the CUDA
        graph of this call's key (captured first where there is none)."""
        ptrs = tuple(t.data_ptr() for m in self.G.modules()
                     for t in (*m._parameters.values(), *m._buffers.values()) if t is not None)
        ptrs += tuple(t.data_ptr() for t in self.xyz_dict.values())
        if ptrs != self._graph_ptrs:  # the graphs would read storage that has moved
            self._graphs.clear()
            self._graph_ptrs = ptrs
        key = (z.shape[0], self.n_planes, self.chunk, self.psi, self.device)
        with torch.cuda.device(self.device):
            entry = self._graphs.get(key)
            if entry is None:
                with profile_scope("sampler.graph_capture"):
                    entry = self._graphs[key] = self._capture(z)
                SAMPLER_GRAPH["capture"] += 1
            else:
                SAMPLER_GRAPH["replay"] += 1
            entry.z.copy_(z)
            with profile_scope("sampler.graph_replay"):
                entry.graph.replay()
            return entry.out.clone()

    def _capture(self, z: torch.Tensor) -> _SamplerGraph:
        """Capture the generator's call on a static copy of ``z``, after one
        eager call on a side stream (cuDNN's algorithm choices and the
        allocator's workspaces made before the capture)."""
        static_z = z.to(self.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._generate(static_z)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._generate(static_z)
        return _SamplerGraph(graph, static_z, out)

    def sample_views(self, seed: int, n_views: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[n_views, 1]`` yaws and pitches from the pose distribution."""
        g = torch.Generator().manual_seed(seed * 1_000_003 + 17)
        return poses_mod.sample_yaw_pitch(g, n_views, self.cfg.camera, device=self.device)

    @torch.no_grad()
    def render(self, mpi: torch.Tensor, yaws, pitches) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render ``mpi [V, L, 4, R, R]`` (one view each; may be an expand of
        one MPI) at the given angles: ``(color [V,3,H,W] in [-1,1], depth)``."""
        c2w, _, _ = poses_mod.sample_sphere_poses(
            None, mpi.shape[0], self.cfg.camera, given_yaws=yaws, given_pitches=pitches,
            device=self.device)
        ray_dir, eye, z_dir = cam.generate_rays(self.intr, c2w)
        if self.use_fused:
            out = render_mpi_fused(mpi, self.geom.dhw, ray_dir, eye, z_dir)
        else:
            out = render_mpi(mpi, self.geom.dhw, ray_dir, eye, z_dir,
                             self.cfg.planes.align_corners, tiled_bands=self.tiled_bands)
        return out.color * 2.0 - 1.0, out.depth


def _save_png(path: str, img_chw: np.ndarray) -> None:
    """img in [-1, 1] CHW -> png (truncated to uint8, not rounded, as in the
    JAX package)."""
    arr = ((img_chw.transpose(1, 2, 0) + 1.0) / 2.0 * 255.0).clip(0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def prepare_real_images(dataset, out_dir: str, n_imgs: int) -> int:
    """Dump the first ``n_imgs`` images of ``dataset`` (CHW in [-1, 1]) as
    PNGs; returns how many were written."""
    os.makedirs(out_dir, exist_ok=True)
    n = min(n_imgs, len(dataset))
    for i in range(n):
        img, *_ = dataset[i]
        _save_png(os.path.join(out_dir, f"{i:06d}.png"), np.asarray(img))
    return n


def prepare_fake_images(gen: FakeImageGenerator, out_dir: str, n_imgs: int,
                        task: str = "fid_kid") -> None:
    """Per-image-seeded fake image dump (``prepare_fake_data.py:180-258``):
    ``out_dir/rgb/*.png``, and for ``geometry`` also ``depth/*.npy`` and
    ``angle/*.npy`` (pitch, yaw).  Each MPI is expanded over its views and
    rendered in one ``gen.render`` call."""
    if task not in ("fid_kid", "consistency", "geometry"):
        raise ValueError(f"unknown task {task!r}")
    rgb_dir = os.path.join(out_dir, "rgb")
    os.makedirs(rgb_dir, exist_ok=True)
    if task == "geometry":
        depth_dir = os.path.join(out_dir, "depth")
        angle_dir = os.path.join(out_dir, "angle")
        os.makedirs(depth_dir, exist_ok=True)
        os.makedirs(angle_dir, exist_ok=True)

    n_views = 2 if task == "consistency" else 1
    for i in range(n_imgs):
        mpi = gen.sample_mpi(seed=i)
        yaws, pitches = gen.sample_views(seed=i, n_views=n_views)
        imgs, depths = gen.render(mpi.expand(n_views, -1, -1, -1, -1), yaws, pitches)
        imgs = imgs.cpu().numpy()
        for v in range(n_views):
            name = f"{i:06d}_{v}.png" if task == "consistency" else f"{i:06d}.png"
            _save_png(os.path.join(rgb_dir, name), imgs[v])
        if task == "geometry":
            np.save(os.path.join(depth_dir, f"{i:06d}.npy"), depths[0, 0].cpu().numpy())
            np.save(os.path.join(angle_dir, f"{i:06d}.npy"),
                    np.array([float(pitches[0, 0]), float(yaws[0, 0])], np.float32))


def load_images_chw(dir_path: str) -> np.ndarray:
    """Load a directory of PNGs -> [N, 3, H, W] float32 in [0, 1]."""
    files = sorted(f for f in os.listdir(dir_path) if f.endswith(".png"))
    out = []
    for f in files:
        arr = np.asarray(Image.open(os.path.join(dir_path, f)), np.float32) / 255.0
        out.append(arr.transpose(2, 0, 1)[:3])
    return np.stack(out)


def compute_fid_kid_dirs(real_dir: str, fake_dir: str,
                         feature_fn: Callable[[np.ndarray], np.ndarray],
                         kid_subset_size: int = 1000, kid_subsets: int = 100
                         ) -> Dict[str, float]:
    """FID + KID between two image dirs via a pluggable extractor."""
    real = feature_fn(load_images_chw(real_dir))
    fake = feature_fn(load_images_chw(fake_dir))
    fid = fid_from_features(fake, real)
    kid_mean, kid_std = kid_from_features(fake, real, subset_size=kid_subset_size,
                                          n_subsets=kid_subsets)
    return {
        "frechet_inception_distance": fid,
        "kernel_inception_distance_mean": kid_mean,
        "kernel_inception_distance_std": kid_std,
    }


def compute_geometry_dir(fake_dir: str, n_imgs: int, detector, estimator) -> Dict[str, float]:
    """Depth + pose-angle error over a ``prepare_fake_images(task="geometry")``
    dump (``gmpi/eval/compute_geometry.py:24-68``): landmarks (MTCNN role) ->
    pose and depth estimate (Deep3DFace role) -> z-normalised depth MSE on
    the face mask + MSE between rendered (pitch, -yaw, 0) and predicted
    angles.  Images with no detected face are skipped, as in the reference."""
    rgb_dir = os.path.join(fake_dir, "rgb")
    depth_dir = os.path.join(fake_dir, "depth")
    angle_dir = os.path.join(fake_dir, "angle")
    d_errs, a_errs, n_skipped = [], [], 0
    for i in range(n_imgs):
        img = np.asarray(Image.open(os.path.join(rgb_dir, f"{i:06d}.png")))
        lm = detector.detect(img)
        pred = estimator.estimate(img, lm) if lm is not None else None
        if pred is None:
            n_skipped += 1
            continue
        rendered_pitch_yaw = np.load(os.path.join(angle_dir, f"{i:06d}.npy"))
        a_errs.append(angle_error(rendered_pitch_yaw, pred["angles"]))
        if pred.get("depth") is not None and pred.get("mask") is not None:
            rendered_depth = np.load(os.path.join(depth_dir, f"{i:06d}.npy"))
            pd = np.asarray(pred["depth"], np.float32)
            if pd.shape != rendered_depth.shape:
                pd = np.asarray(Image.fromarray(pd).resize(rendered_depth.shape[::-1]))
                mask = np.asarray(Image.fromarray(
                    pred["mask"].astype(np.uint8)).resize(rendered_depth.shape[::-1]))
            else:
                mask = np.asarray(pred["mask"], np.uint8)
            d_errs.append(normalized_depth_error(rendered_depth, pd, mask))
    out: Dict[str, float] = {"n_evaluated": float(n_imgs - n_skipped),
                             "n_skipped": float(n_skipped)}
    if a_errs:
        out["angle_error_mse"] = float(np.mean(a_errs))
    if d_errs:
        out["depth_error_mse"] = float(np.mean(d_errs))
    return out


def compute_consistency_dir(fake_dir: str, n_imgs: int,
                            embed_fn: Callable[[np.ndarray], np.ndarray]) -> Dict[str, float]:
    """Mean identity cosine similarity between the two views of each z
    (``compute_consistency.py:21-105``); ``embed_fn`` maps one HWC uint8
    image to an embedding vector (ArcFace in the reference)."""
    sims = []
    rgb_dir = os.path.join(fake_dir, "rgb")
    for i in range(n_imgs):
        a = np.asarray(Image.open(os.path.join(rgb_dir, f"{i:06d}_0.png")))
        b = np.asarray(Image.open(os.path.join(rgb_dir, f"{i:06d}_1.png")))
        sims.append(cosine_similarity(embed_fn(a), embed_fn(b)))
    return {"consistency_mean": float(np.mean(sims)), "consistency_std": float(np.std(sims))}
