"""Training loop (port of ``gmpi_tpu/train/loop.py``; the reference's
``gmpi/train.py`` + ``launch.py`` as a library function).

One process drives one card.  Mirrored from the reference's loop:

* config snapshot on start (``train.py:52-55``);
* warm start from converted StyleGAN2/GMPI weights (``train.py:197-230``);
* metric logging every 10 steps (``train.py:799-812``): JSONL, stdout and a
  TensorBoard event file;
* image-grid snapshots every ``sample_interval`` (``train.py:815-994``);
* step-stamped checkpoints with a rolling ``latest`` every
  ``model_save_interval`` (``train.py:427-437, 997-1005``), with full resume
  (the reference cannot resume);
* optional in-training FID every ``eval_freq`` given a feature extractor
  (``train.py:1009-1071``).

Randomness: the initial weights come from ``torch.Generator().manual_seed(seed)``
and the steps draw from ``manual_seed(seed + 1)``, as the JAX loop uses
``jax.random.key(seed)`` and ``key(seed + 1)``.  After a resume the step
generator starts again from ``seed + 1``, as the JAX key does: its state is
not checkpointed, so a resumed run draws other z and poses than an unbroken
one would, and the data iterator starts again at epoch 0.

The sharded renderers (``renderer_plane_shards`` / ``renderer_tile_shards``
> 1) are not ported (``ROADMAP`` Queue A9): there is no data mesh either, one
card runs the whole batch.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from gmpi_tpu_torch.config import ExperimentConfig
from gmpi_tpu_torch.train.checkpoint import (STATE_FILE, checkpoint_file, load_checkpoint,
                                             save_checkpoint, save_config_snapshot)
from gmpi_tpu_torch.train.step import (TrainState, init_train_state, make_train_step,
                                       set_learning_rates)
from gmpi_tpu_torch.utils.device import resolve_device


class MetricLogger:
    """Metric log: JSONL + stdout + TensorBoard event file
    (``gmpi/utils/tensorboard_utils.py`` parity, through the dependency-free
    writer of ``utils/tb_writer.py``)."""

    def __init__(self, out_dir: str, tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            from gmpi_tpu_torch.utils.tb_writer import SummaryWriter
            self._tb = SummaryWriter(os.path.join(out_dir, "tensorboard"))

    def log(self, step: int, metrics: dict) -> None:
        vals = {k: float(v) for k, v in metrics.items()}
        self._f.write(json.dumps({"step": step, **vals}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars_dict(vals, step)
        print(f"[step {step}] " + " ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@dataclasses.dataclass
class LoopStats:
    """Host-clock record of one :func:`train` call, filled in when the caller
    passes one.  ``data_wait_ms``: per step, the time spent in
    ``next(batch_iter)``; ``step_ms``: per step, from the batch's copy to the
    card to the end of the step on the device; ``metrics``: per step, the
    step's metrics as floats."""

    start_step: int = 0
    end_step: int = 0
    data_wait_ms: List[float] = dataclasses.field(default_factory=list)
    step_ms: List[float] = dataclasses.field(default_factory=list)
    save_s: List[float] = dataclasses.field(default_factory=list)
    save_bytes: List[int] = dataclasses.field(default_factory=list)
    load_s: Optional[float] = None
    load_bytes: Optional[int] = None
    snapshot_steps: List[int] = dataclasses.field(default_factory=list)
    metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    seconds: float = 0.0  # the loop alone, first batch to last step


def _to_u8(img_chw: np.ndarray) -> np.ndarray:
    return ((np.asarray(img_chw).transpose(1, 2, 0) + 1) / 2 * 255).clip(0, 255).astype(np.uint8)


def _device_of(state: TrainState) -> torch.device:
    return next(state.G.parameters()).device


def _generator_copy(state: TrainState, params: Dict[str, torch.Tensor]):
    """A copy of ``state.G`` holding ``params`` and ``state.G``'s buffers
    (``w_avg``, ``noise_const``), as the JAX loop pairs either weight set
    with ``state.buffers_g``.  The live module is not touched."""
    g = copy.deepcopy(state.G)
    with torch.no_grad():
        for k, p in g.named_parameters():
            p.copy_(params[k])
    return g


def _fake_image_generator(cfg: ExperimentConfig, state: TrainState, params):
    """An eval-time sampler of a copy of G with ``params``, rendering as the
    train step does (fused on a card unless the config says otherwise)."""
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator

    dev = _device_of(state)
    use_fused = cfg.train.use_fused_renderer
    if use_fused is None:
        use_fused = dev.type == "cuda"
    return FakeImageGenerator(cfg, _generator_copy(state, params), n_planes=cfg.planes.n_planes,
                              img_size=cfg.hparams.img_size, use_fused=use_fused, device=dev)


def save_snapshot_grid(out_dir: str, cfg: ExperimentConfig, state: TrainState, step: int,
                       n_imgs: int = 4) -> None:
    """Training snapshots (``gmpi/train.py:815-994`` analogue): fixed /
    tilted / random view rows for the same fixed z's, for both EMA and raw
    generator weights, plus per-plane MPI rgb/alpha sheets for seed 0.
    Renders through copies of G in eval mode, with the train step's
    renderer; ``state.G`` keeps its mode."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    cam = cfg.camera
    tilt_yaw = cam.yaw_mean + 1.5 * cam.yaw_std
    tilt_pitch = cam.pitch_mean + 0.75 * cam.pitch_std
    for tag, params in (("ema", state.ema), ("raw", dict(state.G.named_parameters()))):
        gen = _fake_image_generator(cfg, state, params)
        mpis = [gen.sample_mpi(seed=i) for i in range(n_imgs)]
        rows = []
        for view in ("fixed", "tilted", "random"):
            cols = []
            for i in range(n_imgs):
                if view == "fixed":
                    yaws = np.array([[cam.yaw_mean]], np.float32)
                    pitches = np.array([[cam.pitch_mean]], np.float32)
                elif view == "tilted":
                    yaws = np.array([[tilt_yaw]], np.float32)
                    pitches = np.array([[tilt_pitch]], np.float32)
                else:
                    yaws, pitches = gen.sample_views(seed=1000 + i + step, n_views=1)
                imgs, _ = gen.render(mpis[i], yaws, pitches)
                cols.append(_to_u8(imgs[0].cpu().numpy()))
            rows.append(np.concatenate(cols, axis=1))
        grid = np.concatenate(rows, axis=0)
        Image.fromarray(grid).save(os.path.join(out_dir, f"snap_{step:08d}_{tag}.png"))
        if tag == "ema":
            # MPI sheets: planes tiled horizontally (rgb in [0,1], alpha)
            mpi0 = mpis[0][0].cpu().numpy()  # [L, 4, H, W]
            rgb = (np.concatenate(list(mpi0[:, :3].transpose(0, 2, 3, 1)), axis=1)
                   * 255).clip(0, 255).astype(np.uint8)
            alpha = (np.concatenate(list(mpi0[:, 3]), axis=1) * 255).clip(0, 255).astype(np.uint8)
            Image.fromarray(rgb).save(os.path.join(out_dir, f"mpi_{step:08d}_rgb.png"))
            Image.fromarray(alpha).save(os.path.join(out_dir, f"mpi_{step:08d}_alpha.png"))
        del gen, mpis


def _check_pose_corner_rays(cfg: ExperimentConfig, device, img_size: int = 64) -> None:
    """Raise unless rays from the truncated pose-range corners hit the last
    plane (``assert_not_out_of_last_plane``, ``gmpi/core/mpi.py:103-128,
    381-395``; once at setup, since pose range and plane volume are static)."""
    from gmpi_tpu_torch.core import camera as cam_mod
    from gmpi_tpu_torch.core import poses as poses_mod
    from gmpi_tpu_torch.core.renderer import check_rays_hit_last_plane

    cam = cfg.camera
    n = cam.n_truncated_stds
    yaw_c = [cam.yaw_mean - n * cam.yaw_std, cam.yaw_mean + n * cam.yaw_std]
    pitch_c = [cam.pitch_mean - n * cam.pitch_std, cam.pitch_mean + n * cam.pitch_std]
    corners = [(y, p) for y in yaw_c for p in pitch_c]
    c2w, _, _ = poses_mod.sample_sphere_poses(
        None, len(corners), cam, given_yaws=[[y] for y, _ in corners],
        given_pitches=[[p] for _, p in corners], device=device)
    intr = cam_mod.intrinsics_from_fov(cfg.fov_deg, img_size, img_size)
    ray_dir, eye, z_dir = cam_mod.generate_rays(intr, c2w)
    dhw_last = cfg.plane_geometry(device=device).dhw[-1].expand(len(corners), 3)
    if not check_rays_hit_last_plane(dhw_last, eye, ray_dir, z_dir):
        raise RuntimeError(
            "pose-range corner rays miss the last plane — plane volume too "
            "small for the camera distribution (check plane/camera config)")


def _load_part(module: torch.nn.Module, tree: Dict[str, torch.Tensor], keys, what: str) -> None:
    """Copy ``tree`` into ``module``; its keys must be exactly ``keys``."""
    keys = set(keys)
    if set(tree) != keys:
        raise KeyError(f"{what}: {len(keys - set(tree))} keys missing, "
                       f"{len(set(tree) - keys)} unexpected")
    module.load_state_dict({**module.state_dict(), **tree}, strict=True)


def train(
    cfg: ExperimentConfig,
    batches: Iterable,
    out_dir: str,
    total_iters: Optional[int] = None,
    resume: bool = True,
    init_params_g: Optional[Dict[str, torch.Tensor]] = None,
    init_buffers_g: Optional[Dict[str, torch.Tensor]] = None,
    init_params_d: Optional[Dict[str, torch.Tensor]] = None,
    seed: int = 123,
    sample_interval: int = 200,
    model_save_interval: int = 500,
    eval_freq: int = 5000,
    fid_feature_fn: Optional[Callable] = None,
    fid_real_images: Optional[np.ndarray] = None,
    snapshot_fn: Optional[Callable] = None,
    curriculum=None,
    rebuild_batches: Optional[Callable] = None,
    device="cuda",
    stats: Optional[LoopStats] = None,
) -> TrainState:
    """Run the GAN loop over ``batches`` (yielding ``(imgs, flat_pose, ...)``
    numpy arrays) on ``device`` up to step ``total_iters`` (the config's when
    None) and return the final state.  ``init_*`` are full flat state dicts
    of G's parameters and buffers and D's parameters (from the converter's
    warm start); EMAs start at ``init_params_g``.  With ``resume``, the
    newest checkpoint under ``out_dir/checkpoints`` wins over both.  At each
    curriculum boundary the step is rebuilt, the Adam groups take the
    stage's learning rates and ``rebuild_batches(entry)`` replaces the data
    iterator."""
    from gmpi_tpu_torch.curriculum import apply_to_config
    from gmpi_tpu_torch.utils.inspect import param_summary

    dev = resolve_device(device)
    t = cfg.train
    if max(t.renderer_plane_shards, 1) > 1 or max(t.renderer_tile_shards, 1) > 1:
        raise NotImplementedError(
            "renderer_plane_shards / renderer_tile_shards (the sharded renderers) are not "
            "ported yet: ROADMAP Queue A9")
    total_iters = t.total_iters if total_iters is None else total_iters
    os.makedirs(out_dir, exist_ok=True)
    save_config_snapshot(out_dir, cfg)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    _check_pose_corner_rays(cfg, dev)

    state = init_train_state(cfg, torch.Generator().manual_seed(seed), device=dev)
    _, n_g = param_summary(state.G)
    _, n_d = param_summary(state.D)
    print(f"[model] generator params: {n_g:,}  discriminator params: {n_d:,}", flush=True)
    # warm start (``train.py:197-230``): partial name-matched absorption, done by the converter
    if init_params_g is not None:
        _load_part(state.G, init_params_g, dict(state.G.named_parameters()), "init_params_g")
        state.ema = {k: p.detach().clone() for k, p in state.G.named_parameters()}
        state.ema2 = copy.deepcopy(state.ema)
    if init_buffers_g is not None:
        params = dict(state.G.named_parameters())
        _load_part(state.G, init_buffers_g, [k for k in state.G.state_dict() if k not in params],
                   "init_buffers_g")
    if init_params_d is not None:
        _load_part(state.D, init_params_d, dict(state.D.named_parameters()), "init_params_d")
    if resume and os.path.exists(os.path.join(ckpt_dir, "latest")):
        t0 = time.perf_counter()
        state = load_checkpoint(ckpt_dir, state)
        if stats is not None:
            stats.load_s = time.perf_counter() - t0
            stats.load_bytes = os.path.getsize(checkpoint_file(ckpt_dir))
        print(f"resumed from step {state.step}", flush=True)

    def save():
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, state)
        if stats is not None:
            stats.save_s.append(time.perf_counter() - t0)
            stats.save_bytes.append(os.path.getsize(os.path.join(path, STATE_FILE)))

    step0 = state.step
    stage_cfg = apply_to_config(cfg, curriculum.at_step(step0)) if curriculum else cfg
    step_fn = make_train_step(stage_cfg, device=dev)
    set_learning_rates(stage_cfg, state.opt_g, state.opt_d)  # also over a resumed optimizer's
    next_boundary = curriculum.next_upsample_step(step0) if curriculum else float("inf")
    if stats is not None:
        stats.start_step = step0

    logger = MetricLogger(out_dir)
    rng = torch.Generator().manual_seed(seed + 1)
    t_start = time.perf_counter()
    batch_iter = iter(batches)
    try:
        while state.step < total_iters:
            step = state.step
            if curriculum is not None and step >= next_boundary:
                entry = curriculum.at_step(step)
                stage_cfg = apply_to_config(cfg, entry)
                step_fn = make_train_step(stage_cfg, device=dev)
                set_learning_rates(stage_cfg, state.opt_g, state.opt_d)
                next_boundary = curriculum.next_upsample_step(step)
                print(f"[curriculum] stage change at step {step}: {entry}", flush=True)
                if rebuild_batches is not None:
                    # replace the iterator itself — a `for` loop would keep
                    # draining the captured stage-1 iterator
                    batch_iter = iter(rebuild_batches(entry))
            t0 = time.perf_counter()
            try:
                batch = next(batch_iter)
            except StopIteration:
                break
            t1 = time.perf_counter()
            imgs = torch.from_numpy(np.ascontiguousarray(batch[0], np.float32)).to(dev)
            flat_pose = torch.from_numpy(np.ascontiguousarray(batch[1], np.float32)).to(dev)
            state, metrics = step_fn(state, imgs, flat_pose, rng)
            if dev.type == "cuda":
                # wait for the step, as the JAX loop does when it reads state.step
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            if stats is not None:
                stats.data_wait_ms.append((t1 - t0) * 1e3)
                stats.step_ms.append((t2 - t1) * 1e3)
                stats.metrics.append({k: float(v) for k, v in metrics.items()})

            if step % 10 == 0:
                steps_per_s = (step + 1 - step0) / (time.perf_counter() - t_start)
                logger.log(step, {**metrics, "steps_per_s": steps_per_s})
            if step > 0 and step % sample_interval == 0:
                (snapshot_fn or save_snapshot_grid)(os.path.join(out_dir, "snaps"), stage_cfg,
                                                    state, step)
                if stats is not None:
                    stats.snapshot_steps.append(step)
            if step > 0 and step % model_save_interval == 0:
                save()
            if (fid_feature_fn is not None and fid_real_images is not None and step > 0
                    and step % eval_freq == 0):
                fid = compute_training_fid(stage_cfg, state, fid_feature_fn, fid_real_images)
                logger.log(step, {"fid": fid})
        if stats is not None:
            stats.seconds = time.perf_counter() - t_start
            stats.end_step = state.step
        save()
    finally:
        logger.close()
    return state


def compute_training_fid(
    cfg: ExperimentConfig,
    state: TrainState,
    feature_fn: Callable[[np.ndarray], np.ndarray],
    real_images: np.ndarray,
    n_imgs: Optional[int] = None,
    batch: int = 8,
) -> float:
    """In-training FID with EMA weights (``gmpi/fid_evaluation.py:38-145``):
    ``n_imgs`` fakes (seed ``i`` for z and view of the ``i``-th batch) and
    ``real_images`` in [-1, 1] or [0, 1], both fed to ``feature_fn`` in [0, 1]."""
    from gmpi_tpu_torch.eval.metrics import fid_from_features

    n_imgs = n_imgs or len(real_images)
    gen = _fake_image_generator(cfg, state, state.ema)
    fakes = []
    for i in range(0, n_imgs, batch):
        b = min(batch, n_imgs - i)
        mpi = gen.sample_mpi(seed=i, batch=b)
        yaws, pitches = gen.sample_views(seed=i, n_views=b)
        imgs, _ = gen.render(mpi, yaws, pitches)
        fakes.append(((imgs.cpu().numpy() + 1) / 2).clip(0, 1))
    fake_feats = feature_fn(np.concatenate(fakes))
    real_feats = feature_fn(((real_images + 1) / 2).clip(0, 1) if real_images.min() < 0
                            else real_images)
    return fid_from_features(fake_feats, real_feats)
