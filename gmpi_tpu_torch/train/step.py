"""The GAN train step (port of ``gmpi_tpu/train/step.py``).

One step is one discriminator phase and ``g_iters`` generator phases:

* **D phase**: sample z, synthesize MPIs without a gradient to G, optional
  lighting augmentation, render into truncated-gaussian poses, score real
  images (with the R1 penalty, a double backward through D) and fakes, Adam
  update with a global-norm clip.
* **G phase**: fresh z, *worst-view selection* (render ``n_view_per_z``
  candidate views per z without a gradient and keep the one D scores lowest),
  then differentiate through synthesis + lighting + renderer + D at the
  chosen views; ``batch_split`` micro-batches accumulate one gradient.
* dual generator EMA (0.999 / 0.9999) and the mapping ``w_avg`` running mean.

PyTorch's idiom throughout: the networks are ``nn.Module``s updated in place
by ``torch.optim.Adam``, :class:`TrainState` holds them, and randomness comes
from one explicit ``torch.Generator`` (z, poses, synthesis noise and the
light's position are drawn from it on the CPU, in a fixed order).  On a CUDA
device the step renders through the fused kernels (forward, composite
backward, splat).  With ``use_fused_renderer`` off (the CPU's default, when
the caller asks for the CPU) it renders as the JAX step does without its
kernels: through ``render_mpi`` with the static tile bands of
``bands_for_config`` (at 128 pixels and above; 4-field bands make the tiled
adjoint the warp's backward), in plane slabs through ``render_mpi_chunked``
when ``renderer_plane_chunk`` is set; ``debug_ray_check`` NaN-poisons a
render whose rays leave the last plane.

The parts of a step are named ``train_step.*`` spans of ``torch.profiler``
(``tools/profile_step.py`` reads them); without a profiler they do nothing.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from gmpi_tpu_torch.config import ExperimentConfig
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import geometry as geom_mod
from gmpi_tpu_torch.core import poses as poses_mod
from gmpi_tpu_torch.core.lighting import LightingConfig, light_mpi
from gmpi_tpu_torch.core.bands import bands_for_config
from gmpi_tpu_torch.core.renderer import (poison_if_rays_escape, render_mpi, render_mpi_chunked,
                                          render_mpi_fused, render_mpi_fused_remat)
from gmpi_tpu_torch.models.discriminator import Discriminator
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.train.losses import d_gan_loss, g_gan_loss, r1_penalty
from gmpi_tpu_torch.utils.device import resolve_device
from gmpi_tpu_torch.utils.img import edge_aware_smooth_loss


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and updates in place."""

    G: Generator
    D: Discriminator
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]   # EMA of G's parameters, decay ``ema_decay``
    ema2: Dict[str, torch.Tensor]  # decay ``ema2_decay``
    step: int = 0


def make_optimizers(cfg: ExperimentConfig, G: Generator, D: Discriminator
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """Adam for G and D; G in two parameter groups, the mapping network at
    ``gen_lr * mapping_lr_mult``.  The global-norm clip is applied per group
    by the step (``clip_grad_norm_``) before each update."""
    t, h = cfg.train, cfg.hparams
    mapping = list(G.mapping.parameters())
    rest = list(G.synthesis.parameters())
    kw = dict(betas=tuple(t.betas), eps=1e-8, weight_decay=t.weight_decay)
    opt_g = torch.optim.Adam([{"params": mapping, "lr": h.gen_lr * t.mapping_lr_mult},
                              {"params": rest, "lr": h.gen_lr}], **kw)
    opt_d = torch.optim.Adam(D.parameters(), lr=h.disc_lr, **kw)
    return opt_g, opt_d


def set_learning_rates(cfg: ExperimentConfig, opt_g: torch.optim.Optimizer,
                       opt_d: torch.optim.Optimizer) -> None:
    """Set every Adam group's ``lr`` from ``cfg`` as :func:`make_optimizers`
    does: mapping ``gen_lr * mapping_lr_mult``, synthesis ``gen_lr``, D
    ``disc_lr``.  The learning rate lives in the optimizer here (the JAX step
    rebuilds its optax transforms from the config), so a curriculum stage or
    a resume sets it through this."""
    h, t = cfg.hparams, cfg.train
    mapping, synthesis = opt_g.param_groups
    mapping["lr"], synthesis["lr"] = h.gen_lr * t.mapping_lr_mult, h.gen_lr
    for group in opt_d.param_groups:
        group["lr"] = h.disc_lr


def init_train_state(cfg: ExperimentConfig, generator: Optional[torch.Generator] = None,
                     device="cuda") -> TrainState:
    """Fresh G, D (weights drawn from ``generator`` on the CPU), their
    optimizers and both EMAs, on ``device``."""
    dev = resolve_device(device)
    G = Generator(cfg.generator_cfg(), generator=generator).to(dev)
    D = Discriminator(cfg.discriminator_cfg(), generator=generator).to(dev)
    opt_g, opt_d = make_optimizers(cfg, G, D)
    ema = {k: p.detach().clone() for k, p in G.named_parameters()}
    return TrainState(G=G, D=D, opt_g=opt_g, opt_d=opt_d, ema=ema, ema2=copy.deepcopy(ema))


def flat_pose_from_c2w(c2w: torch.Tensor, pose_dim: int) -> torch.Tensor:
    """D's conditioning vector: the flattened world-to-camera matrix (16) or
    its rotation block (9)."""
    if pose_dim == 16:
        return torch.linalg.inv(c2w).reshape(c2w.shape[0], 16)
    if pose_dim == 9:
        return torch.linalg.inv(c2w[:, :3, :3]).reshape(c2w.shape[0], 9)
    raise ValueError(pose_dim)


@torch.no_grad()
def _ema_update(ema: Dict[str, torch.Tensor], G: Generator, decay: float) -> None:
    for k, p in G.named_parameters():
        ema[k].lerp_(p.detach(), 1.0 - decay)


def _grads(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()
            if p.grad is not None}


class TrainStep:
    """The train step of one configuration; build it with
    :func:`make_train_step`.  Plane geometry, conditioning grids and camera
    intrinsics are computed once, on ``device``.

    ``step(state, real_imgs, real_pose, generator)`` runs one D phase and
    ``g_iters`` G phases on ``state`` in place and returns ``(state,
    metrics)``, or ``(state, metrics, {"d": grads, "g": grads})`` with
    ``return_grads``.  :meth:`d_loss_terms` and :meth:`g_loss` are the two
    loss closures, public so that a test can feed them chosen inputs.
    """

    def __init__(self, cfg: ExperimentConfig, device="cuda", mesh=None,
                 return_grads: bool = False):
        t = cfg.train
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (the plane/tile-sharded renderers) is not ported yet: ROADMAP Queue A9")
        if t.fused_compute_dtype is not None:
            raise NotImplementedError(
                "fused_compute_dtype (bf16 textures in the fused kernels) is not ported yet: "
                "ROADMAP Queue A4")
        if cfg.hparams.batch_size % cfg.hparams.batch_split:
            raise ValueError(f"batch_size {cfg.hparams.batch_size} is not a multiple of "
                             f"batch_split {cfg.hparams.batch_split}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.return_grads = return_grads
        self.geom = cfg.plane_geometry(device=self.device)
        self.xyz_dict = cfg.multi_res_xyz(self.geom)
        size = cfg.hparams.img_size
        self.intr = cam.intrinsics_from_fov(cfg.fov_deg, size, size)
        self.light_cfg = LightingConfig(
            sphere_center_z=cfg.camera.sphere_center_z, sphere_r=cfg.camera.sphere_r,
            ka_max=t.lighting_max_ka, kd_max=t.lighting_max_kd,
            n_grow_iters=t.lighting_grow_n_iters)
        self.xyz_last_plane = geom_mod.plane_xyz_grid(
            self.geom, cfg.hparams.tex_size, cfg.hparams.tex_size)[-1]
        use_fused = t.use_fused_renderer
        if use_fused is None:  # the kernels on the card, the gather path on the CPU
            use_fused = self.device.type == "cuda" and cfg.planes.align_corners
        if use_fused and not cfg.planes.align_corners:
            raise ValueError("use_fused_renderer requires planes.align_corners=True "
                             "(the fused kernels' coordinate convention)")
        self.use_fused = use_fused
        # static bands of the tile-banded warp for the non-fused routes (None
        # under 128 pixels: the per-pixel gather)
        self.tiled_bands = None if use_fused else bands_for_config(cfg)

    # -- pieces -----------------------------------------------------------------

    def synth(self, G: Generator, z: torch.Tensor, generator: Optional[torch.Generator],
              noise_mode: str = "random") -> torch.Tensor:
        t = self.cfg.train
        return G(z, None, self.xyz_dict, self.cfg.planes.n_planes,
                 truncation_psi=t.truncation_psi, noise_mode=noise_mode, generator=generator,
                 stop_mapping_grad=not t.train_mapping, stop_trunk_grad=not t.train_trunk)

    def maybe_light(self, mpi: torch.Tensor, step: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        t = self.cfg.train
        if not t.aug_with_lighting or step <= t.lighting_start_iter:
            return mpi
        return light_mpi(self.light_cfg, mpi, self.geom.dhw, self.xyz_last_plane,
                         step - t.lighting_start_iter, generator)

    def render_views(self, mpi: torch.Tensor, yaws: torch.Tensor, pitches: torch.Tensor,
                     low_res: int = 0
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """Render each MPI into its camera: ``(imgs in [-1, 1], flat pose,
        depth)``.  With ``k`` times as many cameras as MPIs, MPI ``n`` renders
        into cameras ``n * k ... (n + 1) * k - 1`` (no gradient): the fused
        kernel reads each MPI once for its ``k`` views, the other routes get
        a repeated copy.  ``low_res > 0`` renders at that resolution through
        the gather path and upsamples bilinearly to ``img_size``: the cheap
        no-grad mode of worst-view selection, whose candidates only need to
        be rankable by D."""
        cfg, t = self.cfg, self.cfg.train
        n_views = yaws.shape[0]
        if n_views % mpi.shape[0]:
            raise ValueError(f"{n_views} cameras are not a multiple of {mpi.shape[0]} MPIs")
        grouped_fused = self.use_fused and not low_res and not t.fused_remat
        if n_views != mpi.shape[0] and not grouped_fused:
            mpi = mpi.repeat_interleave(n_views // mpi.shape[0], dim=0)
        c2w, _, _ = poses_mod.sample_sphere_poses(
            None, n_views, cfg.camera, given_yaws=yaws, given_pitches=pitches,
            device=self.device)
        dhw = self.geom.dhw
        intr = cam.intrinsics_from_fov(cfg.fov_deg, low_res, low_res) if low_res else self.intr
        rays = cam.generate_rays(intr, c2w)  # (ray_dir, eye, z_dir)
        if low_res:
            out = render_mpi(mpi, dhw, *rays, cfg.planes.align_corners)
        elif self.use_fused:
            render = render_mpi_fused_remat if t.fused_remat else render_mpi_fused
            out = render(mpi, dhw, *rays, with_disp=False)
        elif t.renderer_plane_chunk:
            out = render_mpi_chunked(mpi, dhw, *rays, plane_chunk=t.renderer_plane_chunk,
                                     align_corners=cfg.planes.align_corners,
                                     tiled_bands=self.tiled_bands, with_disp=False)
        else:
            out = render_mpi(mpi, dhw, *rays, cfg.planes.align_corners,
                             tiled_bands=self.tiled_bands)
        color = out.color
        if t.debug_ray_check:
            ray_dir, eye, z_dir = rays
            color = poison_if_rays_escape(color, dhw[-1], eye, ray_dir, z_dir,
                                          cfg.planes.align_corners)
        if low_res:
            size = cfg.hparams.img_size
            color = F.interpolate(color, size=(size, size), mode="bilinear", align_corners=False)
        flat_pose = flat_pose_from_c2w(c2w, t.d_cond_pose_dim) if t.d_cond_on_pose else None
        return color * 2.0 - 1.0, flat_pose, out.depth

    def sample_views(self, generator: Optional[torch.Generator], n: int):
        return poses_mod.sample_yaw_pitch(generator, n, self.cfg.camera, device=self.device)

    def _sample_z(self, generator: Optional[torch.Generator], n: int) -> torch.Tensor:
        return torch.randn((n, self.cfg.train.z_dim), generator=generator).to(self.device)

    # -- the two losses -----------------------------------------------------------

    def d_loss_terms(self, state: TrainState, real_imgs: torch.Tensor,
                     real_pose: Optional[torch.Tensor], fake_imgs: torch.Tensor,
                     fake_pose: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(loss_real, loss_fake, r1)`` of D on a real and a fake batch, with
        the graph to D's parameters."""
        t = self.cfg.train
        loss_real, loss_fake = d_gan_loss(state.D(real_imgs, real_pose),
                                          state.D(fake_imgs, fake_pose))

        def d_for_r1(imgs):
            if t.r1_remat:
                # rematerialize D's activations inside the double backward:
                # less live memory for one more D forward
                return checkpoint(state.D, imgs, real_pose, use_reentrant=False)
            return state.D(imgs, real_pose)

        return loss_real, loss_fake, r1_penalty(d_for_r1, real_imgs, t.r1_lambda)

    def _g_micro_losses(self, state: TrainState, z, yaws, pitches,
                        generator: Optional[torch.Generator], noise_mode: str
                        ) -> Iterator[torch.Tensor]:
        """G's loss per micro-batch, each already divided by ``batch_split``."""
        t = self.cfg.train
        split = self.cfg.hparams.batch_split
        if z.shape[0] % split:
            raise ValueError(f"batch {z.shape[0]} is not a multiple of batch_split {split}")
        mbs = z.shape[0] // split
        for s in range(split):
            sl = slice(s * mbs, (s + 1) * mbs)
            with record_function("train_step.g_forward"):
                mpi = self.synth(state.G, z[sl], generator, noise_mode)
                mpi = self.maybe_light(mpi, state.step, generator)
                imgs, flat_pose, depth = self.render_views(mpi, yaws[sl], pitches[sl])
                loss = g_gan_loss(state.D(imgs, flat_pose))
                if t.use_edge_aware_loss:
                    loss = loss + t.edge_aware_loss_w * edge_aware_smooth_loss(
                        imgs, depth, t.edge_aware_loss_e_min, t.edge_aware_loss_g_min)
            yield loss / split

    def g_loss(self, state: TrainState, z: torch.Tensor, yaws: torch.Tensor,
               pitches: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise_mode: str = "random") -> torch.Tensor:
        """G's loss on the batch ``z`` rendered at ``yaws``/``pitches`` (the
        mean over ``batch_split`` micro-batches), with the graph to G's
        parameters."""
        return sum(self._g_micro_losses(state, z, yaws, pitches, generator, noise_mode))

    # -- phases -----------------------------------------------------------------

    def d_phase(self, state: TrainState, real_imgs, real_pose,
                generator: Optional[torch.Generator]):
        t = self.cfg.train
        bs = real_imgs.shape[0]
        z = self._sample_z(generator, bs)
        yaws, pitches = self.sample_views(generator, bs)
        # fakes carry no gradient; micro-batching them bounds the live plane stacks
        split = self.cfg.hparams.batch_split
        d_split = split if (t.d_batch_split and bs % split == 0) else 1
        mbs = bs // d_split
        fakes, fake_poses = [], []
        with torch.no_grad(), record_function("train_step.d_fakes"):
            for s in range(d_split):
                sl = slice(s * mbs, (s + 1) * mbs)
                mpi = self.maybe_light(self.synth(state.G, z[sl], generator), state.step,
                                       generator)
                imgs, pose, _ = self.render_views(mpi, yaws[sl], pitches[sl])
                fakes.append(imgs)
                fake_poses.append(pose)
        fake_imgs = torch.cat(fakes)
        fake_pose = None if fake_poses[0] is None else torch.cat(fake_poses)

        state.D.zero_grad(set_to_none=True)
        with record_function("train_step.d_loss"):
            loss_real, loss_fake, r1 = self.d_loss_terms(state, real_imgs, real_pose, fake_imgs,
                                                         fake_pose)
            d_loss = loss_real + loss_fake + r1
        with record_function("train_step.d_backward"):
            d_loss.backward()
        metrics = {"d_loss": d_loss.detach(), "d_loss_real": loss_real.detach(),
                   "d_loss_fake": loss_fake.detach(), "r1": r1.detach()}
        grads = _grads(state.D) if self.return_grads else None
        if t.train_d:  # a frozen D reports its losses and takes no update
            with record_function("train_step.d_update"):
                torch.nn.utils.clip_grad_norm_(state.D.parameters(), t.grad_clip)
                state.opt_d.step()
        state.D.zero_grad(set_to_none=True)
        return metrics, grads

    @torch.no_grad()
    def worst_views(self, state: TrainState, z: torch.Tensor,
                    generator: Optional[torch.Generator]):
        """Per z the camera that D scores lowest among ``n_view_per_z``
        candidates.  All candidates render in one call, each MPI into its
        ``n_view_per_z`` consecutive views (z-major)."""
        t = self.cfg.train
        bs, v = z.shape[0], t.n_view_per_z
        mpi = self.synth(state.G, z, generator)
        yaws, pitches = self.sample_views(generator, bs * v)
        # z-major: [z0v0, z0v1, ...]
        imgs, flat_pose, _ = self.render_views(mpi, yaws, pitches,
                                               low_res=t.worst_view_render_res)
        scores = state.D(imgs, flat_pose).reshape(bs, v)
        sel = torch.argmin(scores, dim=1) + torch.arange(bs, device=scores.device) * v
        return yaws[sel], pitches[sel]

    def g_phase(self, state: TrainState, bs: int, generator: Optional[torch.Generator]):
        t = self.cfg.train
        z = self._sample_z(generator, bs)
        if t.n_view_per_z > 1 and t.select_worst_view:
            with record_function("train_step.worst_views"):
                yaws, pitches = self.worst_views(state, z, generator)
        else:
            yaws, pitches = self.sample_views(generator, bs)

        state.G.zero_grad(set_to_none=True)
        state.D.requires_grad_(False)  # D only scores here
        try:
            g_loss = 0.0
            for loss in self._g_micro_losses(state, z, yaws, pitches, generator, "random"):
                with record_function("train_step.g_backward"):
                    loss.backward()  # one micro-batch's graph alive at a time
                g_loss = g_loss + loss.detach()
        finally:
            state.D.requires_grad_(True)
        grads = _grads(state.G) if self.return_grads else None
        with record_function("train_step.g_update"):
            for group in state.opt_g.param_groups:  # each group clips by its own norm
                torch.nn.utils.clip_grad_norm_(group["params"], t.grad_clip)
            state.opt_g.step()
            state.G.zero_grad(set_to_none=True)

            # w_avg running mean, one update per step from the updated mapping
            with torch.no_grad():
                state.G.mapping.w_avg.copy_(state.G.mapping.updated_w_avg(state.G.mapping(z)))
            _ema_update(state.ema, state.G, t.ema_decay)
            _ema_update(state.ema2, state.G, t.ema2_decay)
        return {"g_loss": g_loss}, grads

    def __call__(self, state: TrainState, real_imgs: torch.Tensor,
                 real_pose: Optional[torch.Tensor],
                 generator: Optional[torch.Generator] = None):
        """One D update and ``g_iters`` G updates.  ``real_imgs`` in [-1, 1],
        ``real_pose`` the dataset's flat world-to-camera conditioning vector;
        both on the step's device."""
        d_metrics, grads_d = self.d_phase(state, real_imgs, real_pose, generator)
        g_metrics, grads_g = {}, None
        for _ in range(self.cfg.train.g_iters):
            g_metrics, grads_g = self.g_phase(state, real_imgs.shape[0], generator)
        state.step += 1
        metrics = {**d_metrics, **g_metrics}
        if self.return_grads:
            return state, metrics, {"d": grads_d, "g": grads_g}
        return state, metrics


def make_train_step(cfg: ExperimentConfig, device="cuda", mesh=None,
                    return_grads: bool = False) -> TrainStep:
    """Build the train step for a configuration; see :class:`TrainStep`."""
    return TrainStep(cfg, device=device, mesh=mesh, return_grads=return_grads)
