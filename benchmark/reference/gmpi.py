"""The plain reference of what the benchmark's cells time: FID sampling (one
seed's MPI and one rendered view) and the GAN train step.

Built from the configuration file's ``experiment`` (the preset's fields, as
``dataclasses.asdict`` writes them), with the frozen model copies of this
package and the per-pixel renderer of ``render.py``; float32, TF32 off
unless ``precision.mode`` says otherwise.  Randomness is drawn as the
program draws it (the same generators, in the same order), so that the same
seed gives the same z, poses, synthesis noise and light.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import camera, geometry, lighting, poses, render
from benchmark.reference.discriminator import Discriminator, DiscriminatorCfg
from benchmark.reference.generator import Generator, GeneratorCfg, SynthesisNetworkCfg
from benchmark.reference.losses import d_gan_loss, g_gan_loss, r1_penalty

# ---- the configuration ------------------------------------------------------------


def generator_cfg(exp: dict) -> GeneratorCfg:
    m, t, res = exp["model"], exp["train"], exp["resolution"]
    fmaps = 0.5 if res == 256 else 1.0  # StyleGAN2's cfg specs
    return GeneratorCfg(
        z_dim=t["z_dim"], w_dim=t["w_dim"], img_resolution=res,
        background_alpha_full=m["background_alpha_full"], final_img_act=m["final_img_act"],
        synthesis=SynthesisNetworkCfg(
            w_dim=t["w_dim"], img_resolution=res,
            channel_base=int(m["channel_base"] * fmaps), channel_max=m["channel_max"],
            num_bf16_res=m["num_bf16_res"] if res > 128 else 0,
            conv_clamp=m["conv_clamp"] if res > 128 else None,
            pos_enc_multires=m["pos_enc_multires"], cond_mode=m["cond_mode"],
            embed_func=m["embed_func"], sep_background=m["sep_background"],
            build_bg_from_rgb=m["build_bg_from_rgb"], bg_ratio=m["bg_ratio"],
            only_alpha=m["only_alpha"], gen_alpha_largest_res=m["gen_alpha_largest_res"]))


def discriminator_cfg(exp: dict) -> DiscriminatorCfg:
    m, t, res = exp["model"], exp["train"], exp["resolution"]
    fmaps = 0.5 if res == 256 else 1.0
    return DiscriminatorCfg(
        c_dim=t["d_cond_pose_dim"] if t["d_cond_on_pose"] else 0, img_resolution=res,
        channel_base=int(m["channel_base"] * fmaps), channel_max=m["channel_max"],
        num_bf16_res=m["num_bf16_res"] if res > 128 else 0,
        conv_clamp=m["conv_clamp"] if res > 128 else None,
        cmap_dim=m["cmap_dim"], mbstd_group_size=m["mbstd_group_size"])


def camera_cfg(exp: dict) -> poses.SphereCameraConfig:
    return poses.SphereCameraConfig(**exp["camera"])


def plane_geometry(exp: dict, n_planes: int, device) -> geometry.PlaneGeometry:
    c, p = exp["camera"], exp["planes"]
    return geometry.build_plane_geometry(
        n_planes=n_planes, min_d=p["min_d"], max_d=p["max_d"],
        distance_sample_method=p["distance_sample_method"], fov_deg=exp["fov_deg"],
        sphere_center_z=c["sphere_center_z"], sphere_r=c["sphere_r"],
        yaw_mean=c["yaw_mean"], yaw_std=c["yaw_std"], pitch_mean=c["pitch_mean"],
        pitch_std=c["pitch_std"], n_truncated_stds=c["n_truncated_stds"],
        enlarge_factor=p["enlarge_factor"], confined=p["confined"], device=device)


def conditioning(exp: dict, geom: geometry.PlaneGeometry, tex_size: int):
    m = exp["model"]
    return geometry.multi_res_xyz(geom, tex_size, normalized=m["use_normalized_xyz"],
                                  value_range=m["normalized_xyz_range"], ztype=m["xyz_ztype"])


def build_models(exp: dict, weights: Dict[str, torch.Tensor], device, with_d: bool = True):
    """G (and D) from ``weights`` (state-dict keys ``G.*`` and ``D.*``)."""
    with torch.device("meta"):
        G = Generator(generator_cfg(exp))
        D = Discriminator(discriminator_cfg(exp)) if with_d else None
    out = []
    for tag, module in (("G", G), ("D", D)):
        if module is None:
            continue
        module = _materialize(module, device)
        sd = {k[len(tag) + 1:]: v for k, v in weights.items() if k.startswith(tag + ".")}
        module.load_state_dict(sd, strict=True)
        out.append(module)
    return out if with_d else out[0]


def _materialize(module: torch.nn.Module, device) -> torch.nn.Module:
    """A module built on meta tensors, on ``device``: the state dict comes
    from the caller, the non-persistent FIR filters are rebuilt."""
    from benchmark.reference.upfirdn2d import setup_filter

    module = module.to_empty(device=device)
    for sub in module.modules():
        if "resample_filter" in sub._buffers:
            taps = getattr(getattr(sub, "cfg", None), "resample_filter", (1, 3, 3, 1))
            sub._buffers["resample_filter"] = torch.from_numpy(
                setup_filter(list(taps))).to(device)
    return module


# ---- FID sampling -------------------------------------------------------------------


class Sampler:
    """One seed's MPI at the eval plane count and its view at a pose drawn
    from the seed, as ``FakeImageGenerator.sample_mpi`` / ``sample_views`` /
    ``render`` define them (noise ``const``, truncation 1)."""

    def __init__(self, exp: dict, G: Generator, device, plane_chunk: int = 0):
        self.exp, self.G, self.device = exp, G.eval(), torch.device(device)
        self.n_planes = exp["eval_n_planes"]
        self.geom = plane_geometry(exp, self.n_planes, self.device)
        self.xyz = conditioning(exp, self.geom, exp["resolution"])
        self.intr = camera.intrinsics_from_fov(exp["fov_deg"], exp["resolution"],
                                               exp["resolution"])
        self.cam = camera_cfg(exp)
        self.plane_chunk = plane_chunk

    @torch.no_grad()
    def mpi(self, seed: int) -> torch.Tensor:
        z = torch.randn((1, self.exp["train"]["z_dim"]),
                        generator=torch.Generator().manual_seed(seed))
        return self.G(z.to(self.device), None, self.xyz, self.n_planes, noise_mode="const")

    def pose(self, seed: int):
        g = torch.Generator().manual_seed(seed * 1_000_003 + 17)
        return poses.sample_yaw_pitch(g, 1, self.cam, device=self.device)

    @torch.no_grad()
    def view(self, mpi: torch.Tensor, yaws, pitches):
        c2w, _, _ = poses.sample_sphere_poses(None, mpi.shape[0], self.cam, given_yaws=yaws,
                                              given_pitches=pitches, device=self.device)
        color, depth = render.render(mpi, self.geom.dhw, *camera.generate_rays(self.intr, c2w),
                                     plane_chunk=self.plane_chunk)
        return color * 2.0 - 1.0, depth


# ---- the train step -----------------------------------------------------------------

PICK_TOL = 1e-3  # radians between a chosen view and its candidate


def flat_pose_from_c2w(c2w: torch.Tensor, pose_dim: int) -> torch.Tensor:
    if pose_dim == 16:
        return torch.linalg.inv(c2w).reshape(c2w.shape[0], 16)
    return torch.linalg.inv(c2w[:, :3, :3]).reshape(c2w.shape[0], 9)


class TrainStep:
    """The GAN train step of the configuration: one D phase (fakes without a
    gradient, D on real and fake, R1, Adam after a global-norm clip) and one G
    phase (worst view of ``n_view_per_z`` candidates, then G through the
    renderer and D in ``batch_split`` micro-batches, a clip per Adam group,
    the ``w_avg`` update), lighting past ``lighting_start_iter``.

    ``pick`` (of a call): the views the program chose among each z's
    candidates, ``(yaws, pitches)``.  Worst-view selection is an argmin, and
    two candidates whose scores lie closer than rounding may be chosen either
    way; so the step records the gap, in the reference's own scores, between
    the program's pick and the best, and continues from the program's pick.
    Without ``picks`` it takes its own.  ``fault`` plants one:
    ``"half_batch"`` takes D's and G's losses over the first half of each
    batch alone, ``"d_half_batch"`` D's alone, ``"g_half_batch"`` G's alone.

    ``d_after`` (of a call): D's parameters by name, put in place between the
    D phase and the G phase, so that the G phase runs on the D that another
    run's D phase made.
    """

    def __init__(self, exp: dict, G: Generator, D: Discriminator, device,
                 fault: str = ""):
        self.exp, self.G, self.D = exp, G, D
        self.device = torch.device(device)
        t, h = exp["train"], exp["hparams"]
        self.t, self.h = t, h
        if fault not in ("", "half_batch", "d_half_batch", "g_half_batch"):
            raise ValueError(f"no fault {fault!r}")
        self.fault = fault
        self.cam = camera_cfg(exp)
        self.geom = plane_geometry(exp, exp["planes"]["n_planes"], self.device)
        self.xyz = conditioning(exp, self.geom, h["tex_size"])
        self.intr = camera.intrinsics_from_fov(exp["fov_deg"], h["img_size"], h["img_size"])
        c = exp["camera"]
        self.light_cfg = lighting.LightingConfig(
            sphere_center_z=c["sphere_center_z"], sphere_r=c["sphere_r"],
            ka_max=t["lighting_max_ka"], kd_max=t["lighting_max_kd"],
            n_grow_iters=t["lighting_grow_n_iters"])
        self.xyz_last_plane = geometry.plane_xyz_grid(self.geom, h["tex_size"],
                                                      h["tex_size"])[-1]
        kw = dict(betas=tuple(t["betas"]), eps=1e-8, weight_decay=t["weight_decay"],
                  foreach=False)
        self.opt_g = torch.optim.Adam(
            [{"params": list(G.mapping.parameters()), "lr": h["gen_lr"] * t["mapping_lr_mult"]},
             {"params": list(G.synthesis.parameters()), "lr": h["gen_lr"]}], **kw)
        self.opt_d = torch.optim.Adam(D.parameters(), lr=h["disc_lr"], **kw)
        self.view_gaps: List[float] = []
        self.chosen: List[tuple] = []  # the views each G phase went on with

    def _mean(self, x: torch.Tensor, phase: str) -> torch.Tensor:
        half = self.fault == "half_batch" or self.fault == f"{phase}_half_batch"
        return x[: max(1, x.shape[0] // 2)] if half else x

    def synth(self, z, generator):
        return self.G(z, None, self.xyz, self.exp["planes"]["n_planes"],
                      truncation_psi=self.t["truncation_psi"], noise_mode="random",
                      generator=generator)

    def maybe_light(self, mpi, step: int, generator):
        t = self.t
        if not t["aug_with_lighting"] or step <= t["lighting_start_iter"]:
            return mpi
        return lighting.light_mpi(self.light_cfg, mpi, self.geom.dhw, self.xyz_last_plane,
                                  step - t["lighting_start_iter"], generator)

    def render_views(self, mpi, yaws, pitches):
        n_views = yaws.shape[0]
        if n_views != mpi.shape[0]:
            mpi = mpi.repeat_interleave(n_views // mpi.shape[0], dim=0)
        c2w, _, _ = poses.sample_sphere_poses(None, n_views, self.cam, given_yaws=yaws,
                                              given_pitches=pitches, device=self.device)
        color, depth = render.render(mpi, self.geom.dhw, *camera.generate_rays(self.intr, c2w))
        pose = (flat_pose_from_c2w(c2w, self.t["d_cond_pose_dim"])
                if self.t["d_cond_on_pose"] else None)
        return color * 2.0 - 1.0, pose

    def score(self, imgs, pose):
        return self.D(imgs, pose)

    def _z(self, generator, n):
        return torch.randn((n, self.t["z_dim"]), generator=generator).to(self.device)

    def d_phase(self, step: int, real, real_pose, generator) -> Dict[str, torch.Tensor]:
        bs = real.shape[0]
        z = self._z(generator, bs)
        yaws, pitches = poses.sample_yaw_pitch(generator, bs, self.cam, device=self.device)
        split = self.h["batch_split"]
        d_split = split if (self.t["d_batch_split"] and bs % split == 0) else 1
        mbs = bs // d_split
        fakes, fake_poses = [], []
        with torch.no_grad():
            for s in range(d_split):
                sl = slice(s * mbs, (s + 1) * mbs)
                mpi = self.maybe_light(self.synth(z[sl], generator), step, generator)
                imgs, pose = self.render_views(mpi, yaws[sl], pitches[sl])
                fakes.append(imgs)
                fake_poses.append(pose)
        fake = torch.cat(fakes)
        fake_pose = None if fake_poses[0] is None else torch.cat(fake_poses)
        self.D.zero_grad(set_to_none=True)
        real_s, fake_s = self.score(real, real_pose), self.score(fake, fake_pose)
        loss_real, loss_fake = d_gan_loss(self._mean(real_s, "d"), self._mean(fake_s, "d"))

        def d_for_r1(imgs):
            return self._mean(self.score(imgs, real_pose), "d")

        r1 = r1_penalty(d_for_r1, real, self.t["r1_lambda"])
        d_loss = loss_real + loss_fake + r1
        d_loss.backward()
        torch.nn.utils.clip_grad_norm_(self.D.parameters(), self.t["grad_clip"])
        self.opt_d.step()
        self.D.zero_grad(set_to_none=True)
        return {"d_loss": d_loss.detach()}

    @torch.no_grad()
    def worst_views(self, z, generator, pick=None):
        bs, v = z.shape[0], self.t["n_view_per_z"]
        mpi = self.synth(z, generator)
        yaws, pitches = poses.sample_yaw_pitch(generator, bs * v, self.cam, device=self.device)
        imgs, pose = self.render_views(mpi, yaws, pitches)
        scores = self.score(imgs, pose).reshape(bs, v)
        sel = torch.argmin(scores, dim=1)
        if pick is not None:
            # the candidate nearest to each pick (draws rounded by a lower
            # precision differ in their last bits); one farther than
            # PICK_TOL is no candidate
            cand = torch.stack([yaws.reshape(bs, v), pitches.reshape(bs, v)], dim=-1)
            want = torch.stack([pick[0].reshape(bs, 1), pick[1].reshape(bs, 1)], dim=-1)
            dist = (cand - want.to(cand.device)).abs().amax(dim=-1)
            chosen = torch.argmin(dist, dim=1)
            if bool((dist.amin(dim=1) > PICK_TOL).any()):
                self.view_gaps.append(float("inf"))
            else:
                spread = (scores.amax() - scores.amin()).clamp_min(1e-12)
                gap = scores.gather(1, chosen[:, None])[:, 0] - scores.amin(dim=1)
                self.view_gaps.append(float((gap / spread).max()))
                sel = chosen
        idx = sel + torch.arange(bs, device=sel.device) * v
        self.chosen.append((yaws[idx].clone(), pitches[idx].clone()))
        return yaws[idx], pitches[idx]

    def g_phase(self, step: int, bs: int, generator, pick=None) -> Dict[str, torch.Tensor]:
        t = self.t
        z = self._z(generator, bs)
        if t["n_view_per_z"] > 1 and t["select_worst_view"]:
            yaws, pitches = self.worst_views(z, generator, pick)
        else:
            yaws, pitches = poses.sample_yaw_pitch(generator, bs, self.cam, device=self.device)
        self.G.zero_grad(set_to_none=True)
        self.D.requires_grad_(False)
        split = self.h["batch_split"]
        mbs = bs // split
        g_loss = 0.0
        try:
            for s in range(split):
                sl = slice(s * mbs, (s + 1) * mbs)
                mpi = self.maybe_light(self.synth(z[sl], generator), step, generator)
                imgs, pose = self.render_views(mpi, yaws[sl], pitches[sl])
                loss = g_gan_loss(self._mean(self.score(imgs, pose), "g")) / split
                loss.backward()
                g_loss = g_loss + loss.detach()
        finally:
            self.D.requires_grad_(True)
        for group in self.opt_g.param_groups:
            torch.nn.utils.clip_grad_norm_(group["params"], t["grad_clip"])
        self.opt_g.step()
        self.G.zero_grad(set_to_none=True)
        with torch.no_grad():
            self.G.mapping.w_avg.copy_(self.G.mapping.updated_w_avg(self.G.mapping(z)))
        return {"g_loss": g_loss}

    def __call__(self, step: int, real, real_pose, generator, pick=None, d_after=None):
        out = self.d_phase(step, real, real_pose, generator)
        if d_after is not None:
            with torch.no_grad():
                for name, v in self.D.named_parameters():
                    v.copy_(d_after[name])
        out.update(self.g_phase(step, real.shape[0], generator, pick))
        return out


def real_batch(images: np.ndarray, flat_poses: np.ndarray, index: np.ndarray, device):
    """The dataset's rows ``index`` as the step reads them: images uint8 HWC
    -> CHW in [-1, 1], and their flat world-to-camera poses."""
    x = images[index].astype(np.float32) / 255.0
    x = (x.transpose(0, 3, 1, 2) - 0.5) / 0.5
    return (torch.from_numpy(np.ascontiguousarray(x)).to(device),
            torch.from_numpy(np.ascontiguousarray(flat_poses[index], np.float32)).to(device))


def deep3dface_flat_poses(angles: np.ndarray, trans: np.ndarray, exp: dict) -> np.ndarray:
    """Flat w2c poses of Deep3DFace coefficients ``[N, 3]`` each, as the FFHQ
    dataset conditions D on them."""
    from benchmark.reference.pose_convert import w2c_from_deep3dface

    c, dim = exp["camera"], exp["train"]["d_cond_pose_dim"]
    out = []
    for a, t in zip(angles, trans):
        w2c = w2c_from_deep3dface(a[None], t[None], c["sphere_center_z"], c["sphere_r"],
                                  normalize_trans=True)
        out.append(w2c[0, :3, :3].reshape(-1) if dim == 9 else w2c[0].reshape(-1))
    return np.stack(out).astype(np.float32)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The training loader's order of ``n`` rows in ``epoch``: a shuffle by
    ``PCG64(seed + epoch)``, one shard."""
    idx = np.arange(n)
    np.random.Generator(np.random.PCG64(seed + epoch)).shuffle(idx)
    return idx
