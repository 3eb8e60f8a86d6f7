#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port ``gmpi_tpu_torch`` (one CUDA card).

    python3 chip_smoke.py

Phases, each of which raises on failure (nonzero exit, no result line):

1. setup — print the card's name and power limit, build every CUDA kernel
   from ``gmpi_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel), turn
   TF32 off for cuDNN convolutions and matmuls;
2. kernels vs plain versions — each kernel and its plain PyTorch version on
   the same inputs.  (a) The forward at the serving shapes (V=4 views, L=96
   planes, 256^2 texture and image, FFHQ256 geometry, poses at the truncation
   corners and the centre), with and without expected disparity; max abs
   error <= 1e-4.  (b) All three at the training shapes (V=8, L=32, 256^2,
   poses at the truncation corners, edge midpoints and centre): the forward's
   training form (outputs, residual on live slots, ``n_live``), the composite
   backward (random cotangents, the optional ones on and off, the residual's
   dead slots NaN-poisoned) and the splat; max error <= 1e-4 x max|plain| per
   field.  Then the forward as the step's two no-grad renders launch it (the
   inference form without disparity): the D phase's fakes at V=8, L=32, and
   worst-view selection at V=32, L=32 on the 8 stacks repeated 4 times each
   (a materialized 1.07 GB copy); max abs error <= 1e-4.  All on three MPIs:
   uniform random RGBA, a sparse (mostly transparent) stack, and the sparse
   stack with fully opaque mid planes;
3. serving main path — ``FakeImageGenerator`` at full FFHQ256 width with
   seeded random weights and the fused renderer: for 4 seeds, ``sample_mpi``
   then ``render`` of 4 views.  Kernel launch counts are reset just before and
   read just after; outputs must be finite, colors in [-1, 1], depths inside
   the plane range, and the last render must match the gather renderer;
4. training main path — ``init_train_state`` + ``make_train_step`` on the full
   FFHQ256 preset (batch 8, 32 planes, worst of 4 views per z) with seeded
   random weights and a seeded random real batch: 2 warm-up and 3 timed steps,
   one step timed by phase (D, G), then one step past ``lighting_start_iter`` so the
   lighting augmentation runs.  Launch counts are reset just before and read
   just after: per step 3 forward launches (D phase, worst views, G phase)
   and ``batch_split`` each of the composite backward and the splat.  Metrics
   finite, ``r1 > 0``, G, D, both EMAs and ``w_avg`` changed, every parameter
   gradient finite; then the fused renderer's ``rgba`` gradient against the
   gather renderer's autograd on the same inputs (relative 1e-3);
5. timing at the main paths' inputs (CUDA events, median of 20 after
   warm-up) and each kernel's bound from the bytes and operations those inputs
   need: the forward in each of the three forms a train step launches (D
   phase, worst views at V=32, G phase), the composite backward and the splat.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

H100_RATES = {  # (bytes/s, fp32 FLOP/s): NVIDIA data sheets, dense, full power
    "PCIe": (2.0e12, 51.2e12),
    "SXM": (3.35e12, 67e12),
}
# fp32 operations per live (pixel, plane) pair: taps, lerps and composite;
# the recurrence of the backward; coordinates, weights and 16 products
FLOP_PER_PAIR = {"fused_fwd": 60, "composite_bwd": 25, "splat": 30}
TOL = 1e-4
GRAD_REL = 1e-3
N_STEPS = (2, 3)  # warm-up, timed


def log(*args):
    print(*args, flush=True)


def card_rates(name: str):
    return H100_RATES["PCIe" if "PCIe" in name else "SXM"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn):
    """``(result, milliseconds)`` of ``fn()``, host clock around a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def fused_inputs(fr, dhw, ray_dir, eye, z_dir, tex_size):
    scal = fr.plane_affine(dhw, eye, tex_size, tex_size).contiguous()
    rx, ry, q = (x.contiguous() for x in fr.ray_fields(ray_dir, z_dir))
    return rx, ry, q, scal


def needed_work(fr, tex, rx, ry, scal, n_live=None):
    """What the fused forward needs on these inputs: ``(texels touched by some
    live tap, live (pixel, plane) pairs)``.  A pair is live while the pixel's
    transmittance is >= the early-out threshold, or, given ``n_live`` (the
    training form), while ``l < n_live``."""
    v, n_l = scal.shape[:2]
    th, tw = tex.shape[-2:]
    shared = v > 1 and tex.stride(0) == 0
    touched = torch.zeros(((1 if shared else v) * n_l * th * tw,), dtype=torch.bool,
                          device=tex.device)
    view_base = (0 if shared else 1) * torch.arange(v, device=tex.device).reshape(v, 1, 1)
    t = torch.ones_like(rx)
    pairs = 0
    for l in range(n_l):
        live = (t >= fr.EARLY_OUT_T) if n_live is None else (l < n_live)
        pairs += int(live.sum())
        s = scal[:, l, :, None, None]
        fx, fy = s[:, 0] * rx + s[:, 1], s[:, 2] * ry + s[:, 3]
        x0, y0 = torch.floor(fx), torch.floor(fy)
        for dy in (0, 1):
            for dx in (0, 1):
                xx, yy = x0 + dx, y0 + dy
                ok = live & (xx >= 0) & (xx <= tw - 1) & (yy >= 0) & (yy <= th - 1)
                # the texel's index within its plane is exact in fp32; the rest in int64
                idx = ((view_base * n_l + l) * th * tw
                       + (yy.clamp(0, th - 1) * tw + xx.clamp(0, tw - 1)).long())
                touched[idx[ok]] = True
        if n_live is None:
            a = fr.sample_bilinear(tex[:, l], fx, fy)[:, 3]
            t = t * ((1.0 - a) + fr.EPS)
    return int(touched.sum()), pairs


def bound(n_bytes: int, n_flop: int, rates):
    """``(bound ms, "bytes" or "operations")``: the larger of bytes over the
    memory rate and operations over the fp32 rate."""
    by_bytes, by_ops = n_bytes / rates[0] * 1e3, n_flop / rates[1] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def rel_err(a, b):
    """max|a - b| / max|b|, NaN-propagating."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def three_stacks(v, n_planes, res, dev, seed):
    """uniform, sparse (alpha x 0.05) and sparse with 8 opaque mid planes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    uniform = torch.rand((v, n_planes, 4, res, res), device=dev, generator=g)
    sparse = uniform.clone()
    sparse[:, :, 3] *= 0.05
    opaque_mid = sparse.clone()
    opaque_mid[:, n_planes // 2 - 4:n_planes // 2 + 4, 3] = 1.0
    return (("uniform", uniform), ("sparse", sparse), ("opaque_mid", opaque_mid))


def check_inference_form(fr, label, tex, rx, ry, q, scal, with_disp):
    """The forward's inference form (transmittance early-out, no residual)
    against its plain version; returns the largest absolute error."""
    out = fr.warp_composite_fwd(tex, rx, ry, q, scal, with_disp=with_disp)
    ref = fr.warp_composite_fwd_ref(tex, rx, ry, q, scal, with_disp=with_disp)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    log(f"fused_fwd vs plain [{label}, with_disp={with_disp}]: max abs err "
        f"{max(errs):.3e} (fields {['%.2e' % e for e in errs]})")
    if not all(e <= TOL for e in errs):  # also catches NaN
        raise RuntimeError(f"fused_fwd [{label}] disagrees with its plain version: "
                           f"{errs} > {TOL}")
    return max(errs)


def check_training_kernels(fr, case, tex, rx, ry, q, scal, gen):
    """Phase 2b on one stack: the three kernels against their plain versions.
    Returns each kernel's largest error (relative to max|plain| per field)."""
    v, n_l = scal.shape[:2]
    res = tex.shape[-1]
    errs = {"fused_fwd": 0.0, "composite_bwd": 0.0, "splat": 0.0}
    planes = torch.arange(n_l, device=tex.device).reshape(1, n_l, 1, 1, 1)

    for with_disp in (False, True):
        out = fr.warp_composite_fwd(tex, rx, ry, q, scal, early_out="grad",
                                    with_disp=with_disp, with_warped=True)
        ref = fr.warp_composite_fwd_ref(tex, rx, ry, q, scal, early_out="grad",
                                        with_disp=with_disp, with_warped=True)
        torch.cuda.synchronize()
        e = [rel_err(a, b) for a, b in zip(out[:-2], ref[:-2])]
        (warped, n_live), (warped_ref, n_live_ref) = out[-2:], ref[-2:]
        # a pixel whose S / M sits within rounding of the threshold may stop one
        # plane apart in the two versions; anything more is a disagreement
        moved = (n_live != n_live_ref)
        if int((n_live - n_live_ref).abs().max()) > 1 or float(moved.float().mean()) > 1e-4:
            raise RuntimeError(f"fused_fwd [{case}]: n_live disagrees with the plain version on "
                               f"{int(moved.sum())} pixels")
        both = planes < torch.minimum(n_live, n_live_ref)[:, None, None]
        e.append(float(torch.where(both, warped - warped_ref, 0.0).abs().max()
                       / torch.where(both, warped_ref, 0.0).abs().max()))
        log(f"fused_fwd training form vs plain [{case}, with_disp={with_disp}]: rel err "
            f"{max(e):.3e}, n_live {int(n_live.min())}..{int(n_live.max())} "
            f"(mean {float(n_live.float().mean()):.2f}), differing on {int(moved.sum())} pixels")
        errs["fused_fwd"] = max(errs["fused_fwd"], *e)

    # the kernel leaves dead residual slots unwritten: poison them
    warped = torch.where(planes < n_live[:, None, None], warped, float("nan"))
    gc = torch.randn((v, 3, res, res), device=tex.device, generator=gen)
    gd, gp, gt = (torch.randn((v, res, res), device=tex.device, generator=gen) for _ in range(3))
    for opt in ((None, None, None), (gd, gp, gt)):
        d_samp = fr.composite_bwd(warped, q, scal, gc, *opt, n_live=n_live, grad_tau=fr.GRAD_TAU)
        d_ref = fr.composite_bwd_ref(warped, q, scal, gc, *opt, n_live=n_live,
                                     grad_tau=fr.GRAD_TAU)
        torch.cuda.synchronize()
        e = [rel_err(d_samp[:, :, :3], d_ref[:, :, :3]), rel_err(d_samp[:, :, 3], d_ref[:, :, 3])]
        log(f"composite_bwd vs plain [{case}, optional cotangents "
            f"{'on' if opt[0] is not None else 'off'}]: rel err rgb {e[0]:.3e}, alpha {e[1]:.3e} "
            f"(max|d_alpha| {float(d_ref[:, :, 3].abs().max()):.3e})")
        errs["composite_bwd"] = max(errs["composite_bwd"], *e)
        dead = planes >= n_live[:, None, None]
        if float(torch.where(dead, d_samp, 0.0).abs().max()) != 0.0:
            raise RuntimeError(f"composite_bwd [{case}]: a dead slot's cotangent is not zero")

        d_tex = fr.warp_splat(d_ref, rx, ry, scal, res, res, n_live=n_live)
        t_ref = fr.warp_splat_ref(d_ref, rx, ry, scal, res, res, n_live=n_live)
        torch.cuda.synchronize()
        e = rel_err(d_tex, t_ref)
        log(f"splat vs plain [{case}]: rel err {e:.3e}")
        errs["splat"] = max(errs["splat"], e)
    for name, e in errs.items():
        if not e <= TOL:  # also catches NaN
            raise RuntimeError(f"{name} [{case}] disagrees with its plain version: {e} > {TOL}")
    return errs


def snapshot(tensors):
    return [t.detach().clone() for t in tensors]


def changed(before, tensors) -> bool:
    return any(not torch.equal(a, b) for a, b in zip(before, tensors))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_fused
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.models.generator import Generator
    from gmpi_tpu_torch.ops import _build
    from gmpi_tpu_torch.ops import fused_render as fr
    from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step

    # -- 1. setup --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32: off for cuDNN convolutions and CUDA matmuls (full fp32)")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    if set(built) != set(fr.LAUNCHES):
        raise RuntimeError(f"built {sorted(built)}, expected {sorted(fr.LAUNCHES)}")
    for kname, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    dev = torch.device("cuda")
    cfg = get_config("FFHQ256")
    n_planes, res = cfg.eval_n_planes, cfg.resolution
    n_train = cfg.planes.n_planes
    eval_cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))
    geom = eval_cfg.plane_geometry(device=dev)
    geom_train = cfg.plane_geometry(device=dev)
    intr = cam.intrinsics_from_fov(cfg.fov_deg, res, res)
    c = cfg.camera
    k = c.n_truncated_stds
    max_err = dict.fromkeys(fr.LAUNCHES, 0.0)

    def rays_at(yaws, pitches):
        c2w, _, _ = poses.sample_sphere_poses(None, len(yaws), c, given_yaws=yaws,
                                              given_pitches=pitches, device=dev)
        return cam.generate_rays(intr, c2w)

    # -- 2a. forward kernel vs plain version at the serving shapes --------------
    yaws = torch.tensor([[k * c.yaw_std], [-k * c.yaw_std], [k * c.yaw_std], [0.0]])
    pitches = torch.tensor([[k * c.pitch_std], [-k * c.pitch_std], [-k * c.pitch_std], [0.0]])
    rx, ry, q, scal = fused_inputs(fr, geom.dhw, *rays_at(yaws, pitches), res)
    for case, tex in three_stacks(4, n_planes, res, dev, seed=0):
        for with_disp in (False, True):
            err = check_inference_form(fr, f"{case}, V=4, L={n_planes}", tex, rx, ry, q, scal,
                                       with_disp)
            max_err["fused_fwd"] = max(max_err["fused_fwd"], err)
        ms = time_ms(lambda: fr.warp_composite_fwd(tex, rx, ry, q, scal))
        log(f"fused_fwd [{case}] V=4 L={n_planes} {res}^2: {ms:.4f} ms ({card})")
        del tex

    # -- 2b. all three kernels vs plain versions at the training shapes ---------
    sy, sp = k * c.yaw_std, k * c.pitch_std
    yaws = torch.tensor([[sy], [-sy], [sy], [-sy], [0.0], [sy], [0.0], [-sy]])
    pitches = torch.tensor([[sp], [-sp], [-sp], [sp], [0.0], [0.0], [sp], [0.0]])
    rx, ry, q, scal = fused_inputs(fr, geom_train.dhw, *rays_at(yaws, pitches), res)
    # worst-view selection's 32 candidates: each of the 8 poses at 4 scales, z-major
    n_cand = cfg.train.n_view_per_z
    scales = torch.linspace(1.0, 0.25, n_cand).reshape(1, n_cand)
    rays_w = fused_inputs(fr, geom_train.dhw, *rays_at((yaws * scales).reshape(-1, 1),
                                                       (pitches * scales).reshape(-1, 1)), res)
    g = torch.Generator(device=dev).manual_seed(1)
    for case, tex in three_stacks(8, n_train, res, dev, seed=2):
        for kname, e in check_training_kernels(fr, case, tex, rx, ry, q, scal, g).items():
            max_err[kname] = max(max_err[kname], e)
        # the step's two no-grad renders: D-phase fakes, then worst-view candidates
        err = check_inference_form(fr, f"{case}, V=8, L={n_train}", tex, rx, ry, q, scal, False)
        tex_w = tex.repeat_interleave(n_cand, dim=0)
        err = max(err, check_inference_form(fr, f"{case}, V={8 * n_cand}, L={n_train}, repeated "
                                            f"stacks", tex_w, *rays_w, False))
        max_err["fused_fwd"] = max(max_err["fused_fwd"], err)
        del tex, tex_w
    torch.cuda.empty_cache()

    # -- 3. serving main path ----------------------------------------------------
    t0 = time.perf_counter()
    gen_module = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(0))
    gen = FakeImageGenerator(cfg, gen_module, use_fused=True, device=dev)
    log(f"generator: FFHQ256 full width ({sum(p.numel() for p in gen.G.parameters())} params, "
        f"{n_planes} planes), built in {time.perf_counter() - t0:.1f} s")
    seeds, n_views = (0, 1, 2, 3), 4
    gen_ms, render_ms = [], []
    lo, hi = cfg.planes.min_d * 0.9, cfg.planes.max_d * 1.4
    for kname in fr.LAUNCHES:
        fr.LAUNCHES[kname] = 0
    for seed in seeds:
        mpi, ms = host_ms(lambda: gen.sample_mpi(seed))
        gen_ms.append(ms)
        yv, pv = gen.sample_views(seed, n_views)
        mpi_v = mpi.expand(n_views, -1, -1, -1, -1)
        (color, depth), ms = host_ms(lambda: gen.render(mpi_v, yv, pv))
        render_ms.append(ms)
        if mpi.shape != (1, n_planes, 4, res, res) or not torch.isfinite(mpi).all():
            raise RuntimeError(f"seed {seed}: bad MPI {tuple(mpi.shape)}")
        if color.shape != (n_views, 3, res, res) or depth.shape != (n_views, 1, res, res):
            raise RuntimeError(f"seed {seed}: bad render shapes")
        if not (torch.isfinite(color).all() and torch.isfinite(depth).all()):
            raise RuntimeError(f"seed {seed}: non-finite render")
        if color.min() < -1.0 or color.max() > 1.0:
            raise RuntimeError(f"seed {seed}: color outside [-1, 1]")
        if depth.min() < lo or depth.max() > hi:
            raise RuntimeError(f"seed {seed}: depth {float(depth.min())}..{float(depth.max())} "
                               f"outside [{lo}, {hi}]")
    serving_launches = dict(fr.LAUNCHES)
    if serving_launches != {"fused_fwd": len(seeds), "composite_bwd": 0, "splat": 0}:
        raise RuntimeError(f"serving main path launched {serving_launches}, expected one "
                           f"fused_fwd per render call ({len(seeds)}) and no backward")
    log(f"serving main path: {len(seeds)} seeds x {n_views} views, launches {serving_launches}")
    mpix = n_views * res * res / 1e6
    log(f"generator ms per MPI: {['%.2f' % x for x in gen_ms]} (median "
        f"{statistics.median(gen_ms):.2f}; first includes cuDNN warm-up) ({card})")
    log(f"render ms per call of {n_views} views: {['%.3f' % x for x in render_ms]}, median per "
        f"view {statistics.median(render_ms) / n_views:.4f} ms, "
        f"{mpix / (statistics.median(render_ms) / 1e3):.1f} Mpix/s host-timed ({card})")

    # the last render against the gather renderer on the same inputs
    ray_dir, eye, z_dir = rays_at(yv, pv)
    with torch.no_grad():
        gather = render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir)
    err_c = float((color - (gather.color * 2.0 - 1.0)).abs().max())
    err_d = float((depth - gather.depth).abs().max())
    log(f"serving main path fused vs gather renderer: color {err_c:.3e}, depth {err_d:.3e} "
        f"(gate 5e-4)")
    if err_c > 5e-4 or err_d > 5e-4:
        raise RuntimeError("fused render disagrees with the gather renderer")

    # timing of the forward at the serving main path's inputs
    rx, ry, q, scal = fused_inputs(fr, geom.dhw, ray_dir, eye, z_dir, res)
    kernel = lambda: fr.warp_composite_fwd(mpi_v, rx, ry, q, scal)  # noqa: E731
    plain = lambda: fr.warp_composite_fwd_ref(mpi_v, rx, ry, q, scal)  # noqa: E731
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    max_err["fused_fwd"] = max(max_err["fused_fwd"],
                               *[float((a - b).abs().max()) for a, b in zip(out, ref)])
    with torch.no_grad():
        fwd_ms, fwd_plain_ms = time_ms(kernel), time_ms(plain, iters=20, warmup=1)
        gather_ms = time_ms(lambda: render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir),
                            iters=5, warmup=1)
    texels, pairs = needed_work(fr, mpi_v, rx, ry, scal)
    n_pix = rx.numel()
    fwd_bytes = texels * 16 + 3 * n_pix * 4 + scal.numel() * 4 + 6 * n_pix * 4
    fwd_bound = bound(fwd_bytes, FLOP_PER_PAIR["fused_fwd"] * pairs, rates)
    log(f"fused_fwd serving inputs: {fwd_ms:.4f} ms, plain {fwd_plain_ms:.3f} ms, gather "
        f"renderer (F.grid_sample + composite, informational) {gather_ms:.3f} ms; needs "
        f"{fwd_bytes} B, {FLOP_PER_PAIR['fused_fwd'] * pairs} FLOP ({pairs} live pixel-plane "
        f"pairs of {n_views * n_planes * res * res}); bound {fwd_bound[0]:.5f} ms ({card})")
    del gen, gen_module, mpi, mpi_v, gather, out, ref
    torch.cuda.empty_cache()

    # -- 4. training main path -------------------------------------------------------
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(cfg, device=dev)
    step_with_grads = make_train_step(cfg, device=dev, return_grads=True)
    bs, split = cfg.hparams.batch_size, cfg.hparams.batch_split
    data = torch.Generator().manual_seed(1)
    real = (torch.rand((bs, 3, res, res), generator=data) * 2.0 - 1.0).to(dev)
    real_c2w, _, _ = poses.sample_sphere_poses(data, bs, c, device=dev)
    real_pose = flat_pose_from_c2w(real_c2w, cfg.train.d_cond_pose_dim)
    log(f"train state: FFHQ256 full width (G {sum(p.numel() for p in state.G.parameters())} "
        f"params, D {sum(p.numel() for p in state.D.parameters())} params, batch {bs}, "
        f"{n_train} planes, {cfg.train.n_view_per_z} views per z, batch_split {split}, fused "
        f"renderer {step.use_fused}), built in {time.perf_counter() - t0:.1f} s")
    if not step.use_fused:
        raise RuntimeError("the train step did not select the fused renderer on a CUDA device")
    before = [snapshot(state.G.parameters()), snapshot(state.D.parameters()),
              snapshot(state.ema.values()), snapshot(state.ema2.values()),
              snapshot([state.G.mapping.w_avg])]
    rng = torch.Generator().manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    for kname in fr.LAUNCHES:
        fr.LAUNCHES[kname] = 0
    step_ms, all_metrics = [], []
    for _ in range(sum(N_STEPS)):
        (_, metrics), ms = host_ms(lambda: step(state, real, real_pose, rng))
        step_ms.append(ms)
        all_metrics.append(metrics)
    # one step by phase, as TrainStep.__call__ runs it
    (d_metrics, _), d_ms = host_ms(lambda: step.d_phase(state, real, real_pose, rng))
    (g_metrics, _), g_ms = host_ms(lambda: step.g_phase(state, bs, rng))
    state.step += 1
    all_metrics.append({**d_metrics, **g_metrics})
    # one step past the start of the lighting augmentation, gradients returned
    state.step = cfg.train.lighting_start_iter + 500
    (_, metrics, grads), lit_ms = host_ms(lambda: step_with_grads(state, real, real_pose, rng))
    all_metrics.append(metrics)
    train_launches = dict(fr.LAUNCHES)
    n_steps = len(all_metrics)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {"fused_fwd": 3 * n_steps, "composite_bwd": split * n_steps,
                "splat": split * n_steps}
    if train_launches != expected:
        raise RuntimeError(f"training main path launched {train_launches} in {n_steps} steps, "
                           f"expected {expected}")
    log(f"training main path: {n_steps} steps, launches {train_launches} (per step: 3 forward = "
        f"D phase + worst views + G phase, {split} composite backward, {split} splat)")
    for i, m in enumerate(all_metrics):
        vals = {key: float(val) for key, val in m.items()}
        log(f"  step {i}: " + ", ".join(f"{key} {val:.4f}" for key, val in vals.items()))
        if not all(map(lambda x: x == x and abs(x) != float("inf"), vals.values())):
            raise RuntimeError(f"step {i}: non-finite metric {vals}")
        if not vals["r1"] > 0:
            raise RuntimeError(f"step {i}: r1 = {vals['r1']} is not positive")
    now = [state.G.parameters(), state.D.parameters(), state.ema.values(), state.ema2.values(),
           [state.G.mapping.w_avg]]
    for what, a, b in zip(("G", "D", "ema", "ema2", "w_avg"), before, now):
        if not changed(a, list(b)):
            raise RuntimeError(f"{what} did not change over {n_steps} train steps")
    for which in ("d", "g"):
        bad = [key for key, val in grads[which].items() if not torch.isfinite(val).all()]
        if bad or not grads[which]:
            raise RuntimeError(f"non-finite or missing {which} gradients: {bad[:5]}")
    timed = step_ms[N_STEPS[0]:]
    log(f"train step ms (host clock after synchronize): warm-up "
        f"{['%.1f' % x for x in step_ms[:N_STEPS[0]]]}, timed {['%.1f' % x for x in timed]} "
        f"(median {statistics.median(timed):.1f}); by phase: D {d_ms:.1f}, G {g_ms:.1f}; lit step "
        f"with gradient copies {lit_ms:.1f}; peak memory {peak_gb:.2f} GB ({card})")
    del before, grads

    # the fused Function's rgba gradient against the gather renderer's autograd
    z = torch.randn((bs, cfg.train.z_dim), generator=rng).to(dev)
    with torch.no_grad():
        mpi = step.synth(state.G, z, rng)
    yv, pv = step.sample_views(rng, bs)
    ray_dir, eye, z_dir = rays_at(yv, pv)
    cot = torch.randn((bs, 3, res, res), device=dev, generator=g)
    grads_r = []
    for render in (render_mpi_fused, render_mpi):
        x = mpi.clone().requires_grad_()
        grads_r.append(torch.autograd.grad((render(x, geom_train.dhw, ray_dir, eye, z_dir).color
                                            * cot).sum(), x)[0])
    torch.cuda.synchronize()
    err_g = rel_err(grads_r[0], grads_r[1])
    log(f"training main path rgba gradient, fused Function vs gather autograd: rel err "
        f"{err_g:.3e} (gate {GRAD_REL}), max|grad| {float(grads_r[1].abs().max()):.3e}")
    if not err_g <= GRAD_REL:
        raise RuntimeError("the fused Function's gradient disagrees with the gather renderer's")
    del grads_r, x

    # -- 5. timing and bounds at the training main path's inputs ----------------------
    rx, ry, q, scal = fused_inputs(fr, geom_train.dhw, ray_dir, eye, z_dir, res)
    fwd_train = lambda: fr.warp_composite_fwd(  # noqa: E731
        mpi, rx, ry, q, scal, early_out="grad", with_disp=False, with_warped=True)
    *_, warped, n_live = fwd_train()
    d_samp = fr.composite_bwd(warped, q, scal, cot, n_live=n_live, grad_tau=fr.GRAD_TAU)
    d_samp_ref = fr.composite_bwd_ref(warped, q, scal, cot, n_live=n_live, grad_tau=fr.GRAD_TAU)
    d_tex = fr.warp_splat(d_samp, rx, ry, scal, res, res, n_live=n_live)
    d_tex_ref = fr.warp_splat_ref(d_samp, rx, ry, scal, res, res, n_live=n_live)
    torch.cuda.synchronize()
    max_err["composite_bwd"] = max(max_err["composite_bwd"], rel_err(d_samp, d_samp_ref))
    max_err["splat"] = max(max_err["splat"], rel_err(d_tex, d_tex_ref))
    if not (max_err["composite_bwd"] <= TOL and max_err["splat"] <= TOL):
        raise RuntimeError(f"a backward kernel disagrees with its plain version on the main "
                           f"path's inputs: {max_err}")
    del d_samp_ref, d_tex_ref, d_tex
    texels, pairs = needed_work(fr, mpi, rx, ry, scal, n_live=n_live)
    n_pix, stack = rx.numel(), mpi.numel() * 4
    all_pairs = bs * n_train * res * res
    work = {  # bytes each kernel must move on these inputs, each tensor once
        # texels touched + rays + scal + outputs + n_live + the live residual
        "fused_fwd_train": texels * 16 + 3 * n_pix * 4 + scal.numel() * 4 + 5 * n_pix * 4
        + n_pix * 4 + pairs * 16,
        # live residual + q, g_color, n_live + scal; d_samp written whole
        "composite_bwd": pairs * 16 + 5 * n_pix * 4 + scal.numel() * 4 + stack,
        # live d_samp + rx, ry, n_live + scal; d_tex written whole
        "splat": pairs * 16 + 3 * n_pix * 4 + scal.numel() * 4 + stack,
    }
    with torch.no_grad():
        t_fwd_train = time_ms(fwd_train)
        t_fwd_train_plain = time_ms(lambda: fr.warp_composite_fwd_ref(
            mpi, rx, ry, q, scal, early_out="grad", with_disp=False, with_warped=True),
            iters=5, warmup=1)
        t_bwd = time_ms(lambda: fr.composite_bwd(warped, q, scal, cot, n_live=n_live,
                                                 grad_tau=fr.GRAD_TAU))
        t_bwd_plain = time_ms(lambda: fr.composite_bwd_ref(warped, q, scal, cot, n_live=n_live,
                                                           grad_tau=fr.GRAD_TAU),
                              iters=5, warmup=1)
        t_splat = time_ms(lambda: fr.warp_splat(d_samp, rx, ry, scal, res, res, n_live=n_live))
        t_splat_plain = time_ms(lambda: fr.warp_splat_ref(d_samp, rx, ry, scal, res, res,
                                                          n_live=n_live), iters=5, warmup=1)
    # one PyTorch call that computes the splat's function: grid_sample's backward
    # (timed here as a yardstick, used nowhere in the port)
    from gmpi_tpu_torch.core.renderer import homography_grid
    per_plane = lambda x: x[:, None].expand(bs, n_train, *x.shape[1:]).reshape(  # noqa: E731
        bs * n_train, *x.shape[1:])
    grid, _ = homography_grid(geom_train.dhw.repeat(bs, 1), per_plane(eye), per_plane(ray_dir),
                              per_plane(z_dir))
    tex_flat = mpi.reshape(bs * n_train, 4, res, res).clone().requires_grad_()
    sampled = torch.nn.functional.grid_sample(tex_flat, grid, mode="bilinear",
                                              padding_mode="zeros", align_corners=True)
    d_flat = d_samp.reshape(sampled.shape)
    t_splat_lib = time_ms(lambda: torch.autograd.grad(sampled, tex_flat, d_flat,
                                                      retain_graph=True), iters=10, warmup=2)
    del sampled, tex_flat, grid, d_flat
    bounds = {key: bound(val, FLOP_PER_PAIR[key.replace("_train", "")] * pairs, rates)
              for key, val in work.items()}
    log(f"training inputs: {pairs} live pixel-plane pairs of {all_pairs} "
        f"(mean n_live {float(n_live.float().mean()):.2f} of {n_train}), {texels} texels touched")
    log(f"fused_fwd training form: {t_fwd_train:.4f} ms, plain {t_fwd_train_plain:.3f} ms, "
        f"needs {work['fused_fwd_train']} B; bound {bounds['fused_fwd_train'][0]:.5f} ms ({card})")
    log(f"composite_bwd: {t_bwd:.4f} ms, plain {t_bwd_plain:.3f} ms, needs "
        f"{work['composite_bwd']} B; bound {bounds['composite_bwd'][0]:.5f} ms ({card})")
    log(f"splat: {t_splat:.4f} ms, plain {t_splat_plain:.3f} ms, grid_sample backward "
        f"{t_splat_lib:.4f} ms, needs {work['splat']} B; bound {bounds['splat'][0]:.5f} ms "
        f"({card})")
    del warped, d_samp
    torch.cuda.empty_cache()

    # the forward's two no-grad launches of a step at the main path's inputs: the D phase's
    # fakes (these 8 MPIs and views) and worst-view selection (each MPI repeated over its
    # candidate views, a materialized copy, as TrainStep.worst_views renders it)
    yv_w, pv_w = step.sample_views(rng, bs * n_cand)
    mpi_w = mpi.repeat_interleave(n_cand, dim=0)
    rays_w = fused_inputs(fr, geom_train.dhw, *rays_at(yv_w, pv_w), res)
    no_grad_forms = {}
    for form, tex, rays in (("d_phase_form", mpi, (rx, ry, q, scal)),
                            ("worst_views_form", mpi_w, rays_w)):
        err = check_inference_form(fr, f"main path's inputs, {form}, V={tex.shape[0]}", tex,
                                   *rays, False)
        max_err["fused_fwd"] = max(max_err["fused_fwd"], err)
        t_kernel = time_ms(lambda: fr.warp_composite_fwd(tex, *rays, with_disp=False))
        t_plain = time_ms(lambda: fr.warp_composite_fwd_ref(tex, *rays, with_disp=False),
                          iters=5, warmup=1)
        texels_f, pairs_f = needed_work(fr, tex, *rays[:2], rays[3])
        n_pix_f = rays[0].numel()
        bytes_f = texels_f * 16 + 3 * n_pix_f * 4 + rays[3].numel() * 4 + 5 * n_pix_f * 4
        b = bound(bytes_f, FLOP_PER_PAIR["fused_fwd"] * pairs_f, rates)
        log(f"fused_fwd {form} (V={tex.shape[0]}, L={n_train}, no gradient): {t_kernel:.4f} ms, "
            f"plain {t_plain:.3f} ms, needs {bytes_f} B ({pairs_f} live pixel-plane pairs of "
            f"{tex.shape[0] * n_train * res * res}, {texels_f} texels touched); bound "
            f"{b[0]:.5f} ms by {b[1]} ({card})")
        no_grad_forms.update({f"{form}_ms": t_kernel, f"{form}_plain_ms": t_plain,
                              f"{form}_bound_ms": b[0]})
    del mpi, mpi_w
    torch.cuda.empty_cache()

    def entry(kname, line, ms, plain_ms, b, library_ms, **extra):
        return {"name": kname, "route": "cuda", "source": f"gmpi_tpu_torch/csrc/{kname}.cu",
                "replaces": f"gmpi_tpu/ops/pallas_warp.py:{line}",
                "launches": serving_launches[kname] + train_launches[kname],
                "max_abs_err": max_err[kname], "err_scale": "max|plain| per field", "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": library_ms, **extra}

    record = {"kernels": [
        entry("fused_fwd", 518, fwd_ms, fwd_plain_ms, fwd_bound, None,
              serving_launches=serving_launches["fused_fwd"],
              train_launches=train_launches["fused_fwd"], train_form_ms=t_fwd_train,
              train_form_plain_ms=t_fwd_train_plain,
              train_form_bound_ms=bounds["fused_fwd_train"][0], **no_grad_forms),
        entry("composite_bwd", 2407, t_bwd, t_bwd_plain, bounds["composite_bwd"], None,
              also_replaces="gmpi_tpu/ops/pallas_warp.py:2295"),
        entry("splat", 1355, t_splat, t_splat_plain, bounds["splat"], t_splat_lib,
              also_replaces="gmpi_tpu/ops/pallas_warp.py:1184"),
    ], "train_steps": n_steps, "train_step_ms": statistics.median(timed)}
    log(json.dumps(record))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
