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
   worst-view selection at V=32, L=32 on the 8 stacks, each read by its group
   of 4 views (and once against the kernel on a materialized repeat, which
   must be bitwise equal); max abs error <= 1e-4.  All on three MPIs:
   uniform random RGBA, a sparse (mostly transparent) stack, and the sparse
   stack with fully opaque mid planes.  (c) The patch gather against its plain
   version at the banded serving path's shapes: f32 and bf16, 16-byte-aligned
   and arbitrary offsets, patches at both corners of the padded texture;
   exact equality (it is a copy).  (d) The texture-space adjoint, on the
   three stacks' ``d_samp`` of (b), against its plain version and against the
   splat, max error <= 1e-4 x max|plain|, and two launches bitwise equal.
   (e) The forward, the adjoint, the splat and the composite backward at the
   edges of their designs: image and texture sizes that are not multiples of
   the tiles, a texture width that is not a multiple of 4, a plane count that
   is not a multiple of the staged group or of the composite backward's chunk,
   a slab of a parent stack on an unaligned address, a texture far larger than
   the image (boxes beyond the staging tile and beyond the splat's texel box),
   a strong minification (an adjoint box of many chunks), a pose with every
   tap outside the texture, a NaN ray, every ``early_out`` mode, with and
   without disparity and residual, on the three stacks; the splat in both
   paths, with and without ``n_live`` over NaN-poisoned dead slots; the
   composite backward with and without masks and optional cotangents, also at
   9 and 600 planes (checkpoints past one a chunk) on an odd pixel count;
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
   warm-up, one launch per event pair with everything the wrapper launches,
   and for the backward kernels also 10 launches queued) and each kernel's
   bound from the bytes and operations those inputs need: the forward in each
   of the three forms a train step launches (D phase, worst views at V=32, G
   phase), the composite backward, the splat in both of its paths (a tile's
   taps summed in its texel box, what the path takes at 256^2; every tap into
   ``d_tex``, the path of a box beyond the kernel's shared memory), and
   the adjoint (at phase 7's inputs); the patch gather is timed in phase 6 at
   that path's inputs;
6. banded serving path — ``FakeImageGenerator(use_fused=False)`` (on a card
   its patches come through the patch-gather kernel) renders the 96-plane MPIs
   of phase 3's seeds, 4 views each, through
   ``render_mpi(tiled_bands=bands_for_config(...))``: all 384 textures in one
   call, the tile rows looped in groups that keep the live hats under
   ``renderer.TILED_STEP_BYTES``; then the last MPI through
   ``render_mpi_chunked`` in slabs of 24 planes, twice.  Launch counts are
   reset just before and read just after: one patch-gather launch per call of
   the tiled warp's tile-row step, nothing else.  Every render must match the gather
   renderer within 5e-4 and ``bands_cover`` must hold at the sampled poses.
   One render is profiled by the tiled warp's spans (patches, hats, the two
   contractions) beside the fused and gather renders of the same MPI;
7. adjoint route at the training shapes (it runs right after phase 4, whose
   MPIs and cotangent it reuses) — ``render_mpi_fused(plans=plan_fused(...
   corner poses))`` forward and backward on the 8 MPIs of 32 planes: one
   ``fused_fwd``, one ``composite_bwd``, one ``adjoint`` launch and no
   ``splat``; the ``rgba`` gradient within 1e-3 of max|grad| of the splat
   route's and of the gather renderer's, and bitwise equal across two runs;
8. training loop from a dataset — in a temp dir, 20 seeded noise PNGs of
   256^2 in a zip with Deep3DFace ``.mat`` poses, one fail-listed (19 images,
   2 batches an epoch); ``train_gmpi_torch.main`` on the full FFHQ256 preset
   for 6 steps with snapshots and checkpoints every 3 (3 epochs); a checkpoint
   loaded into a fresh state must equal the saved state bitwise (G, D, both
   optimizers, both EMAs, step); 4 steps of the same step outside the loop on
   that state, timed as phase 4 times them; a resumed run to step 8 (starts at
   6, ``latest`` names step 8, 3 step directories kept); a third run
   warm-started from ``.npz`` exports of G and D, whose weights must equal
   the exports before its first step.  Launch counts are reset just before
   and read just after: per step 3 forward launches and ``batch_split`` each
   of the composite backward and the splat, 24 forward launches a snapshot,
   nothing else.  Every step's metrics finite, ``r1 > 0``; the PNG decodes
   counted by decoder.  Prints steps/s, step and data-wait ms, checkpoint
   seconds and bytes; the temp dir (~3 GB of checkpoints) is removed;
9. eval at full FFHQ256 width — in a temp dir, a checkpoint of a seeded
   state, seeded random InceptionV3 weights as a ``.pth`` under torchvision
   names, phase 8's kind of dataset and the stub adapters below:
   ``eval_gmpi_torch.main --task all`` (64 fakes, 16 consistency pairs, 16
   geometry images at 224^2, 96 planes, the banded renderer) twice, whose
   FID/KID, consistency and geometry numbers must be present, finite and
   equal; ``prepare_fake`` once more with ``--fused_renderer``, whose PNGs
   must be within 1 level of the banded run's.  Launch counts are reset
   before and read after each ``prepare_fake_images`` call: fused, one
   forward launch an image; banded, one patch-gather launch a tile-row step;
   nothing else.  The Inception features on the card against a CPU copy of
   the module (8 images, 1e-4 of max|CPU|); then Inception ms an image at
   batch 32 over 2048 random 256^2 images, ``frechet_distance`` seconds at
   2048 features, and ``train_gmpi_torch.main`` for 2 steps with the
   in-training FID (``--fid_interval 1 --fid_n_imgs 16``), which must log
   one finite ``fid``;
10. viz — ``render_gmpi_torch.main`` on phase 9's checkpoint: 8 frames of
   96 planes and a mesh of 128 planes; ``rendered.png``, the three sheets,
   the rgb and depth videos (mp4 or frame directories) and a ``mesh.ply``
   with vertices and in-range faces must exist; no kernel launches (the
   video renders by the per-pixel gather).  Prints ms a frame and the
   marching tetrahedra's seconds and counts.  The temp dir is removed.

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
FLOP_PER_PAIR = {"fused_fwd": 60, "composite_bwd": 25, "splat": 30, "adjoint": 30}
TOL = 1e-4
GRAD_REL = 1e-3
N_STEPS = (2, 3)  # warm-up, timed
N_DIRECT_STEPS = 4  # phase 8: steps timed outside the loop (the first warms up)


def log(*args):
    print(*args, flush=True)


def card_rates(name: str):
    return H100_RATES["PCIe" if "PCIe" in name else "SXM"]


def time_ms(fn, iters: int = 20, warmup: int = 3, queued: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs, CUDA events.  With
    ``queued`` > 1 each run is that many calls back to back and the time is
    per call: the card then waits for no launch, so what a wrapper does on
    the host (~0.05 ms of checks and allocations) drops out of a short
    kernel's time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(queued):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / queued)
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
    training form), while ``l < n_live``.  A stack read by a group of views
    (``tex [S, ...]`` for ``V = S * k`` views, or one stack expanded over all)
    counts its texels once."""
    v, n_l = scal.shape[:2]
    th, tw = tex.shape[-2:]
    n_stacks = 1 if (tex.shape[0] > 1 and tex.stride(0) == 0) else tex.shape[0]
    touched = torch.zeros((n_stacks * n_l * th * tw,), dtype=torch.bool, device=tex.device)
    view_base = (torch.arange(v, device=tex.device) // (v // n_stacks)).reshape(v, 1, 1)
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
            a = fr.sample_bilinear(tex[:n_stacks, l], fx, fy)[:, 3]
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


def worse(a: float, b: float) -> float:
    """The larger of two errors; a NaN wins."""
    return a if not b >= a else b


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
    ref = fr.warp_composite_fwd_ref(tex, rx, ry, q, scal, with_disp=with_disp)
    out = fr.warp_composite_fwd(tex, rx, ry, q, scal, with_disp=with_disp)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    log(f"fused_fwd vs plain [{label}, with_disp={with_disp}]: max abs err "
        f"{max(errs):.3e} (fields {['%.2e' % e for e in errs]})")
    if not all(e <= TOL for e in errs):  # also catches NaN
        raise RuntimeError(f"fused_fwd [{label}] disagrees with its plain version: "
                           f"{errs} > {TOL}")
    return max(errs)


def check_training_kernels(fr, case, tex, rx, ry, q, scal, gen, adj_bands):
    """Phases 2b and 2d on one stack: the forward's training form, the
    composite backward, the splat and the adjoint against their plain
    versions.  Returns each kernel's largest error (relative to max|plain|
    per field)."""
    v, n_l = scal.shape[:2]
    res = tex.shape[-1]
    errs = {"fused_fwd": 0.0, "composite_bwd": 0.0, "splat": 0.0, "adjoint": 0.0}
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

        # 2d: the adjoint takes no n_live; the composite backward zeroed the dead slots
        a_tex = fr.warp_adjoint(d_ref, rx, ry, scal, adj_bands, res, res)
        a_again = fr.warp_adjoint(d_ref, rx, ry, scal, adj_bands, res, res)
        a_ref = fr.warp_adjoint_ref(d_ref, rx, ry, scal, res, res)
        torch.cuda.synchronize()
        e, e_splat = rel_err(a_tex, a_ref), rel_err(a_tex, d_tex)
        log(f"adjoint vs plain [{case}]: rel err {e:.3e}; vs the splat kernel {e_splat:.3e}; two "
            f"launches bitwise equal: {torch.equal(a_tex, a_again)}")
        if not torch.equal(a_tex, a_again):
            raise RuntimeError(f"adjoint [{case}]: two launches on one input differ")
        errs["adjoint"] = max(errs["adjoint"], e, e_splat)
    for name, e in errs.items():
        if not e <= TOL:  # also catches NaN
            raise RuntimeError(f"{name} [{case}] disagrees with its plain version: {e} > {TOL}")
    return errs


EDGE_CASES = (  # label, image (H, W), texture (Th, Tw), tweak
    ("ragged tiles", (243, 250), (131, 200), None),
    ("texture width not a multiple of 4", (244, 252), (200, 131), None),
    ("slab of a parent stack, unaligned address", (243, 250), (131, 200), "slab"),
    ("texture far larger than the image", (64, 96), (300, 520), None),
    ("strong minification", (256, 256), (40, 64), None),
    ("every tap outside the texture", (243, 250), (131, 200), "outside"),
    ("a NaN ray", (244, 252), (131, 200), "nan"),
)


def unaligned_copy(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty((x.numel() + 1,), dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def check_splat_paths(fr, d_samp, rx, ry, scal, th, tw, n_live=None):
    """The splat kernel in both paths (texel boxes in shared memory, as the
    wrapper launches it; every tap into ``d_tex``) against its plain version;
    returns each one's error relative to max|plain|."""
    ref = fr.warp_splat_ref(d_samp, rx, ry, scal, th, tw, n_live=n_live)
    outs = {"box": fr.warp_splat(d_samp, rx, ry, scal, th, tw, n_live=n_live),
            "direct": fr._launch_splat(d_samp, rx, ry, scal, n_live, th, tw, boxed=False)}
    torch.cuda.synchronize()
    return {path: rel_err(out, ref) for path, out in outs.items()}


def check_composite_bwd(fr, warped, q, scal, gen):
    """The composite backward against its plain version on ``warped`` with
    random cotangents (the optional ones off and on) and a random ``n_live``
    whose dead slots hold NaN, and on the whole stack without masks; returns
    the largest error relative to max|plain| per field (rgb, alpha)."""
    v, n_l, _, h, w = warped.shape
    gc = torch.randn((v, 3, h, w), device=warped.device, generator=gen)
    opt = [torch.randn((v, h, w), device=warped.device, generator=gen) for _ in range(3)]
    n_live = torch.randint(0, n_l + 1, (v, h, w), device=warped.device, generator=gen,
                           dtype=torch.int32)
    planes = torch.arange(n_l, device=warped.device).reshape(1, n_l, 1, 1, 1)
    poisoned = torch.where(planes < n_live[:, None, None], warped, float("nan"))
    if warped.data_ptr() % 16:  # keep the caller's unaligned address
        poisoned = unaligned_copy(poisoned)
    err = 0.0
    for x, kw in ((poisoned, dict(n_live=n_live, grad_tau=fr.GRAD_TAU)), (warped, {})):
        for cot in ((None, None, None), opt):
            out = fr.composite_bwd(x, q, scal, gc, *cot, **kw)
            ref = fr.composite_bwd_ref(x, q, scal, gc, *cot, **kw)
            torch.cuda.synchronize()
            err = worse(err, worse(rel_err(out[:, :, :3], ref[:, :, :3]),
                                   rel_err(out[:, :, 3], ref[:, :, 3])))
            if "n_live" in kw and float(torch.where(planes >= n_live[:, None, None], out,
                                                    0.0).abs().max()) != 0.0:
                raise RuntimeError("composite_bwd: a dead slot's cotangent is not zero")
    return err


def check_edges(fr, cam, poses, cfg, dev):
    """Phase 2e: the forward, the adjoint, the splat (both paths) and the
    composite backward against their plain versions at the edges of their
    designs.  Returns the largest error of each (absolute for the forward,
    relative to max|plain| for the others)."""
    n_v, n_l = 3, 9  # 9 planes: not a multiple of the staged group
    geom = dataclasses.replace(
        cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_l)).plane_geometry(device=dev)
    c2w, _, _ = poses.sample_sphere_poses(
        None, n_v, cfg.camera, given_yaws=torch.tensor([[0.5], [-0.3], [0.0]]),
        given_pitches=torch.tensor([[0.2], [-0.25], [0.1]]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    planes = torch.arange(n_l, device=dev).reshape(1, n_l, 1, 1, 1)
    err_fwd, err_adj, n_fwd = 0.0, 0.0, 0
    err_splat, err_bwd = {"box": 0.0, "direct": 0.0}, 0.0
    for label, (h, w), (th, tw), tweak in EDGE_CASES:
        ray_dir, eye, z_dir = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, h, w), c2w)
        scal = fr.plane_affine(geom.dhw, eye, th, tw).contiguous()
        rx, ry, q = (x.contiguous() for x in fr.ray_fields(ray_dir, z_dir))
        if tweak == "outside":
            scal[..., 1] += 1e4
        if tweak == "nan":
            rx[0, 5, 7] = ry[0, 5, 7] = float("nan")
            rx[1, 0, 0] = ry[2, h - 1, w - 1] = float("nan")
        # the forward is held on pixels whose ray is a number: on a NaN ray the kernels
        # read zeros while the plain version's lerp weights turn NaN
        real = torch.isfinite(rx) & torch.isfinite(ry)
        uniform = torch.rand((n_v, n_l + 4, 4, th, tw), device=dev, generator=gen)
        sparse = uniform.clone()
        sparse[:, :, 3] *= 0.05
        opaque_mid = sparse.clone()
        opaque_mid[:, 5:8, 3] = 1.0
        case_err = 0.0
        for stack in (uniform, sparse, opaque_mid):
            # planes 2..10 of a 13-plane parent on an unaligned address, or a packed stack
            tex = unaligned_copy(stack)[:, 2:2 + n_l] if tweak == "slab" else \
                stack[:, 2:2 + n_l].contiguous()
            for early_out in (False, True, "grad"):
                for with_disp in (False, True):
                    for with_warped in (False, True):
                        kw = dict(early_out=early_out, with_disp=with_disp,
                                  with_warped=with_warped)
                        ref = fr.warp_composite_fwd_ref(tex, rx, ry, q, scal, **kw)
                        n_base = 4 if with_disp else 3
                        out = fr.warp_composite_fwd(tex, rx, ry, q, scal, **kw)
                        torch.cuda.synchronize()
                        n_fwd += 1
                        for a, b in zip(out[:n_base], ref[:n_base]):
                            diff = torch.where(real[:, None], a - b, 0.0)
                            case_err = worse(case_err, float(diff.abs().max()))
                        both = real[:, None, None]
                        if early_out == "grad":
                            moved = (out[-1] != ref[-1]) & real
                            if (int(torch.where(real, out[-1] - ref[-1], 0).abs().max()) > 1
                                    or float(moved.float().mean()) > 1e-4):
                                raise RuntimeError(f"fused_fwd [{label}]: n_live disagrees "
                                                   f"on {int(moved.sum())} pixels")
                            reached = torch.minimum(out[-1], ref[-1])[:, None, None]
                            both = both & (planes < reached)
                        if with_warped and early_out is not True:
                            diff = torch.where(both, out[n_base] - ref[n_base], 0.0)
                            case_err = worse(case_err, float(diff.abs().max()))
        if tweak == "outside" and (float(out[0].abs().max()) != 0.0
                                   or float(out[n_base - 1].min()) != 1.0):
            raise RuntimeError("fused_fwd: a render with every tap outside is not empty")
        err_fwd = worse(err_fwd, case_err)

        # the adjoint on random cotangents with exact zeros among them
        d_samp = torch.randn((n_v, n_l, 4, h, w), device=dev, generator=gen)
        d_samp = d_samp * (torch.rand((n_v, n_l, 1, h, w), device=dev, generator=gen) > 0.3)
        if tweak == "slab":
            d_samp = unaligned_copy(d_samp)
        bands = fr.AdjointBands(8, 8) if tweak == "nan" else fr.plan_adjoint(scal, rx, ry, th, tw)
        a_tex = fr.warp_adjoint(d_samp, rx, ry, scal, bands, th, tw)
        a_again = fr.warp_adjoint(d_samp, rx, ry, scal, bands, th, tw)
        a_ref = fr.warp_adjoint_ref(d_samp, rx, ry, scal, th, tw)
        torch.cuda.synchronize()
        e = rel_err(a_tex, a_ref)
        if tweak != "nan":  # the splat's coordinates are not NaN-safe by contract
            e = worse(e, rel_err(a_tex, fr.warp_splat(d_samp, rx, ry, scal, th, tw)))
        if not torch.equal(a_tex, a_again):
            raise RuntimeError(f"adjoint [{label}]: two launches on one input differ")
        err_adj = worse(err_adj, e)

        # the splat in both paths, with n_live masking over NaN-poisoned dead slots
        n_live = torch.randint(0, n_l + 1, (n_v, h, w), device=dev, generator=gen,
                               dtype=torch.int32)
        d_dead = torch.where(planes < n_live[:, None, None], d_samp, float("nan"))
        if tweak == "slab":
            d_dead = unaligned_copy(d_dead)
        e_s = check_splat_paths(fr, d_samp, rx, ry, scal, th, tw)
        e_m = check_splat_paths(fr, d_dead, rx, ry, scal, th, tw, n_live)
        for key in e_s:
            err_splat[key] = worse(err_splat[key], worse(e_s[key], e_m[key]))
        # the composite backward on the forward's residual of the last stack
        warped = fr.warp_composite_fwd(tex, rx, ry, q, scal, early_out=False, with_disp=False,
                                       with_warped=True)[-1].nan_to_num(0.0)
        if tweak == "slab":
            warped = unaligned_copy(warped)
        e_b = check_composite_bwd(fr, warped, q, scal, gen)
        err_bwd = worse(err_bwd, e_b)
        log(f"edge [{label}: image {h} x {w}, texture {th} x {tw}, {n_l} planes]: fused_fwd max "
            f"abs err {case_err:.3e}, adjoint rel err {e:.3e} (max|plain| "
            f"{float(a_ref.abs().max()):.3e}), bitwise repeatable; splat by path "
            + ", ".join(f"{k} {worse(e_s[k], e_m[k]):.3e}" for k in e_s)
            + f"; composite_bwd {e_b:.3e}")
    # the composite backward at plane counts off its chunk of 4 and past one
    # checkpoint a chunk (600 planes: one every 20), on an odd pixel count
    for n_deep, (h, w) in ((9, (15, 13)), (600, (15, 13))):
        warped = torch.rand((2, n_deep, 4, h, w), device=dev, generator=gen)
        warped[:, :, 3] *= 0.1
        warped[:, n_deep // 2, 3] = 1.0
        scal = torch.zeros((2, n_deep, 6), device=dev)
        scal[..., 4] = torch.rand((2, n_deep), device=dev, generator=gen) + 0.5
        q = torch.rand((2, h, w), device=dev, generator=gen) + 0.9
        e_b = check_composite_bwd(fr, warped, q, scal, gen)
        log(f"edge [composite_bwd, {n_deep} planes, image {h} x {w}]: rel err {e_b:.3e}")
        err_bwd = worse(err_bwd, e_b)
    errs = {"fused_fwd": err_fwd, "adjoint": err_adj, "composite_bwd": err_bwd,
            "splat": worse(err_splat["box"], err_splat["direct"])}
    if not all(e <= TOL for e in errs.values()):  # also catches NaN
        raise RuntimeError(f"edge cases: {errs} > {TOL}")
    log(f"edge cases: {n_fwd} forward launches in all forms; splat by path {err_splat}")
    return errs


def reset_counts(fr):
    """Zero the launch counts by kernel."""
    for key in fr.LAUNCHES:
        fr.LAUNCHES[key] = 0


def snapshot(tensors):
    return [t.detach().clone() for t in tensors]


def changed(before, tensors) -> bool:
    return any(not torch.equal(a, b) for a, b in zip(before, tensors))


class StubEmbedder:
    """Deterministic stand-in for the ArcFace adapter (the repository holds no
    face model weights): image statistics as the identity embedding."""

    def embed(self, img):
        import numpy as np

        x = np.asarray(img, np.float32)
        return np.array([x.mean(), x.std(), x[..., 0].mean(), x[..., 1].mean()])


class StubDetector:
    """Stand-in for the MTCNN adapter: five fixed landmarks of a frontal face."""

    def detect(self, img):
        import numpy as np

        h, w = img.shape[:2]
        return np.array([[w * 0.3, h * 0.4], [w * 0.7, h * 0.4], [w * 0.5, h * 0.55],
                         [w * 0.35, h * 0.7], [w * 0.65, h * 0.7]], np.float32)


class StubEstimator:
    """Stand-in for the Deep3DFace adapter: fixed angles, a depth map seeded by
    the image's pixel sum, a full face mask."""

    def estimate(self, img, landmarks):
        import numpy as np

        h, w = img.shape[:2]
        rng = np.random.default_rng(int(np.asarray(img).sum()) % 1000)
        return {"angles": np.array([0.01, -0.02, 0.0], np.float32),
                "depth": rng.uniform(0.9, 1.2, (h, w)).astype(np.float32),
                "mask": np.ones((h, w), bool)}


def write_ffhq_dataset(root, n_images, res, seed):
    """An FFHQ-style dataset in ``root``: ``n_images`` seeded noise PNGs of
    ``res``^2 in a zip, a Deep3DFace ``.mat`` file per image and a
    ``fail_list.txt`` that leaves out the fourth.  Returns ``(zip, pose dir)``."""
    import io
    import os
    import zipfile

    import numpy as np
    import scipy.io as sio
    from PIL import Image

    rng = np.random.default_rng(seed)
    zpath, pose_dir = os.path.join(root, f"ffhq{res}.zip"), os.path.join(root, "coeffs")
    os.makedirs(pose_dir)
    with zipfile.ZipFile(zpath, "w") as zf:
        for i in range(n_images):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (res, res, 3), dtype=np.uint8)).save(
                buf, format="PNG")
            zf.writestr(f"{i:05d}.png", buf.getvalue())
            sio.savemat(os.path.join(pose_dir, f"{i:05d}.mat"), {
                "angle": (rng.standard_normal((1, 3)) * 0.2).astype(np.float32),
                "trans": (rng.standard_normal((1, 3)) * 0.1).astype(np.float32)})
    with open(os.path.join(pose_dir, "fail_list.txt"), "w") as f:
        f.write("00003.png\n")
    return zpath, pose_dir


def same_tree(a, b) -> bool:
    """Nested dicts/lists of tensors and numbers bitwise equal (dtype too)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(
            a, b.to(a.device))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def training_loop_phase(fr, cfg, card, dev):
    """Phase 8: ``train_gmpi_torch.main`` trains the full FFHQ256 preset from a
    dataset of 256^2 PNGs in a zip with Deep3DFace poses (6 steps, snapshots
    and checkpoints every 3), resumes to 8 steps, then warm-starts a third run
    from ``.npz`` exports of the second one's G and D.  Returns the phase's
    record; raises on a failed check."""
    import os
    import shutil
    import tempfile

    import numpy as np

    import train_gmpi_torch
    from gmpi_tpu_torch.data import datasets as ds_mod
    from gmpi_tpu_torch.data import fastpng
    from gmpi_tpu_torch.models.converter import module_trees
    from gmpi_tpu_torch.train import checkpoint as ckpt_mod
    from gmpi_tpu_torch.train import init_train_state, make_train_step
    from gmpi_tpu_torch.train.loop import LoopStats

    t0 = time.perf_counter()
    native = fastpng.available()
    log(f"PNG decoder: native fastpng {'built' if native else 'UNAVAILABLE, PIL decodes'} "
        f"({fastpng.library_path()}) in {time.perf_counter() - t0:.1f} s"
        + ("" if native else f": {fastpng.build_log()}"))
    split = cfg.hparams.batch_split
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        t0 = time.perf_counter()
        zpath, pose_dir = write_ffhq_dataset(tmp, 20, cfg.resolution, seed=8)
        log(f"dataset: 20 PNGs of {cfg.resolution}^2 in a zip ({os.path.getsize(zpath)} B), "
            f"Deep3DFace .mat poses, one fail-listed, written in {time.perf_counter() - t0:.1f} s")
        out = os.path.join(tmp, "run")
        ckpt_dir = os.path.join(out, "checkpoints")
        args = ["--dataset", "FFHQ256", "--data_root", zpath, "--pose_root", pose_dir,
                "--output_dir", out, "--seed", "5", "--model_save_interval", "3",
                "--sample_interval", "3"]
        decodes0 = dict(ds_mod.DECODES)
        reset_counts(fr)
        runs = []
        # 8a: 6 steps from scratch (19 images, 2 batches an epoch: 3 epochs)
        stats1 = LoopStats()
        t0 = time.perf_counter()
        state = train_gmpi_torch.main(args + ["--total_iters", "6"], stats=stats1)
        runs.append(("first", stats1, time.perf_counter() - t0))
        dirs = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
        if state.step != 6 or dirs != ["step_00000004", "step_00000006"]:
            raise RuntimeError(f"first run ended at step {state.step} with checkpoints {dirs}")
        # what was saved, loaded back into a fresh state: bitwise the live state
        fresh = init_train_state(cfg, torch.Generator().manual_seed(77), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = ckpt_mod.load_checkpoint(ckpt_dir, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        restored = same_tree(ckpt_mod.state_payload(loaded), ckpt_mod.state_payload(state))
        log(f"checkpoint step 6 loaded into a fresh state in {load_s:.2f} s: G, D, both "
            f"optimizers, both EMAs and step bitwise equal to the saved state: {restored}")
        if not restored:
            raise RuntimeError("the loaded checkpoint differs from the state that was saved")
        del fresh, loaded
        # the step outside the loop, timed as phase 4 times it (host clock around a
        # synchronize, one batch of the dataset already on the card), on run 1's state,
        # between the two loop runs: the loop's own cost is the difference
        ds = ds_mod.get_dataset("FFHQ", dataset_path=zpath, raw_img_size=cfg.resolution,
                                img_size=cfg.hparams.img_size, pose_data_path=pose_dir,
                                sphere_center=cfg.camera.sphere_center_z,
                                flat_pose_dim=cfg.train.d_cond_pose_dim)
        items = [ds[i] for i in range(cfg.hparams.batch_size)]
        imgs = torch.from_numpy(np.stack([it[0] for it in items])).to(dev)
        pose = torch.from_numpy(np.stack([it[1] for it in items])).to(dev)
        step_fn, rng = make_train_step(cfg, device=dev), torch.Generator().manual_seed(9)
        direct_ms = [host_ms(lambda: step_fn(state, imgs, pose, rng))[1]
                     for _ in range(N_DIRECT_STEPS)]
        log(f"the same step outside the loop on run 1's state (phase 4's timing): ms "
            f"{['%.1f' % x for x in direct_ms]} ({card})")
        del state, step_fn, ds, items, imgs, pose
        torch.cuda.empty_cache()

        # 8b: resume to 8 steps
        stats2 = LoopStats()
        t0 = time.perf_counter()
        state = train_gmpi_torch.main(args + ["--total_iters", "8"], stats=stats2)
        runs.append(("resumed", stats2, time.perf_counter() - t0))
        dirs = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
        with open(os.path.join(ckpt_dir, "latest")) as f:
            latest = f.read().strip()
        log(f"resumed run: started at step {stats2.start_step}, ended at {state.step}; "
            f"checkpoints {dirs}, latest {latest}")
        if (stats2.start_step != 6 or state.step != 8 or latest != "step_00000008"
                or dirs != ["step_00000006", "step_00000007", "step_00000008"]):
            raise RuntimeError("the resumed run did not continue from step 6 to 8 with 3 "
                               "checkpoints kept")

        # 8c: warm start of a third run from .npz exports of G and D
        g_npz, d_npz = os.path.join(tmp, "g.npz"), os.path.join(tmp, "d.npz")
        ckpt_mod.export_torch_style(g_npz, *module_trees(state.G))
        ckpt_mod.export_torch_style(d_npz, *module_trees(state.D))
        want_g, want_d = ckpt_mod.load_torch_style(g_npz), ckpt_mod.load_torch_style(d_npz)
        del state
        shutil.rmtree(out)
        torch.cuda.empty_cache()
        stats3 = LoopStats()
        t0 = time.perf_counter()
        warm = train_gmpi_torch.main(args + ["--total_iters", "0", "--warm_start", g_npz,
                                             "--warm_start_d", d_npz], stats=stats3)
        runs.append(("warm start", stats3, time.perf_counter() - t0))
        warm_ok = (same_tree({**want_g[0], **want_g[1]}, warm.G.state_dict())
                   and same_tree(want_d[0], warm.D.state_dict())
                   and same_tree(want_g[0], warm.ema) and same_tree(want_g[0], warm.ema2)
                   and warm.step == 0)
        log(f"warm start from {os.path.getsize(g_npz)} + {os.path.getsize(d_npz)} B of .npz: "
            f"G, D and both EMAs equal the exported weights before the first step: {warm_ok}")
        if not warm_ok:
            raise RuntimeError("the warm start did not copy G and D exactly")
        del warm
        torch.cuda.empty_cache()
        launches = dict(fr.LAUNCHES)
        decodes = {k: ds_mod.DECODES[k] - decodes0[k] for k in decodes0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n_steps = sum(len(st.step_ms) for _, st, _ in runs)
    n_snaps = sum(len(st.snapshot_steps) for _, st, _ in runs)
    renders = 2 * 3 * 4  # a snapshot: EMA and raw weights x 3 view rows x 4 images
    all_steps = n_steps + N_DIRECT_STEPS
    expected = {**dict.fromkeys(fr.LAUNCHES, 0), "fused_fwd": 3 * all_steps + renders * n_snaps,
                "composite_bwd": split * all_steps, "splat": split * all_steps}
    log(f"training loop: {n_steps} loop steps, {N_DIRECT_STEPS} steps outside it and {n_snaps} "
        f"snapshots, launches {launches} (per step 3 forward, {split} composite backward, "
        f"{split} splat; {renders} forward a snapshot)")
    if n_steps != 8 or launches != expected:
        raise RuntimeError(f"the training loop launched {launches} in {n_steps} steps, "
                           f"expected {expected}")
    for _, st, _ in runs:
        for i, m in enumerate(st.metrics):
            if not all(v == v and abs(v) != float("inf") for v in m.values()) or not m["r1"] > 0:
                raise RuntimeError(f"loop step {st.start_step + i}: bad metrics {m}")
    if sum(decodes.values()) == 0 or (native and decodes["pil"]):
        raise RuntimeError(f"PNG decodes {decodes} with the native decoder "
                           f"{'available' if native else 'unavailable'}")
    wait = [x for _, st, _ in runs for x in st.data_wait_ms]
    steps = [x for _, st, _ in runs for x in st.step_ms]
    warm = [x for _, st, _ in runs for x in st.step_ms[1:]]  # each run's first step warms up
    saves = [(s, b) for _, st, _ in runs for s, b in zip(st.save_s, st.save_bytes)]
    for label, st, total in runs:
        log(f"loop run [{label}]: steps {st.start_step}..{st.end_step}, "
            + (f"{len(st.step_ms) / st.seconds:.3f} steps/s over the loop ({st.seconds:.1f} s "
               f"with snapshots at {st.snapshot_steps} and checkpoints), " if st.step_ms else "")
            + f"step ms {['%.1f' % x for x in st.step_ms]}, data wait ms "
            f"{['%.2f' % x for x in st.data_wait_ms]}; call {total:.1f} s with set-up ({card})")
        for i, m in enumerate(st.metrics):
            log(f"  step {st.start_step + i}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
    log(f"training loop: median step {statistics.median(steps):.1f} ms ({statistics.median(warm):.1f} "
        f"without each run's first; outside the loop {statistics.median(direct_ms[1:]):.1f} "
        f"after its first), median data wait "
        f"{statistics.median(wait):.3f} ms a step (max {max(wait):.3f}); checkpoint saves "
        f"{['%.2f s %d B' % sb for sb in saves]}; load by the resumed run "
        f"{stats2.load_s:.2f} s {stats2.load_bytes} B, into a fresh state {load_s:.2f} s; "
        f"PNG decodes {decodes} ({card})")
    return {"steps": n_steps, "snapshots": n_snaps, "launches": launches,
            "steps_per_s": n_steps / sum(st.seconds for _, st, _ in runs),
            "step_ms_median": statistics.median(steps),
            "step_ms_median_after_first": statistics.median(warm),
            "direct_step_ms": direct_ms,
            "data_wait_ms_median": statistics.median(wait), "data_wait_ms_max": max(wait),
            "save_s": [sb[0] for sb in saves], "save_bytes": [sb[1] for sb in saves],
            "load_s": stats2.load_s, "load_bytes": stats2.load_bytes, "decodes": decodes}


def _timed(obj, name, record, key=None):
    """Replace ``obj.name`` by a wrapper that appends each call's host ms
    (around a synchronize) to ``record``, or to ``record[key(*args)]`` when
    ``key`` is given; returns the original."""
    orig = getattr(obj, name)

    def timed(*args, **kw):
        out, ms = host_ms(lambda: orig(*args, **kw))
        (record if key is None else record[key(*args)]).append(ms)
        return out

    setattr(obj, name, timed)
    return orig


def _pngs_apart(dir_a, dir_b):
    """``(max level difference, share of differing pixels)`` of two PNG dumps
    with the same file names."""
    import os

    import numpy as np
    from PIL import Image

    names = sorted(os.listdir(dir_a))
    if not names or names != sorted(os.listdir(dir_b)):
        raise RuntimeError(f"{dir_a} and {dir_b} hold different files")
    worst, n_diff, n_all = 0, 0, 0
    for name in names:
        a = np.asarray(Image.open(os.path.join(dir_a, name)), np.int32)
        b = np.asarray(Image.open(os.path.join(dir_b, name)), np.int32)
        worst = max(worst, int(np.abs(a - b).max()))
        n_diff += int((a != b).sum())
        n_all += a.size
    return worst, n_diff / n_all


# phases 9 and 10: depth of the eval and viz runs (widths stay FFHQ256's)
EVAL_FAKES = 64  # the JAX CLI's default is 2048
EVAL_PAIRS = 16  # consistency pairs and geometry images; the default is 1024
EVAL_PLANES = 96
INCEPTION_IMAGES = 2048  # the train CLI's --fid_n_imgs default
TRAIN_FID_IMAGES = 16
VIDEO_FRAMES = 8
MESH_PLANES = 128

EVAL_KEYS = {"fid_kid": ("frechet_inception_distance", "kernel_inception_distance_mean",
                         "kernel_inception_distance_std"),
             "consistency": ("consistency_mean", "consistency_std"),
             "geometry": ("n_evaluated", "n_skipped", "angle_error_mse", "depth_error_mse")}


def eval_phase(fr, tw, pg, cfg, card, dev, tmp):
    """Phase 9: ``eval_gmpi_torch.main --task all`` twice on a checkpoint of a
    seeded state (banded renders), ``prepare_fake`` once more with the fused
    renderer, the patch gather and the banded render of each banded task
    against their plain versions on that task's inputs, the Inception
    features on the card against a CPU copy, the timings of the eval layers,
    and ``train_gmpi_torch.main`` with the in-training FID.  Returns the
    phase's record and the checkpoint's directory; everything is written
    under ``tmp``, which the caller removes.  Raises on a failed check."""
    import copy
    import json
    import os

    import numpy as np

    import eval_gmpi_torch
    import train_gmpi_torch
    from gmpi_tpu_torch.eval import harness, inception, metrics
    from gmpi_tpu_torch.train import checkpoint as ckpt_mod
    from gmpi_tpu_torch.train import init_train_state
    from gmpi_tpu_torch.train import loop as loop_mod

    n_fakes, n_pairs, n_planes = EVAL_FAKES, EVAL_PAIRS, EVAL_PLANES
    n_inception, fid_n_imgs = INCEPTION_IMAGES, TRAIN_FID_IMAGES
    zpath, pose_dir = write_ffhq_dataset(tmp, 20, cfg.resolution, seed=9)
    ckpt_dir = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt_dir)
    state = init_train_state(cfg, torch.Generator().manual_seed(3), device=dev)
    ckpt_mod.save_checkpoint(ckpt_dir, state)
    del state
    torch.cuda.empty_cache()
    weights = os.path.join(tmp, "inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in inception.random_params(seed=4).items()},
               weights)
    common = ["--ckpt", ckpt_dir, "--n_planes", str(n_planes), "--device", str(dev)]
    chain = common + ["--task", "all", "--data_root", zpath, "--pose_root", pose_dir,
                      "--n_imgs", str(n_fakes), "--n_consistency", str(n_pairs),
                      "--n_geometry", str(n_pairs), "--inception_weights", weights,
                      "--embedder", "chip_smoke:StubEmbedder",
                      "--landmark_detector", "chip_smoke:StubDetector",
                      "--pose_estimator", "chip_smoke:StubEstimator"]

    # each prepare_fake_images call: launches reset just before and read just after; the
    # last gather_patches and render call of each banded task kept to hold against the plain
    # versions below
    tasks, row_steps = [], {"n": 0}
    kept, current = {}, {"label": None}
    prepare, row_step, gather = harness.prepare_fake_images, tw._warp_row_tiles, tw.gather_patches
    cls = harness.FakeImageGenerator
    gen_ms, render_ms = {False: [], True: []}, {False: [], True: []}

    def label_of(gen, task):
        return f"{task} {gen.img_size}^2 {'fused' if gen.use_fused else 'banded'}"

    def counted_prepare(gen, out_dir, n_imgs, task="fid_kid"):
        reset_counts(fr)
        row_steps["n"] = 0
        current["label"] = label_of(gen, task)
        _, ms = host_ms(lambda: prepare(gen, out_dir, n_imgs, task=task))
        tasks.append({"task": task, "fused": gen.use_fused, "size": gen.img_size,
                      "n_imgs": n_imgs, "launches": dict(fr.LAUNCHES),
                      "row_steps": row_steps["n"], "seconds": ms / 1e3})

    def counted_row_step(*args, **kw):
        row_steps["n"] += 1
        return row_step(*args, **kw)

    def recorded_gather(texf, offs, band_x, band_yc, **kw):
        kept.setdefault(current["label"], {})["gather"] = (texf, offs, band_x, band_yc)
        return gather(texf, offs, band_x, band_yc, **kw)

    def recorded_render(gen, mpi, yaws, pitches):
        if not gen.use_fused:
            kept.setdefault(current["label"], {})["render"] = (gen, mpi, yaws, pitches)
        return render(gen, mpi, yaws, pitches)

    by_route = lambda gen, *_: gen.use_fused  # noqa: E731
    originals = [(harness, "prepare_fake_images", prepare), (tw, "_warp_row_tiles", row_step),
                 (tw, "gather_patches", gather),
                 (cls, "sample_mpi", _timed(cls, "sample_mpi", gen_ms, key=by_route)),
                 (cls, "render", _timed(cls, "render", render_ms, key=by_route))]
    harness.prepare_fake_images, tw._warp_row_tiles = counted_prepare, counted_row_step
    tw.gather_patches, render, cls.render = recorded_gather, cls.render, recorded_render
    try:
        runs = []
        for k in range(2):
            t0 = time.perf_counter()
            res = eval_gmpi_torch.main(chain + ["--out", os.path.join(tmp, f"eval{k}")], cfg=cfg)
            runs.append((res, time.perf_counter() - t0))
        fused_dir = os.path.join(tmp, "fused")
        eval_gmpi_torch.main(common + ["--task", "prepare_fake", "--fused_renderer", "--out",
                                       fused_dir, "--n_imgs", str(n_fakes)], cfg=cfg)
    finally:
        for obj, name, orig in originals:
            setattr(obj, name, orig)

    # results: every key present and finite, n_evaluated == n_pairs, reproducible
    (res, chain_s), (res2, chain2_s) = runs
    for key, fields in EVAL_KEYS.items():
        vals = res.get(key, {})
        if set(vals) != set(fields) or not all(np.isfinite(vals[f]) for f in fields):
            raise RuntimeError(f"eval --task all: {key} is {vals}")
    if res["geometry"]["n_evaluated"] != n_pairs:
        raise RuntimeError(f"geometry evaluated {res['geometry']['n_evaluated']} of {n_pairs}")
    repeat = {f"{key}.{f}": (res[key][f], res2[key][f]) for key, fields in EVAL_KEYS.items()
              for f in fields}
    log(f"eval --task all ({n_fakes} fakes, {n_pairs} pairs, {n_pairs} geometry images, "
        f"{n_planes} planes, 19 real images): {json.dumps(res)} in {chain_s:.1f} s; the second "
        f"run in {chain2_s:.1f} s equal in every number: "
        f"{all(a == b for a, b in repeat.values())} ({card})")
    if not all(a == b for a, b in repeat.values()):
        raise RuntimeError(f"the second eval run differs: {repeat}")

    # launches by task: fused, one K1 a render call; banded, one K7 a tile-row step
    by_task = {}
    for t in tasks:
        renders = t["n_imgs"]  # one render call an image (its views in one call)
        want = dict.fromkeys(fr.LAUNCHES, 0)
        if t["fused"]:
            want["fused_fwd"] = renders
        else:
            want["patch_gather"] = t["row_steps"]
        label = f"{t['task']} {t['size']}^2 {'fused' if t['fused'] else 'banded'}"  # label_of
        log(f"prepare_fake_images [{label}]: {t['n_imgs']} images in {t['seconds']:.2f} s, "
            f"{t['n_imgs'] / t['seconds']:.2f} images/s; {t['row_steps']} tile-row steps, "
            f"launches {t['launches']} ({card})")
        if t["launches"] != want or (not t["fused"] and t["row_steps"] == 0):
            raise RuntimeError(f"prepare_fake_images [{label}] launched {t['launches']}, "
                               f"expected {want}")
        by_task.setdefault(label, []).append(t)
    launches = {k: sum(t["launches"][k] for t in tasks) for k in fr.LAUNCHES}
    fps = {label: [t["n_imgs"] / t["seconds"] for t in ts] for label, ts in by_task.items()}

    # each banded task at its own inputs (its last call): the patch gather against its plain
    # version, exactly, and the banded render against the per-pixel gather renderer
    banded = {label for label, ts in by_task.items() if not ts[0]["fused"]}
    if set(kept) != banded or not all(set(k) == {"gather", "render"} for k in kept.values()):
        raise RuntimeError(f"kept the inputs of {({b: sorted(k) for b, k in kept.items()})}, "
                           f"expected a gather and a render of each of {sorted(banded)}")
    banded_errs = {}
    for label, k in sorted(kept.items()):
        texf, offs, band_x, band_yc = k["gather"]
        same = torch.equal(pg.gather_patches(texf, offs, band_x, band_yc),
                           pg.gather_patches_ref(texf, offs, band_x, band_yc))
        gen, mpi, yaws, pitches = k["render"]
        plain = copy.copy(gen)
        plain.tiled_bands = None
        color, depth = gen.render(mpi, yaws, pitches)
        color_g, depth_g = plain.render(mpi, yaws, pitches)
        err = max(float((color - color_g).abs().max()), float((depth - depth_g).abs().max()))
        banded_errs[label] = err
        log(f"[{label}] patch_gather at the task's inputs ({tuple(texf.shape)} -> "
            f"{band_x}x{band_yc} patches at {tuple(offs.shape[:2])} offsets): equal to its "
            f"plain version: {same}; banded render of V={mpi.shape[0]} vs the gather renderer: "
            f"{err:.2e} (gate 5e-4)")
        if not same:
            raise RuntimeError(f"[{label}] patch_gather disagrees with its plain version")
        if not err <= 5e-4:  # also catches NaN
            raise RuntimeError(f"[{label}] the banded render disagrees with the gather renderer")
    del kept, texf, offs, gen, mpi, plain, color, depth, color_g, depth_g
    torch.cuda.empty_cache()

    # the fused dump against the banded one: at most 1 level apart, and their FID
    banded_rgb = os.path.join(tmp, "eval0", "fake", "rgb")
    worst, share = _pngs_apart(banded_rgb, os.path.join(fused_dir, "rgb"))
    model = inception.load_inception(weights)
    cpu_model = copy.deepcopy(model)
    feature_fn = inception.make_feature_fn(model, device=dev)
    fid_pair = harness.compute_fid_kid_dirs(banded_rgb, os.path.join(fused_dir, "rgb"),
                                            feature_fn)["frechet_inception_distance"]
    log(f"fused vs banded prepare_fake ({n_fakes} PNGs of {cfg.resolution}^2): at most {worst} "
        f"level apart, {share:.3e} of pixel channels differ; FID between the dumps {fid_pair:.6e}")
    if worst > 1:
        raise RuntimeError(f"fused and banded fakes differ by {worst} levels")

    # Inception on the card against a CPU copy of the same module (8 images)
    imgs8 = harness.load_images_chw(banded_rgb)[:8]
    ref = inception.make_feature_fn(cpu_model, device="cpu")(imgs8)
    feats8 = feature_fn(imgs8)
    err_inc = float(np.abs(feats8 - ref).max() / np.abs(ref).max())
    log(f"Inception pool3 on the card vs its CPU copy (8 images): rel err {err_inc:.3e} "
        f"(gate 1e-4 of max|CPU|)")
    if not err_inc <= 1e-4:
        raise RuntimeError(f"Inception features on the card disagree with the CPU: {err_inc}")

    # timings: Inception at batch 32 over random 256^2 images, frechet_distance at 2048
    imgs = np.random.default_rng(6).random((n_inception, 3, cfg.resolution, cfg.resolution),
                                           dtype=np.float32)
    feature_fn(imgs[:64])  # warm-up: cuDNN's algorithms for batch 32
    feats, inc_ms = host_ms(lambda: feature_fn(imgs))
    del imgs
    t0 = time.perf_counter()
    fid_feats = metrics.fid_from_features(feats[: n_inception // 2], feats[n_inception // 2:])
    fid_s = time.perf_counter() - t0
    log(f"Inception: {inc_ms / n_inception:.4f} ms an image at batch 32 over {n_inception} "
        f"random {cfg.resolution}^2 images ({inc_ms / 1e3:.2f} s with the host copies); "
        f"frechet_distance at {feats.shape[1]} features ({n_inception // 2} + "
        f"{n_inception // 2} images): {fid_s:.2f} s on the host, FID {fid_feats:.4f} ({card})")
    per_image = {route: {"sample_mpi_ms": statistics.median(gen_ms[fused]),
                         "render_ms": statistics.median(render_ms[fused])}
                 for route, fused in (("banded", False), ("fused", True))}
    log(f"per image (median over the calls, host clock after synchronize; one render call an "
        f"image, 1-2 views): {per_image} ({card})")
    del feature_fn, model, cpu_model
    torch.cuda.empty_cache()

    # 7. in-training FID through the train CLI
    fid_s_train = []
    orig_fid = _timed(loop_mod, "compute_training_fid", fid_s_train)
    out = os.path.join(tmp, "train")
    reset_counts(fr)
    try:
        train_gmpi_torch.main(["--dataset", "FFHQ256", "--data_root", zpath, "--pose_root",
                               pose_dir, "--output_dir", out, "--device", str(dev),
                               "--total_iters", "2", "--inception_weights", weights,
                               "--fid_interval", "1", "--fid_n_imgs", str(fid_n_imgs)], cfg=cfg)
    finally:
        loop_mod.compute_training_fid = orig_fid
    train_launches = dict(fr.LAUNCHES)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        fids = [json.loads(line)["fid"] for line in f if '"fid"' in line]
    split = cfg.hparams.batch_split
    want = {**dict.fromkeys(fr.LAUNCHES, 0), "composite_bwd": 2 * split, "splat": 2 * split,
            "fused_fwd": 2 * 3 + -(-fid_n_imgs // 8)}  # 3 a step; the FID's renders of 8
    log(f"in-training FID (train_gmpi_torch.main, 2 steps, --fid_interval 1 --fid_n_imgs "
        f"{fid_n_imgs}): logged {fids}, {fid_s_train[0] / 1e3:.2f} s for one; launches "
        f"{train_launches} ({card})")
    if len(fids) != 1 or not np.isfinite(fids[0]):
        raise RuntimeError(f"the in-training FID logged {fids}")
    if train_launches != want:
        raise RuntimeError(f"the train CLI with the FID launched {train_launches}, "
                           f"expected {want}")
    for k in launches:
        launches[k] += train_launches[k]

    return {"results": res, "chain_s": [chain_s, chain2_s], "images_per_s": fps,
            "launches": launches, "tasks": tasks, "banded_vs_gather": banded_errs,
            "fused_vs_banded_max_level": worst,
            "fused_vs_banded_share": share, "fused_vs_banded_fid": fid_pair,
            "inception_rel_err": err_inc, "inception_ms_per_image": inc_ms / n_inception,
            "frechet_distance_s": fid_s, "per_image": per_image,
            "training_fid": fids[0], "training_fid_s": fid_s_train[0] / 1e3}, ckpt_dir


def viz_phase(fr, cfg, ckpt_dir, out_dir, card, dev):
    """Phase 10: ``render_gmpi_torch.main`` with a video and a mesh on the
    checkpoint of phase 9.  No kernel runs (the video renders through the
    per-pixel gather).  Returns the phase's record."""
    import os

    import numpy as np

    import render_gmpi_torch
    from gmpi_tpu_torch.viz import mesh as mesh_mod
    from gmpi_tpu_torch.viz import render_video

    n_frames, n_planes, mesh_planes = VIDEO_FRAMES, EVAL_PLANES, MESH_PLANES
    frame_ms, mt_ms = [], []
    originals = [(render_video, "render_mpi_chunked",
                  _timed(render_video, "render_mpi_chunked", frame_ms)),
                 (mesh_mod, "marching_tetrahedra",
                  _timed(mesh_mod, "marching_tetrahedra", mt_ms))]
    reset_counts(fr)
    try:
        t0 = time.perf_counter()
        out = render_gmpi_torch.main(["--ckpt", ckpt_dir, "--out", out_dir, "--device",
                                      str(dev), "--n_frames", str(n_frames), "--nplanes",
                                      str(n_planes), "--mesh", "--mesh_planes",
                                      str(mesh_planes)], cfg=cfg)
        total_s = time.perf_counter() - t0
    finally:
        for obj, name, orig in originals:
            setattr(obj, name, orig)
    launches = dict(fr.LAUNCHES)
    missing = [n for n in ("rendered.png", "mpi_rgb.png", "mpi_alpha.png", "mpi_rgba.png")
               if not os.path.isfile(os.path.join(out_dir, n))]
    videos = {}
    for key in ("rgb", "depth"):
        path = out[key]
        videos[key] = ("mp4" if path.endswith(".mp4") and os.path.isfile(path) else
                       "frames" if os.path.isdir(path) and len(os.listdir(path)) == n_frames
                       else None)
    with open(out["mesh"], "rb") as f:
        data = f.read()
    head, body = data.split(b"end_header\n", 1)
    n_v = int(head.split(b"element vertex ")[1].split()[0])
    n_f = int(head.split(b"element face ")[1].split()[0])
    faces = np.frombuffer(body[n_v * 12:], dtype=[("n", "u1"), ("idx", "<i4", 3)])
    faces_ok = (len(faces) == n_f and bool((faces["n"] == 3).all())
                and bool((faces["idx"] >= 0).all()) and bool((faces["idx"] < n_v).all()))
    log(f"render_gmpi_torch.main ({n_frames} frames, {n_planes} planes, mesh of {mesh_planes} "
        f"planes) in {total_s:.1f} s: videos {videos}, sheets missing {missing}; "
        f"{statistics.median(frame_ms):.2f} ms a frame (median of {len(frame_ms)}); marching "
        f"tetrahedra {mt_ms[0] / 1e3:.2f} s, {n_v} vertices, {n_f} faces, indices in range: "
        f"{faces_ok}; launches {launches} ({card})")
    if missing or None in videos.values() or not (n_v > 0 and faces_ok):
        raise RuntimeError("render_gmpi_torch.main left an artifact missing or malformed")
    if any(launches.values()):
        raise RuntimeError(f"the video path launched {launches}; it renders by the gather")
    return {"launches": launches, "frame_ms_median": statistics.median(frame_ms),
            "marching_tetrahedra_s": mt_ms[0] / 1e3, "verts": n_v, "faces": n_f,
            "videos": videos, "seconds": total_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import bands as bands_mod
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core import renderer as renderer_mod
    from gmpi_tpu_torch.core.renderer import (homography_grid, plan_fused, render_mpi,
                                              render_mpi_chunked, render_mpi_fused)
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.models.generator import Generator
    from gmpi_tpu_torch.ops import _build
    from gmpi_tpu_torch.ops import fused_render as fr
    from gmpi_tpu_torch.ops import patch_gather as pg
    from gmpi_tpu_torch.ops import tiled_warp as tw
    from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step

    # -- 1. setup --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    log(f"card: {card}")
    import numpy
    import scipy

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"numpy {numpy.__version__} scipy {scipy.__version__}")
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
    # the adjoint's windows, planned on the host at the corners of the pose range
    t0 = time.perf_counter()
    corner_rays = bands_mod._corner_rays(c, cfg.fov_deg, res, res)
    adj_plans = plan_fused(geom_train.dhw, *corner_rays, res, res)
    adj_bands = adj_plans[1][0]
    log(f"adjoint plan at the 9 corner and centre poses, {n_train} planes: {adj_bands} in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    g = torch.Generator(device=dev).manual_seed(1)
    for case, tex in three_stacks(8, n_train, res, dev, seed=2):
        for kname, e in check_training_kernels(fr, case, tex, rx, ry, q, scal, g,
                                               adj_bands).items():
            max_err[kname] = max(max_err[kname], e)
        # the step's two no-grad renders: D-phase fakes, then worst-view candidates
        err = check_inference_form(fr, f"{case}, V=8, L={n_train}", tex, rx, ry, q, scal, False)
        err = worse(err, check_inference_form(fr, f"{case}, V={8 * n_cand}, L={n_train}, 8 stacks "
                                               f"in groups of {n_cand} views", tex, *rays_w, False))
        max_err["fused_fwd"] = worse(max_err["fused_fwd"], err)
        if case == "uniform":  # the grouped read against the kernel on a materialized repeat
            tex_w = tex.repeat_interleave(n_cand, dim=0)
            same = all(torch.equal(a, b) for a, b in zip(
                fr.warp_composite_fwd(tex, *rays_w, with_disp=False),
                fr.warp_composite_fwd(tex_w, *rays_w, with_disp=False)))
            if not same:
                raise RuntimeError("fused_fwd: grouped stacks render unlike their repeat")
            del tex_w
        del tex
    torch.cuda.empty_cache()

    # -- 2e. the forward and the adjoint at the edges of their designs ------------------
    for kname, e in check_edges(fr, cam, poses, cfg, dev).items():
        max_err[kname] = worse(max_err[kname], e)

    # -- 2c. patch gather vs plain version at the banded serving path's shapes ---------
    t0 = time.perf_counter()
    tiled_bands = bands_mod.bands_for_config(cfg, img_size=res, n_planes=n_planes)
    log(f"tile bands for {n_planes} planes at {res}^2 (band_y, band_x, adjoint rows, cols): "
        f"{tiled_bands} in {time.perf_counter() - t0:.1f} s (host)")
    band_y, band_x = tiled_bands[:2]
    wp, hpc, band_yc = res + 2 * band_x, (res + 2 * band_y) * 4, band_y * 4
    n_tex, n_tiles = 96, res // 8  # one slab of 24 planes in 4 views; a tile per 8 rows
    for dtype in (torch.float32, torch.bfloat16):
        texf = torch.randn((n_tex, wp, hpc), device=dev, generator=g).to(dtype)
        for aligned in (True, False):
            mult = 16 // texf.element_size() if aligned else 1
            offs = torch.stack([
                torch.randint(0, wp - band_x + 1, (n_tex, n_tiles), device=dev, generator=g),
                torch.randint(0, (hpc - band_yc) // mult + 1, (n_tex, n_tiles), device=dev,
                              generator=g) * mult], dim=-1).to(torch.int32)
            offs[0, 0] = 0  # both corners of the padded texture
            offs[-1, -1] = torch.tensor([wp - band_x, hpc - band_yc], device=dev)
            out = pg.gather_patches(texf, offs, band_x, band_yc)
            ref = pg.gather_patches_ref(texf, offs, band_x, band_yc)
            torch.cuda.synchronize()
            equal = torch.equal(out, ref)
            log(f"patch_gather vs plain [{str(dtype).split('.')[1]}, "
                f"{'16-byte-aligned' if aligned else 'arbitrary'} offsets, {n_tex} x {n_tiles} "
                f"patches of {band_x} x {band_yc}]: equal {equal}")
            if not equal:
                max_err["patch_gather"] = float("inf")
                raise RuntimeError("patch_gather disagrees with its plain version")
        del texf, out, ref
    torch.cuda.empty_cache()

    # -- 3. serving main path ----------------------------------------------------
    t0 = time.perf_counter()
    gen_module = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(0))
    gen = FakeImageGenerator(cfg, gen_module, use_fused=True, device=dev)
    log(f"generator: FFHQ256 full width ({sum(p.numel() for p in gen.G.parameters())} params, "
        f"{n_planes} planes), built in {time.perf_counter() - t0:.1f} s")
    seeds, n_views = (0, 1, 2, 3), 4
    gen_ms, render_ms, mpis = [], [], []
    lo, hi = cfg.planes.min_d * 0.9, cfg.planes.max_d * 1.4
    reset_counts(fr)
    for seed in seeds:
        mpi, ms = host_ms(lambda: gen.sample_mpi(seed))
        gen_ms.append(ms)
        mpis.append(mpi)
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
    if serving_launches != {**dict.fromkeys(fr.LAUNCHES, 0), "fused_fwd": len(seeds)}:
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
        fwd_queued_ms = time_ms(kernel, queued=10)
        gather_ms = time_ms(lambda: render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir),
                            iters=5, warmup=1)
    texels, pairs = needed_work(fr, mpi_v, rx, ry, scal)
    n_pix = rx.numel()
    fwd_bytes = texels * 16 + 3 * n_pix * 4 + scal.numel() * 4 + 6 * n_pix * 4
    fwd_bound = bound(fwd_bytes, FLOP_PER_PAIR["fused_fwd"] * pairs, rates)
    log(f"fused_fwd serving inputs: {fwd_ms:.4f} ms as the path launches it (10 launches "
        f"queued: {fwd_queued_ms:.4f} a launch), plain {fwd_plain_ms:.3f} ms, gather "
        f"renderer (F.grid_sample + composite, informational) {gather_ms:.3f} ms; needs "
        f"{fwd_bytes} B, {FLOP_PER_PAIR['fused_fwd'] * pairs} FLOP ({pairs} live pixel-plane "
        f"pairs of {n_views * n_planes * res * res}); bound {fwd_bound[0]:.5f} ms ({card})")
    serving_gather_ms = gather_ms
    del gen, mpi, mpi_v, gather, out, ref
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
    reset_counts(fr)
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
    expected = {**dict.fromkeys(fr.LAUNCHES, 0), "fused_fwd": 3 * n_steps,
                "composite_bwd": split * n_steps, "splat": split * n_steps}
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
    for render in (render_mpi_fused, render_mpi, render_mpi_fused):
        x = mpi.clone().requires_grad_()
        grads_r.append(torch.autograd.grad((render(x, geom_train.dhw, ray_dir, eye, z_dir).color
                                            * cot).sum(), x)[0])
    torch.cuda.synchronize()
    err_g = rel_err(grads_r[0], grads_r[1])
    log(f"training main path rgba gradient, fused Function vs gather autograd: rel err "
        f"{err_g:.3e} (gate {GRAD_REL}), max|grad| {float(grads_r[1].abs().max()):.3e}")
    if not err_g <= GRAD_REL:
        raise RuntimeError("the fused Function's gradient disagrees with the gather renderer's")

    # -- 7. adjoint route at the training shapes ---------------------------------------------
    grads_a = []
    reset_counts(fr)
    for _ in range(2):
        x = mpi.clone().requires_grad_()
        out = render_mpi_fused(x, geom_train.dhw, ray_dir, eye, z_dir, plans=adj_plans,
                               with_disp=False)
        grads_a.append(torch.autograd.grad((out.color * cot).sum(), x)[0])
    torch.cuda.synchronize()
    adjoint_launches = dict(fr.LAUNCHES)
    expected = {**dict.fromkeys(fr.LAUNCHES, 0), "fused_fwd": 2, "composite_bwd": 2, "adjoint": 2}
    if adjoint_launches != expected:
        raise RuntimeError(f"the adjoint route launched {adjoint_launches} in 2 forward+backward "
                           f"passes, expected {expected}")
    err_splat, err_gather = rel_err(grads_a[0], grads_r[0]), rel_err(grads_a[0], grads_r[1])
    repeatable = torch.equal(grads_a[0], grads_a[1])
    log(f"adjoint route (plans={adj_plans}): launches {adjoint_launches} in 2 passes; rgba "
        f"gradient vs the splat route {err_splat:.3e}, vs gather autograd {err_gather:.3e} (gate "
        f"{GRAD_REL}); two runs bitwise equal: {repeatable}; the splat route's two runs bitwise "
        f"equal: {torch.equal(grads_r[0], grads_r[2])}")
    if not (err_splat <= GRAD_REL and err_gather <= GRAD_REL and repeatable):
        raise RuntimeError("the adjoint route's gradient disagrees or is not repeatable")
    del grads_r, grads_a, x, out

    # -- 5. timing and bounds at the training main path's inputs ----------------------
    rx, ry, q, scal = fused_inputs(fr, geom_train.dhw, ray_dir, eye, z_dir, res)
    fwd_train = lambda: fr.warp_composite_fwd(  # noqa: E731
        mpi, rx, ry, q, scal, early_out="grad", with_disp=False, with_warped=True)
    *_, warped, n_live = fwd_train()
    d_samp = fr.composite_bwd(warped, q, scal, cot, n_live=n_live, grad_tau=fr.GRAD_TAU)
    d_samp_ref = fr.composite_bwd_ref(warped, q, scal, cot, n_live=n_live, grad_tau=fr.GRAD_TAU)
    d_tex = fr.warp_splat(d_samp, rx, ry, scal, res, res, n_live=n_live)
    d_tex_ref = fr.warp_splat_ref(d_samp, rx, ry, scal, res, res, n_live=n_live)
    d_tex_direct = fr._launch_splat(d_samp, rx, ry, scal, n_live, res, res, boxed=False)
    torch.cuda.synchronize()
    splat_errs = {"box": rel_err(d_tex, d_tex_ref), "direct": rel_err(d_tex_direct, d_tex_ref)}
    del d_tex_direct
    a_tex = fr.warp_adjoint(d_samp, rx, ry, scal, adj_bands, res, res)
    a_tex_ref = fr.warp_adjoint_ref(d_samp, rx, ry, scal, res, res)
    torch.cuda.synchronize()
    max_err["composite_bwd"] = max(max_err["composite_bwd"], rel_err(d_samp, d_samp_ref))
    max_err["splat"] = worse(max_err["splat"], max(splat_errs.values()))
    max_err["adjoint"] = max(max_err["adjoint"], rel_err(a_tex, a_tex_ref), rel_err(a_tex, d_tex))
    del a_tex, a_tex_ref
    if not (max_err["composite_bwd"] <= TOL and max_err["splat"] <= TOL
            and max_err["adjoint"] <= TOL):
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
        # live d_samp + rx, ry + scal; d_tex written whole
        "adjoint": pairs * 16 + 2 * n_pix * 4 + scal.numel() * 4 + stack,
    }
    with torch.no_grad():
        t_fwd_train = time_ms(fwd_train)
        t_fwd_train_plain = time_ms(lambda: fr.warp_composite_fwd_ref(
            mpi, rx, ry, q, scal, early_out="grad", with_disp=False, with_warped=True),
            iters=5, warmup=1)
        t_bwd = time_ms(lambda: fr.composite_bwd(warped, q, scal, cot, n_live=n_live,
                                                 grad_tau=fr.GRAD_TAU))
        t_bwd_queued = time_ms(lambda: fr.composite_bwd(warped, q, scal, cot, n_live=n_live,
                                                        grad_tau=fr.GRAD_TAU), queued=10)
        t_bwd_plain = time_ms(lambda: fr.composite_bwd_ref(warped, q, scal, cot, n_live=n_live,
                                                           grad_tau=fr.GRAD_TAU),
                              iters=5, warmup=1)
        # the splat's direct path at the same inputs (that of a box beyond its shared memory)
        splat_direct = lambda: fr._launch_splat(  # noqa: E731
            d_samp, rx, ry, scal, n_live, res, res, boxed=False)
        t_splat_direct = time_ms(splat_direct)
        t_splat_direct_queued = time_ms(splat_direct, queued=10)
        t_splat = time_ms(lambda: fr.warp_splat(d_samp, rx, ry, scal, res, res, n_live=n_live))
        t_splat_plain = time_ms(lambda: fr.warp_splat_ref(d_samp, rx, ry, scal, res, res,
                                                          n_live=n_live), iters=5, warmup=1)
        # the adjoint in turn with the splat: splat, adjoint, adjoint, splat
        t_adj = [time_ms(lambda: fr.warp_adjoint(d_samp, rx, ry, scal, adj_bands, res, res))
                 for _ in range(2)]
        t_splat_again = time_ms(lambda: fr.warp_splat(d_samp, rx, ry, scal, res, res,
                                                      n_live=n_live))
        t_adj_plain = time_ms(lambda: fr.warp_adjoint_ref(d_samp, rx, ry, scal, res, res),
                              iters=5, warmup=1)
        t_adj_queued = time_ms(lambda: fr.warp_adjoint(d_samp, rx, ry, scal, adj_bands, res, res),
                               queued=10)
        t_splat_queued = time_ms(lambda: fr.warp_splat(d_samp, rx, ry, scal, res, res,
                                                       n_live=n_live), queued=10)
    t_adj = min(t_adj)
    # one PyTorch call that computes the splat's and the adjoint's function:
    # grid_sample's backward (timed here as a yardstick, used nowhere in the port)
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
    log(f"fused_fwd training form: {t_fwd_train:.4f} ms as the path launches it, plain "
        f"{t_fwd_train_plain:.3f} ms, needs {work['fused_fwd_train']} B; bound {bounds['fused_fwd_train'][0]:.5f} ms ({card})")
    log(f"composite_bwd: {t_bwd:.4f} ms with everything its wrapper launches (10 launches "
        f"queued: {t_bwd_queued:.4f} a launch), plain {t_bwd_plain:.3f} ms, needs "
        f"{work['composite_bwd']} B; bound {bounds['composite_bwd'][0]:.5f} ms ({card})")
    log(f"splat (texel boxes, as the path launches it): {t_splat:.4f} ms with everything its "
        f"wrapper launches, the zero fill of d_tex included (10 queued: {t_splat_queued:.4f} a "
        f"launch); every tap into d_tex {t_splat_direct:.4f} (10 queued: "
        f"{t_splat_direct_queued:.4f}); errors by path {splat_errs}; plain {t_splat_plain:.3f} ms, grid_sample backward "
        f"{t_splat_lib:.4f} ms, needs {work['splat']} B; bound {bounds['splat'][0]:.5f} ms "
        f"({card})")
    log(f"adjoint (measured windows {adj_bands}): {t_adj:.4f} ms with everything its wrapper "
        f"launches (the kernel alone: no op precedes it); the splat timed around it "
        f"{t_splat:.4f} / {t_splat_again:.4f} ms; 10 launches queued: adjoint "
        f"{t_adj_queued:.4f}, splat {t_splat_queued:.4f} a launch; plain {t_adj_plain:.3f} ms, "
        f"grid_sample "
        f"backward {t_splat_lib:.4f} ms, needs {work['adjoint']} B; bound "
        f"{bounds['adjoint'][0]:.5f} ms ({card})")
    del warped, d_samp
    torch.cuda.empty_cache()

    # the forward's two no-grad launches of a step at the main path's inputs: the D phase's
    # fakes (these 8 MPIs and views) and worst-view selection (each MPI read by the group of
    # its candidate views, as TrainStep.worst_views renders it; beside it the materialized
    # repeat that this form read before stacks could be grouped)
    yv_w, pv_w = step.sample_views(rng, bs * n_cand)
    rays_w = fused_inputs(fr, geom_train.dhw, *rays_at(yv_w, pv_w), res)
    no_grad_forms = {}
    for form, tex, rays in (("d_phase_form", mpi, (rx, ry, q, scal)),
                            ("worst_views_form", mpi, rays_w)):
        n_v = rays[0].shape[0]
        err = check_inference_form(fr, f"main path's inputs, {form}, V={n_v}", tex, *rays, False)
        max_err["fused_fwd"] = worse(max_err["fused_fwd"], err)
        t_kernel = time_ms(lambda: fr.warp_composite_fwd(tex, *rays, with_disp=False))
        t_plain = time_ms(lambda: fr.warp_composite_fwd_ref(tex, *rays, with_disp=False),
                          iters=5, warmup=1)
        texels_f, pairs_f = needed_work(fr, tex, *rays[:2], rays[3])
        n_pix_f = rays[0].numel()
        bytes_f = texels_f * 16 + 3 * n_pix_f * 4 + rays[3].numel() * 4 + 5 * n_pix_f * 4
        b = bound(bytes_f, FLOP_PER_PAIR["fused_fwd"] * pairs_f, rates)
        log(f"fused_fwd {form} (V={n_v}, {tex.shape[0]} stacks, L={n_train}, no gradient): "
            f"{t_kernel:.4f} ms as the path launches it, plain {t_plain:.3f} ms, needs {bytes_f} B "
            f"({pairs_f} live pixel-plane pairs of {n_v * n_train * res * res}, {texels_f} "
            f"texels touched); bound {b[0]:.5f} ms by {b[1]} ({card})")
        no_grad_forms.update({f"{form}_ms": t_kernel, f"{form}_plain_ms": t_plain,
                              f"{form}_bound_ms": b[0]})
    mpi_w = mpi.repeat_interleave(n_cand, dim=0)
    t_repeat = time_ms(lambda: fr.warp_composite_fwd(mpi_w, *rays_w, with_disp=False))
    log(f"fused_fwd worst_views_form on a materialized repeat of the stacks ({mpi_w.numel() * 4} "
        f"B): {t_repeat:.4f} ms ({card})")
    no_grad_forms["worst_views_form_repeat_ms"] = t_repeat
    del mpi, mpi_w
    torch.cuda.empty_cache()

    # -- 6. banded serving path ------------------------------------------------------------
    gen_b = FakeImageGenerator(cfg, gen_module, use_fused=False, device=dev)
    if gen_b.tiled_bands != tiled_bands:
        raise RuntimeError(f"the harness planned {gen_b.tiled_bands}, expected {tiled_bands}")
    calls = {"row_steps": 0, "gather_args": None}
    warp_row_tiles, gather_patches = tw._warp_row_tiles, tw.gather_patches

    def counted_row_step(*args, **kw):
        calls["row_steps"] += 1
        return warp_row_tiles(*args, **kw)

    def recorded_gather(texf, offs, band_x, band_yc, **kw):
        calls["gather_args"] = (texf, offs, band_x, band_yc)
        return gather_patches(texf, offs, band_x, band_yc, **kw)

    tw._warp_row_tiles, tw.gather_patches = counted_row_step, recorded_gather
    banded_ms, errs_b = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fr)
    try:
        for seed, mpi in zip(seeds, mpis):
            yv, pv = gen_b.sample_views(seed, n_views)
            mpi_v = mpi.expand(n_views, -1, -1, -1, -1)
            (color, depth), ms = host_ms(lambda: gen_b.render(mpi_v, yv, pv))
            banded_ms.append(ms)
            ray_dir, eye, z_dir = rays_at(yv, pv)
            with torch.no_grad():
                gather = render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir)
            errs_b.append(max(float((color - (gather.color * 2.0 - 1.0)).abs().max()),
                              float((depth - gather.depth).abs().max())))
        peak_banded = torch.cuda.max_memory_allocated() / 1e9
        # the last MPI again, in slabs of 24 planes (the second of two calls is
        # timed: the first meets the matrix products' shapes for the first time)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for _ in range(2):
                chunked, chunked_ms = host_ms(lambda: render_mpi_chunked(
                    mpi_v, geom.dhw, ray_dir, eye, z_dir, plane_chunk=24,
                    tiled_bands=tiled_bands, patch_backend="cuda"))
        peak_chunked = torch.cuda.max_memory_allocated() / 1e9
        banded_launches = dict(fr.LAUNCHES)
    finally:
        tw._warp_row_tiles, tw.gather_patches = warp_row_tiles, gather_patches
    err_chunk = max(float((a - b).abs().max()) for a, b in zip(chunked, gather))
    per_plane = lambda x: x[:, None].expand(n_views, n_planes, *x.shape[1:]).reshape(  # noqa: E731
        n_views * n_planes, *x.shape[1:])
    grid, _ = homography_grid(geom.dhw.repeat(n_views, 1), per_plane(eye), per_plane(ray_dir),
                              per_plane(z_dir))
    covered = bool(tw.bands_cover((n_views * n_planes, 4, res, res), grid, band_y, band_x,
                                  tile=(8, res)))
    del grid
    expected = {**dict.fromkeys(fr.LAUNCHES, 0), "patch_gather": calls["row_steps"]}
    log(f"banded serving path: {len(seeds)} seeds x {n_views} views x {n_planes} planes in one "
        f"call each (tile rows in groups under {renderer_mod.TILED_STEP_BYTES / 2 ** 30:.0f} GiB "
        f"of hats), then two renders in slabs of 24 planes; {calls['row_steps']} tile-row steps, "
        f"launches {banded_launches}")
    log(f"banded render vs gather renderer: {['%.2e' % e for e in errs_b]}, chunked {err_chunk:.2e} "
        f"(gate 5e-4); bands cover the sampled poses: {covered}")
    log(f"banded render ms per call of {n_views} views: {['%.1f' % x for x in banded_ms]}, in "
        f"slabs {chunked_ms:.1f}; peak memory {peak_banded:.2f} GB in one call, "
        f"{peak_chunked:.2f} GB in slabs ({card})")
    if banded_launches != expected or calls["row_steps"] == 0:
        raise RuntimeError(f"banded path launched {banded_launches}, expected {expected}")
    if not (max(errs_b) <= 5e-4 and err_chunk <= 5e-4):  # also catches NaN
        raise RuntimeError("the banded render disagrees with the gather renderer")
    if not covered:
        raise RuntimeError("the planned bands do not cover the sampled poses")

    # the patch gather at this path's inputs (the last tile-row step's texture and offsets)
    texf, offs, _, _ = calls["gather_args"]
    out, ref = pg.gather_patches(texf, offs, band_x, band_yc), pg.gather_patches_ref(
        texf, offs, band_x, band_yc)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        max_err["patch_gather"] = float("inf")
        raise RuntimeError("patch_gather disagrees with its plain version on the path's inputs")
    # one PyTorch call for the same copy: the advanced index alone, its indices made beforehand
    n_idx = torch.arange(texf.shape[0], device=dev).reshape(-1, 1, 1, 1)
    rows_i = (offs[..., 0, None].long() + torch.arange(band_x, device=dev))[..., None]
    cols_i = (offs[..., 1, None].long() + torch.arange(band_yc, device=dev))[:, :, None, :]
    t_pg = time_ms(lambda: pg.gather_patches(texf, offs, band_x, band_yc, validate=False))
    t_pg_plain = time_ms(lambda: pg.gather_patches_ref(texf, offs, band_x, band_yc))
    t_pg_lib = time_ms(lambda: texf[n_idx, rows_i, cols_i])
    pg_bytes = 2 * out.numel() * out.element_size() + offs.numel() * 4
    pg_bound = bound(pg_bytes, 0, rates)
    log(f"patch_gather at the path's inputs ({tuple(out.shape)} f32 from {tuple(texf.shape)}): "
        f"{t_pg:.4f} ms, plain {t_pg_plain:.4f} ms, one advanced index {t_pg_lib:.4f} ms, needs "
        f"{pg_bytes} B; bound {pg_bound[0]:.5f} ms ({card})")
    del out, ref, texf, offs, n_idx, rows_i, cols_i

    # where the banded render's time goes: one call under the profiler, by the tiled
    # warp's spans; beside it the fused and the gather render of the same MPI
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen_b.render(mpi_v, yv, pv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen_b.render(mpi_v, yv, pv)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.is_user_annotation]
    busy_ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa: E731
    banded_spans = {}
    for span in (e for e in device if e.is_user_annotation and e.name.startswith("tiled_warp.")):
        inside = [e for e in kernels
                  if span.time_range.start <= e.time_range.start < span.time_range.end]
        banded_spans[span.name] = banded_spans.get(span.name, 0.0) + busy_ms(inside)
    banded_busy = busy_ms(kernels)
    banded_spans["other (pad, layout, composite)"] = banded_busy - sum(banded_spans.values())
    with torch.no_grad():
        t_banded = time_ms(lambda: gen_b.render(mpi_v, yv, pv), iters=5, warmup=1)
        t_fused_same = time_ms(lambda: render_mpi_fused(mpi_v, geom.dhw, ray_dir, eye, z_dir))
        t_gather_same = time_ms(lambda: render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir),
                                iters=5, warmup=1)
    log(f"banded render of {n_views} views x {n_planes} planes: {t_banded:.2f} ms (CUDA events); "
        f"device busy {banded_busy:.2f} ms under the profiler, by span: "
        + ", ".join(f"{key} {val:.2f}" for key, val in banded_spans.items())
        + f"; the same MPI and views: fused kernel {t_fused_same:.4f} ms, gather renderer "
        f"{t_gather_same:.3f} ms ({card})")
    del mpis, mpi_v, gen_b, gen_module, chunked, gather
    torch.cuda.empty_cache()

    # -- 8. training loop from a dataset --------------------------------------------------
    del state, step, step_with_grads
    torch.cuda.empty_cache()
    loop = training_loop_phase(fr, cfg, card, dev)

    # -- 9. eval and 10. viz at full FFHQ256 width ----------------------------------------
    import os
    import shutil
    import tempfile

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        evaluation, ckpt_dir = eval_phase(fr, tw, pg, cfg, card, dev, tmp)
        viz = viz_phase(fr, cfg, ckpt_dir, os.path.join(tmp, "vis"), card, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_paths = (serving_launches, train_launches, adjoint_launches, banded_launches,
                  loop["launches"], evaluation["launches"], viz["launches"])

    def entry(kname, line, ms, plain_ms, b, library_ms, replaces="gmpi_tpu/ops/pallas_warp.py",
              **extra):
        return {"name": kname, "route": "cuda", "source": f"gmpi_tpu_torch/csrc/{kname}.cu",
                "replaces": f"{replaces}:{line}",
                "launches": sum(path[kname] for path in main_paths),
                "max_abs_err": max_err[kname], "err_scale": "max|plain| per field", "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": library_ms, **extra}

    record = {"kernels": [
        entry("fused_fwd", 518, fwd_ms, fwd_plain_ms, fwd_bound, None,
              serving_launches=serving_launches["fused_fwd"],
              train_launches=train_launches["fused_fwd"], train_form_ms=t_fwd_train,
              queued_ms=fwd_queued_ms,
              train_form_plain_ms=t_fwd_train_plain,
              train_form_bound_ms=bounds["fused_fwd_train"][0], **no_grad_forms),
        entry("composite_bwd", 2407, t_bwd, t_bwd_plain, bounds["composite_bwd"], None,
              also_replaces="gmpi_tpu/ops/pallas_warp.py:2295", queued_ms=t_bwd_queued),
        entry("splat", 1355, t_splat, t_splat_plain, bounds["splat"], t_splat_lib,
              also_replaces="gmpi_tpu/ops/pallas_warp.py:1184", form="texel boxes",
              queued_ms=t_splat_queued, errs_by_path=splat_errs, direct_path_ms=t_splat_direct,
              direct_path_queued_ms=t_splat_direct_queued),
        entry("adjoint", 2029, t_adj, t_adj_plain, bounds["adjoint"], t_splat_lib,
              splat_ms_around=[t_splat, t_splat_again], windows=list(adj_bands),
              queued_ms=t_adj_queued, splat_queued_ms=t_splat_queued),
        entry("patch_gather", 33, t_pg, t_pg_plain, pg_bound, t_pg_lib,
              replaces="gmpi_tpu/ops/pallas_patch.py", err_scale="exact equality required"),
    ], "train_steps": n_steps, "train_step_ms": statistics.median(timed),
        "banded_render_ms": t_banded, "banded_spans_ms": banded_spans,
        "banded_same_mpi_fused_ms": t_fused_same, "banded_same_mpi_gather_ms": t_gather_same,
        "banded_peak_gb": peak_banded, "banded_chunked_peak_gb": peak_chunked,
        "serving_gather_ms": serving_gather_ms, "loop": loop,
        "eval": {**{k: v for k, v in evaluation.items() if k != "tasks"}, "viz": viz}}
    log(json.dumps(record))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
