#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port ``gmpi_tpu_torch`` (one CUDA card).

    python3 chip_smoke.py

Phases, each of which raises on failure (nonzero exit, no result line):

1. setup — print the card's name and power limit, build every CUDA kernel
   from ``gmpi_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel), turn
   TF32 off for cuDNN convolutions and matmuls;
2. kernels vs plain versions — each kernel and its plain PyTorch version on
   the same inputs at the serving shapes (V=4 views, L=96 planes, 256^2
   texture and image, FFHQ256 geometry, poses at the truncation corners and
   the centre), with and without expected disparity, on three MPIs: uniform
   random RGBA, a sparse (mostly transparent) stack, and the sparse stack with
   fully opaque mid planes; max abs error <= 1e-4;
3. main path — ``FakeImageGenerator`` at full FFHQ256 width with seeded random
   weights and the fused renderer: for 4 seeds, ``sample_mpi`` then
   ``render`` of 4 views.  Kernel launch counts are reset just before and read
   just after; outputs must be finite, colors in [-1, 1], depths inside the
   plane range, and the last render must match the gather renderer;
4. timing at the main path's inputs (CUDA events, median of 20 after
   warm-up), the bound from the bytes and operations those inputs need.

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
FLOP_PER_PIXEL_PLANE = 60  # fused_fwd: taps, lerps and composite per live pair
TOL = 1e-4


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


def fused_inputs(fr, dhw, ray_dir, eye, z_dir, tex_size):
    scal = fr.plane_affine(dhw, eye, tex_size, tex_size).contiguous()
    rx, ry, q = (x.contiguous() for x in fr.ray_fields(ray_dir, z_dir))
    return rx, ry, q, scal


def needed_work(fr, tex, rx, ry, scal):
    """Bytes and fp32 operations the fused forward needs on these inputs:
    every texel some live (pixel, plane) tap touches, read once (one stack for
    an expanded MPI), rays and scal read once, outputs written once; 60 FLOP
    per live pair.  A pair is live while the pixel's transmittance is >= the
    early-out threshold."""
    v, n_l = scal.shape[:2]
    th, tw = tex.shape[-2:]
    shared = v > 1 and tex.stride(0) == 0
    touched = torch.zeros(((1 if shared else v) * n_l * th * tw,), dtype=torch.bool,
                          device=tex.device)
    view_base = (0 if shared else 1) * torch.arange(v, device=tex.device).reshape(v, 1, 1)
    t = torch.ones_like(rx)
    pairs = 0
    for l in range(n_l):
        live = t >= fr.EARLY_OUT_T
        pairs += int(live.sum())
        s = scal[:, l, :, None, None]
        fx, fy = s[:, 0] * rx + s[:, 1], s[:, 2] * ry + s[:, 3]
        x0, y0 = torch.floor(fx), torch.floor(fy)
        for dy in (0, 1):
            for dx in (0, 1):
                xx, yy = x0 + dx, y0 + dy
                ok = live & (xx >= 0) & (xx <= tw - 1) & (yy >= 0) & (yy <= th - 1)
                idx = ((view_base * n_l + l) * th * tw + yy.clamp(0, th - 1) * tw
                       + xx.clamp(0, tw - 1)).long()
                touched[idx[ok]] = True
        a = fr.sample_bilinear(tex[:, l], fx, fy)[:, 3]
        t = t * ((1.0 - a) + fr.EPS)
    n_pix = rx.numel()
    n_bytes = int(touched.sum()) * 4 * 4 + 3 * n_pix * 4 + scal.numel() * 4 + 6 * n_pix * 4
    return n_bytes, FLOP_PER_PIXEL_PLANE * pairs, pairs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import render_mpi
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.models.generator import Generator
    from gmpi_tpu_torch.ops import _build
    from gmpi_tpu_torch.ops import fused_render as fr

    # -- 1. setup --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(name)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32: off for cuDNN convolutions and CUDA matmuls (full fp32)")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for kname, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    dev = torch.device("cuda")
    cfg = get_config("FFHQ256")
    n_planes, res = cfg.eval_n_planes, cfg.resolution
    eval_cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))
    geom = eval_cfg.plane_geometry(device=dev)
    intr = cam.intrinsics_from_fov(cfg.fov_deg, res, res)

    # -- 2. kernel vs plain version at the serving shapes ----------------------
    c = cfg.camera
    k = c.n_truncated_stds
    yaws = torch.tensor([[k * c.yaw_std], [-k * c.yaw_std], [k * c.yaw_std], [0.0]])
    pitches = torch.tensor([[k * c.pitch_std], [-k * c.pitch_std], [-k * c.pitch_std], [0.0]])
    c2w, _, _ = poses.sample_sphere_poses(None, 4, c, given_yaws=yaws, given_pitches=pitches,
                                          device=dev)
    ray_dir, eye, z_dir = cam.generate_rays(intr, c2w)
    rx, ry, q, scal = fused_inputs(fr, geom.dhw, ray_dir, eye, z_dir, res)
    g = torch.Generator(device=dev).manual_seed(0)
    uniform = torch.rand((4, n_planes, 4, res, res), device=dev, generator=g)
    sparse = uniform.clone()
    sparse[:, :, 3] *= 0.05
    opaque_mid = sparse.clone()
    opaque_mid[:, n_planes // 2 - 4:n_planes // 2 + 4, 3] = 1.0
    max_err = 0.0
    for case, tex in (("uniform", uniform), ("sparse", sparse), ("opaque_mid", opaque_mid)):
        for with_disp in (False, True):
            out = fr.warp_composite_fwd(tex, rx, ry, q, scal, with_disp=with_disp)
            ref = fr.warp_composite_fwd_ref(tex, rx, ry, q, scal, with_disp=with_disp)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
            log(f"fused_fwd vs plain [{case}, with_disp={with_disp}]: max abs err "
                f"{max(errs):.3e} (fields {['%.2e' % e for e in errs]})")
            if not all(e <= TOL for e in errs):
                raise RuntimeError(f"fused_fwd disagrees with its plain version: {errs} > {TOL}")
            max_err = max(max_err, *errs)
        ms = time_ms(lambda: fr.warp_composite_fwd(tex, rx, ry, q, scal))
        log(f"fused_fwd [{case}] V=4 L={n_planes} {res}^2: {ms:.4f} ms ({card})")
    del uniform, sparse, opaque_mid

    # -- 3. main path ------------------------------------------------------------
    t0 = time.perf_counter()
    gen_module = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(0))
    gen = FakeImageGenerator(cfg, gen_module, use_fused=True, device=dev)
    log(f"generator: FFHQ256 full width ({sum(p.numel() for p in gen.G.parameters())} params, "
        f"{n_planes} planes), built in {time.perf_counter() - t0:.1f} s")
    seeds, n_views = (0, 1, 2, 3), 4
    gen_ms, render_ms = [], []
    lo, hi = cfg.planes.min_d * 0.9, cfg.planes.max_d * 1.4
    fr.LAUNCHES = 0
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mpi = gen.sample_mpi(seed)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        yv, pv = gen.sample_views(seed, n_views)
        mpi_v = mpi.expand(n_views, -1, -1, -1, -1)
        t0 = time.perf_counter()
        color, depth = gen.render(mpi_v, yv, pv)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
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
    launches = fr.LAUNCHES
    if launches != len(seeds):
        raise RuntimeError(f"fused_fwd launched {launches} times on the main path, "
                           f"expected one per render call ({len(seeds)})")
    log(f"main path: {len(seeds)} seeds x {n_views} views, fused_fwd launches {launches}")
    mpix = n_views * res * res / 1e6
    log(f"generator ms per MPI: {['%.2f' % x for x in gen_ms]} (median "
        f"{statistics.median(gen_ms):.2f}; first includes cuDNN warm-up) ({card})")
    log(f"render ms per call of {n_views} views: {['%.3f' % x for x in render_ms]}, median per "
        f"view {statistics.median(render_ms) / n_views:.4f} ms, "
        f"{mpix / (statistics.median(render_ms) / 1e3):.1f} Mpix/s host-timed ({card})")

    # the last render against the gather renderer on the same inputs
    c2w, _, _ = poses.sample_sphere_poses(None, n_views, c, given_yaws=yv, given_pitches=pv,
                                          device=dev)
    ray_dir, eye, z_dir = cam.generate_rays(intr, c2w)
    with torch.no_grad():
        gather = render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir)
    err_c = float((color - (gather.color * 2.0 - 1.0)).abs().max())
    err_d = float((depth - gather.depth).abs().max())
    log(f"main path fused vs gather renderer: color {err_c:.3e}, depth {err_d:.3e} (gate 5e-4)")
    if err_c > 5e-4 or err_d > 5e-4:
        raise RuntimeError("fused render disagrees with the gather renderer")

    # -- 4. timing at the main path's inputs ---------------------------------------
    rx, ry, q, scal = fused_inputs(fr, geom.dhw, ray_dir, eye, z_dir, res)
    kernel = lambda: fr.warp_composite_fwd(mpi_v, rx, ry, q, scal)  # noqa: E731
    plain = lambda: fr.warp_composite_fwd_ref(mpi_v, rx, ry, q, scal)  # noqa: E731
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    max_err = max(max_err, *[float((a - b).abs().max()) for a, b in zip(out, ref)])
    gather_fn = lambda: render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir)  # noqa: E731
    with torch.no_grad():
        ms, plain_ms = time_ms(kernel), time_ms(plain, iters=20, warmup=1)
        gather_ms = time_ms(gather_fn, iters=5, warmup=1)
    n_bytes, n_flop, pairs = needed_work(fr, mpi_v, rx, ry, scal)
    bound_bytes, bound_ops = n_bytes / bw * 1e3, n_flop / flops * 1e3
    log(f"fused_fwd main-path inputs: {ms:.4f} ms, plain {plain_ms:.3f} ms, gather renderer "
        f"(F.grid_sample + composite, informational) {gather_ms:.3f} ms; needs {n_bytes} B, "
        f"{n_flop} FLOP ({pairs} live pixel-plane pairs of {mpi_v.shape[0] * n_planes * res * res})"
        f"; bound {max(bound_bytes, bound_ops):.5f} ms ({card})")
    record = {"kernels": [{
        "name": "fused_fwd",
        "route": "cuda",
        "source": "gmpi_tpu_torch/csrc/fused_fwd.cu",
        "replaces": "gmpi_tpu/ops/pallas_warp.py:518",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
    }]}
    log(json.dumps(record))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
