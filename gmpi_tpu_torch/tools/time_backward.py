"""Time the fused renderer's backward kernels in every form they were built in.

    python -m gmpi_tpu_torch.tools.time_backward [--iters 20]

At the FFHQ256 training shapes (8 views of 8 MPIs, 32 planes, 256^2 texture
and image, poses at the truncation corners and the centre; seeded random RGBA,
alpha x 0.3 so that most pixels reach most planes), the forward kernel's
training form gives the residual and ``n_live``; then, each held against its
plain version (1e-4 of max|plain|) and timed with CUDA events (median of
``--iters``, one launch per event pair with everything its wrapper launches,
and 10 launches queued):

* the composite backward (``composite_bwd``);
* the splat in its two paths: each tile's taps summed in its texel box in
  shared memory, then added into ``d_tex`` (what ``warp_splat`` launches), and
  every tap added into ``d_tex`` directly (the path of a box beyond the
  kernel's shared memory).

Prints the card's name and power limit first and a JSON line last.  Needs a
CUDA card; raises without one.
"""

import argparse
import json
import statistics
import subprocess

import torch

from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses
from gmpi_tpu_torch.ops import fused_render as fr


def _time(fn, iters, queued=1):
    for _ in range(3):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_backward: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    cfg = get_config("FFHQ256")
    res, n_l, k = cfg.resolution, cfg.planes.n_planes, cfg.camera.n_truncated_stds
    sy, sp = k * cfg.camera.yaw_std, k * cfg.camera.pitch_std
    yaws = torch.tensor([[sy], [-sy], [sy], [-sy], [0.0], [sy], [0.0], [-sy]])
    pitches = torch.tensor([[sp], [-sp], [-sp], [sp], [0.0], [0.0], [sp], [0.0]])
    c2w, _, _ = poses.sample_sphere_poses(None, 8, cfg.camera, given_yaws=yaws,
                                          given_pitches=pitches, device=dev)
    ray_dir, eye, z_dir = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)
    geom = cfg.plane_geometry(device=dev)
    scal = fr.plane_affine(geom.dhw, eye, res, res).contiguous()
    rx, ry, q = (x.contiguous() for x in fr.ray_fields(ray_dir, z_dir))
    g = torch.Generator(device=dev).manual_seed(0)
    tex = torch.rand((8, n_l, 4, res, res), device=dev, generator=g)
    tex[:, :, 3] *= 0.3
    *_, warped, n_live = fr.warp_composite_fwd(tex, rx, ry, q, scal, early_out="grad",
                                               with_disp=False, with_warped=True)
    gc = torch.randn((8, 3, res, res), device=dev, generator=g)
    kw = dict(n_live=n_live, grad_tau=fr.GRAD_TAU)
    pairs = int(n_live.sum())
    print(f"inputs: V=8, L={n_l}, {res}^2; {pairs} live pixel-plane pairs of "
          f"{8 * n_l * res * res}", flush=True)
    record = {"card": card, "live_pairs": pairs}

    def report(name, fn, out, ref):
        torch.cuda.synchronize()
        err = float((out - ref).abs().max() / ref.abs().max())
        if not err <= 1e-4:
            raise RuntimeError(f"{name}: {err} of max|plain| > 1e-4")
        ms, queued = _time(fn, args.iters), _time(fn, args.iters, queued=10)
        print(f"{name}: {ms:.4f} ms, 10 queued {queued:.4f} ms a launch, err {err:.2e} ({card})",
              flush=True)
        record[name] = {"ms": ms, "queued_ms": queued, "err": err}

    d_samp = fr.composite_bwd(warped, q, scal, gc, **kw)
    report("composite_bwd", lambda: fr.composite_bwd(warped, q, scal, gc, **kw), d_samp,
           fr.composite_bwd_ref(warped, q, scal, gc, **kw))
    del warped, tex
    ref = fr.warp_splat_ref(d_samp, rx, ry, scal, res, res, n_live=n_live)
    for name, boxed in (("splat", True), ("splat, every tap into d_tex", False)):
        fn = lambda: fr._launch_splat(d_samp, rx, ry, scal, n_live, res, res, boxed)  # noqa: E731
        report(name, fn, fn(), ref)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
