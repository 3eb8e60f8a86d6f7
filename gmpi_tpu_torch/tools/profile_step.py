"""Profile one FFHQ256 train step of the port on the card.

    python -m gmpi_tpu_torch.tools.profile_step [--preset FFHQ256] [--no_fused_renderer]
        [--top 25]

Builds the train state from seeded random weights and a seeded random real
batch, takes two warm-up steps, then one D phase and one G phase under
``torch.profiler`` (CPU and CUDA activities), and prints for each phase the
device time of each of the step's spans (fakes, D loss, D update; worst
views, G forward, G update; a backward's kernels are the ones between its
neighbours, since the autograd engine launches them from its own thread),
then the device kernels by
total device time: the first ``--top`` and, wherever they rank, the port's
own render kernels.  ``--no_fused_renderer`` profiles the step's
tile-banded route instead (the train CLI's flag: patches through the
patch-gather kernel, taps through the tap kernel, the tiled adjoint as the
warp's backward).  Prints the
card's name and power limit first.  Needs a CUDA card; raises without one.
"""

import argparse
import dataclasses
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core import poses
from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step


SPAN = "train_step."  # the step's own profiler spans (train/step.py)
OWN_KERNELS = ("fused_fwd_kernel", "composite_bwd_kernel", "splat_tile_kernel",
               "patch_gather_kernel")


def _profiled(name, fn, top):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host operator's entry repeats its kernels' time
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = sorted((e for e in device if not e.is_user_annotation),
                      key=lambda e: e.time_range.start)
    busy = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa: E731
    print(f"== {name}: wall {wall:.1f} ms (profiler on), device busy {busy(launches):.1f} ms "
          f"in {len(launches)} kernel launches")
    # Each span as the device saw it, from its first kernel's start to its last
    # one's end.  A backward runs on the autograd engine's thread, so its span
    # is an empty range on the device: its kernels are those that follow it,
    # up to the next span.
    spans = sorted((e for e in device if e.is_user_annotation and e.name.startswith(SPAN)),
                   key=lambda e: e.time_range.start)
    row = lambda label, es: print(  # noqa: E731
        f"  {label:<28s} device extent "
        f"{(es[-1].time_range.end - es[0].time_range.start) / 1e3:8.2f} ms, busy "
        f"{busy(es):8.2f} ms in {len(es)} launches")
    edge, label = (launches[0].time_range.start if launches else 0), "(before the spans)"
    for span in spans + [None]:
        lo, hi = (span.time_range.start, span.time_range.end) if span else (float("inf"),) * 2
        inside = [e for e in launches if lo <= e.time_range.start < hi]
        if span and len(inside) <= 1:  # no range of its own: it names what follows
            label = span.name[len(SPAN):] + " (by position)"
            continue
        between = [e for e in launches if edge <= e.time_range.start < lo]
        if busy(between) >= 0.005:
            row(label, between)
        if span:
            row(span.name[len(SPAN):], inside)
            edge, label = hi, "(between spans)"
    by_name = {}
    for e in launches:
        by_name.setdefault(e.name, []).append(e)
    ranked = sorted(by_name.items(), key=lambda kv: -busy(kv[1]))
    for i, (key, es) in enumerate(ranked):
        if i < top or any(own in key for own in OWN_KERNELS):
            print(f"  {busy(es):10.3f} ms  x{len(es):<5d} {key[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="FFHQ256")
    ap.add_argument("--no_fused_renderer", action="store_true",
                    help="profile the tile-banded route instead of the fused kernels")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.preset)
    if args.no_fused_renderer:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 use_fused_renderer=False))
    dev = torch.device("cuda")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(cfg, device=dev)
    bs, res = cfg.hparams.batch_size, cfg.resolution
    data = torch.Generator().manual_seed(1)
    real = (torch.rand((bs, 3, res, res), generator=data) * 2.0 - 1.0).to(dev)
    c2w, _, _ = poses.sample_sphere_poses(data, bs, cfg.camera, device=dev)
    pose = flat_pose_from_c2w(c2w, cfg.train.d_cond_pose_dim)
    rng = torch.Generator().manual_seed(2)
    for _ in range(2):
        step(state, real, pose, rng)
    _profiled("D phase", lambda: step.d_phase(state, real, pose, rng), args.top)
    _profiled("G phase", lambda: step.g_phase(state, bs, rng), args.top)


if __name__ == "__main__":
    main()
