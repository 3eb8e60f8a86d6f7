"""Traffic ``fid``: a closed loop of FID sampling requests from one client,
eval's ``fid_kid`` task without its PNG dump.

A request is one seed: ``FakeImageGenerator.sample_mpi`` (batch 1, the eval
plane count) and ``render`` of one view at a pose from ``sample_views``,
ended by a synchronize.  Its latency runs from the call to the
synchronized view.  ``use_fused`` picks the route: the fused kernel
(``eval_gmpi_torch.py --fused_renderer``) or eval's default, the
tile-banded warp with the patch-gather kernel (bands planned on the card in
set-up).  Request seeds are ``base + i``, ``base`` drawn from the run's seed
(below 10^12, so that ``sample_views``' pose seed stays in a generator's
range).

The check: ``check_sample`` requests drawn from the seed among the first
``check_within`` of the window (every run completes more), their MPI and
their view (colour and depth) against the reference's for the same seed,
each as the root mean square of the difference over that of the
reference.  Of a sampled request's MPI the window keeps ``MPI_KEPT``
elements drawn from its seed (all of a smaller MPI), of its view all, each
copied to the host: the outputs a check keeps take no memory of the card.

Parameters: ``use_fused``, ``warmup``, ``check_sample``, ``check_within``.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import weights as weights_mod

# elements of a sampled request's MPI that the check compares (a 96-plane
# 1024^2 MPI holds 402,653,184)
MPI_KEPT = 1 << 22


def _seeds(seed: int) -> Dict[str, int]:
    ss = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint32)
    base = int(np.random.default_rng(int(ss[1])).integers(0, 10**12 - 10**6))
    return {"weights": int(ss[0]), "base": base, "sample": int(ss[2])}


def rel_rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float(torch.sqrt(torch.mean((x - ref) ** 2)) / torch.sqrt(torch.mean(ref ** 2)))


class FidRunner:
    def __init__(self, ctx):
        from gmpi_tpu_torch.eval.harness import FakeImageGenerator
        from gmpi_tpu_torch.models.generator import Generator

        self.ctx, p, dev = ctx, ctx.params, ctx.device
        self.seeds = _seeds(ctx.seed)
        weights = weights_mod.make(ctx.exp, self.seeds["weights"], dev)
        G = Generator(ctx.cfg.generator_cfg()).to(dev)
        G.load_state_dict(weights_mod.split(weights, "G"))
        del weights
        self.gen = FakeImageGenerator(ctx.cfg, G, use_fused=p["use_fused"], device=dev)
        ctx.mark("generator")
        self.sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        self.sample = sample_of(ctx)
        numel = ctx.cfg.eval_n_planes * 4 * ctx.cfg.resolution ** 2
        self.mpi_index = {i: mpi_index(self.seeds["base"] + i, numel, dev) for i in self.sample}
        self.split = False
        self.kept: Dict[int, tuple] = {}
        self.latency_s: List[float] = []
        self.sample_s: List[float] = []
        self.render_s: List[float] = []
        for i in range(p["warmup"]):  # every shape of the window, before it
            self._request(-1 - i, keep=False)
            ctx.mark(f"warm-up {i}")
        self.latency_s.clear()
        self.split = ctx.trace  # a traced run times sample_mpi and render apart

    def _request(self, i: int, keep: bool) -> None:
        seed = self.seeds["base"] + i if i >= 0 else i + 10**12
        t0 = time.perf_counter()
        with record_function("bench.sample_mpi"):
            mpi = self.gen.sample_mpi(seed)
            if self.split:
                self.sync()
        t1 = time.perf_counter()
        with record_function("bench.render"):
            yaws, pitches = self.gen.sample_views(seed, 1)
            color, depth = self.gen.render(mpi, yaws, pitches)
            self.sync()
        t2 = time.perf_counter()
        self.latency_s.append(t2 - t0)
        if self.split:
            self.sample_s.append(t1 - t0)
            self.render_s.append(t2 - t1)
        if keep and i in self.sample:
            self.kept[i] = kept_outputs(seed, mpi, color, depth, self.mpi_index[i])

    # -- the window ------------------------------------------------------------------

    def run_one(self, i: int) -> None:
        self._request(i, keep=True)

    def attempted(self, n: int) -> int:
        return n

    def failed(self, n: int) -> int:
        return 0

    def end_to_end(self, window_s: float, n: int) -> Dict[str, float]:
        lat = sorted(self.latency_s)
        p95 = float(np.percentile(np.asarray(lat), 95)) if lat else float("nan")
        return {"fake_img_s": n / window_s, "fake_ms_p95": p95 * 1e3}

    def release(self) -> None:
        # a sampled request the window did not reach is served now, untimed
        for i in self.sample:
            if i not in self.kept:
                self._request(i, keep=True)
        self.gen = None

    # -- the check -------------------------------------------------------------------

    def check(self):
        out = compare(self.ctx, self.kept, self.sample, self.ctx.limits)
        self.kept.clear()
        return out


def mpi_index(seed: int, numel: int, device) -> Optional[torch.Tensor]:
    """The flat indices of a request's MPI that the check compares:
    ``MPI_KEPT`` drawn from its seed, or ``None`` (all) for a smaller MPI."""
    if numel <= MPI_KEPT:
        return None
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(numel, (MPI_KEPT,), generator=gen).to(device)


def kept_outputs(seed: int, mpi, color, depth, index: Optional[torch.Tensor]) -> tuple:
    """What the check compares of a request (``index``: ``mpi_index``'s), on
    the host."""
    flat = mpi.reshape(-1)
    return (seed, (flat if index is None else flat[index]).cpu(), color.cpu(), depth.cpu())


def reference_outputs(ctx, seeds, control: bool = False):
    """``{seed: (mpi, colour, depth)}`` of the reference (``control``: one
    precision below), as the check keeps them (``kept_outputs``)."""
    from benchmark.reference import gmpi, precision

    dev = ctx.device
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = weights_mod.make(ctx.exp, _seeds(ctx.seed)["weights"], dev)
    G = gmpi.build_models(ctx.exp, weights, dev, with_d=False)
    del weights
    sampler = gmpi.Sampler(ctx.exp, G, dev, plane_chunk=ctx.params.get("check_plane_chunk", 0))
    out = {}
    with precision.mode(control=control):
        for s in seeds:
            mpi = sampler.mpi(s)
            color, depth = sampler.view(mpi, *sampler.pose(s))
            out[s] = kept_outputs(s, mpi, color, depth, mpi_index(s, mpi.numel(), dev))[1:]
            del mpi, color, depth
    return out


# the numbers compared; the others are printed beside them (PERF.md says why)
COMPARED = ("mpi_gap", "color_gap")


def gaps(prog: tuple, ref: tuple) -> Dict[str, float]:
    """Relative RMS gaps of the MPI, the colour and the depth; and the
    colour's largest absolute gap."""
    return {"mpi_gap": rel_rms(prog[0], ref[0]), "color_gap": rel_rms(prog[1], ref[1]),
            "depth_gap": rel_rms(prog[2], ref[2]),
            "color_max_gap": float((prog[1].double() - ref[1].double()).abs().max())}


def compare(ctx, kept: Dict[int, tuple], sample: List[int], limits: Dict[str, float]):
    """``[(name, value, limit)]``: the worst of the sampled requests' gaps.
    A sampled request the window did not complete has no output: every
    number reads infinite."""
    worst: Dict[str, float] = {}
    missing = [i for i in sample if i not in kept]
    ref = reference_outputs(ctx, [kept[i][0] for i in sample if i in kept])
    for i in sample:
        if i not in kept:
            continue
        seed, *outputs = kept[i]
        for k, v in gaps(tuple(outputs), ref[seed]).items():
            worst[k] = max(worst.get(k, 0.0), v if v == v else float("inf"))
    if missing or not worst:
        worst = {k: float("inf") for k in COMPARED}
    for k, v in worst.items():
        if k not in COMPARED:
            print(f"note {k}: {v!r} (not compared)", file=sys.stderr)
    return [(k, worst[k], limits.get(k)) for k in COMPARED]


def sample_of(ctx) -> List[int]:
    """The requests the check compares, drawn from the run's seed."""
    p = ctx.params
    rng = np.random.default_rng(_seeds(ctx.seed)["sample"])
    return sorted(rng.choice(p["check_within"], p["check_sample"], replace=False).tolist())


def setup(ctx) -> FidRunner:
    return FidRunner(ctx)
