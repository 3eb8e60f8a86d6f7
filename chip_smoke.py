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
   exact equality (it is a copy); then at the edges of its design
   (``K7_EDGES``): bf16 starts 8 bytes off the TMA's 16, any start, starts
   outside the texture clamped by the kernel (``validate=False``), one patch
   of a whole texture, a row of three TMA boxes, and the shapes that take the
   loop path (pitches that are not 16-byte multiples, a texture not on 16
   bytes), each on the path ``launch_geometry`` names.  (d) The texture-space adjoint, on the
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
   9 and 600 planes (checkpoints past one a chunk) on an odd pixel count.
   (f) The MPI skip stack's update (K9) alone at the shapes the main paths
   launch it with (``K9_SHAPES``: the last block of FFHQ256's and FFHQ1024's
   96-plane MPIs at batch 1, the raw 512^2 block cut into plane chunks, the
   first block with no stack, the train steps' last blocks at batch 8 and 4;
   bf16 RGB and alpha heads, a float32 background): each against its plain
   form (1e-6 of max(1, max|plain|)); the two serving last blocks also timed
   (one launch a pair and 10 queued) beside the plain form (the library
   chain it replaces), that chain's FIR alone and its byte bound;
3. serving main path — ``FakeImageGenerator`` at full FFHQ256 width with
   seeded random weights and the fused renderer: for 4 seeds, ``sample_mpi``
   then ``render`` of 4 views.  Kernel launch counts are reset just before and
   read just after; outputs must be finite, colors in [-1, 1], depths inside
   the plane range, and the last render must match the gather renderer.
   Then ``sample_mpi`` (on the card a replayed CUDA graph of the generator)
   against eager ``generate_mpi`` on the same seeds' z, in turns: host ms a
   request, launch calls a request (``torch.profiler``), ``SAMPLER_GRAPH``'s
   counts, and the MPIs within 1e-6 of max|eager|;
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
   that path's inputs (and in 13b at the 1024^2 route's): in fp32 and on a
   bf16 copy of the texture, one launch a pair and 10 queued, with the kernel
   path each took, beside its plain version, the advanced index and its
   bound; so is the tap sampler (K8), against its plain version (1e-4 of
   max), one launch a pair and 10 queued, beside its plain version, its byte
   bound and the tile-row step it replaced (K7 and the hat contractions
   against K7 and K8 on the same inputs);
6. banded serving path — ``FakeImageGenerator(use_fused=False)`` (on a card
   its patches come through the patch-gather kernel and its taps through the
   tap kernel) samples the last seed through a graph of its own (one
   capture, bitwise phase 3's MPI; its launch calls a request printed), then
   renders the 96-plane MPIs
   of phase 3's seeds, 4 views each, through
   ``render_mpi(tiled_bands=bands_for_config(...))``: all 384 textures in one
   call, in texture groups and tile-row steps that keep the live patches under
   ``renderer.TILED_STEP_BYTES``; then the last MPI through
   ``render_mpi_chunked`` in slabs of 24 planes, twice.  Launch counts are
   reset just before and read just after: one patch-gather and one
   tap-sampler launch per call of the tiled warp's tile-row step, nothing
   else.  Every render must match the gather
   renderer within 5e-4 and ``bands_cover`` must hold at the sampled poses.
   One render is profiled by the tiled warp's spans (patches, sample) beside
   the fused and gather renders of the same MPI;
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
   ``eval_gmpi_torch.main --task all`` (32 fakes, 8 consistency pairs, 8
   geometry images at 224^2, 96 planes, the banded renderer) twice, whose
   FID/KID, consistency and geometry numbers must be present, finite and
   equal; ``prepare_fake`` once more with ``--fused_renderer``, whose PNGs
   must be within 1 level of the banded run's.  Launch counts are reset
   before and read after each ``prepare_fake_images`` call: fused, one
   forward launch an image; banded, one patch-gather and one tap-sampler
   launch a tile-row step; nothing else.  The Inception features on the card against a CPU copy of
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
   marching tetrahedra's seconds and counts.  The temp dir is removed;
11. variants and checkpoints at full FFHQ256 width — (a) one generator per
   variant (``add_z``/``mlp``, ``normalize_add_z``/``conv_lrelu``,
   ``normalize_add_xyz``/``modulated_lrelu``, ``cat_xyz``/``mlp`` with the
   per-plane ``torgba`` head in plane chunks of 24, ``cond_z``/``mlp``,
   ``cond_xyz``/``conv_lrelu``, ``learnable_param`` trained at 32 and
   re-sampled to 96 planes, labels with ``c_dim`` 10): 96-plane MPIs of 2
   seeds, 4 views each through ``FakeImageGenerator(use_fused=True)``; (b)
   the vanilla and depth2alpha families at 32 fixed planes and
   ``toy_mpi.layered_scene`` at 96.  Each render call is counted alone (one
   K1 launch); K1 against its plain version on each stack (1e-4 absolute)
   and the render against the gather renderer (5e-4); ``sample_mpi`` ms,
   peak GB, K1 ms and its share of ``utils.roofline.render_cost``'s bound
   through ``attained``.  (c) The discriminator's ``orig`` and ``skip`` at
   256^2: scores on the card against a CPU copy (1e-4 of max|CPU|) and the
   R1 gradient d(sum D)/d(img) against the CPU copy taking the card's lrelu
   branches (1e-3 of max|CPU grad|; the disagreement with the CPU's own
   branches is printed), then 2 train steps each through
   ``make_train_step`` with that D in the state (per step 3 K1,
   ``batch_split`` K2 and K4).  (d) A TF-era StyleGAN2 pickle at NVIDIA's
   paper256 shapes with seeded values (``tools/tf_pickle.py``),
   ``convert_checkpoint_torch.main --which G_ema``, a warm start through
   ``train_gmpi_torch.main`` on phase 8's dataset whose mapping, trunk,
   ``torgb`` and noise must equal the table's arrays bitwise and whose MPI
   heads keep their initial values, then 2 warm-started steps (launches as
   phase 4's).  Prints the convert seconds, the ``.npz`` bytes and step ms;
12. bf16 textures and ranks at full FFHQ256 width — (a) K1's bf16-texture
   form against its bf16 plain version on the three stacks at the serving
   shapes (inference form) and the training shapes (training form with the
   residual and ``n_live``, and the D phase's inference form), and at phase
   2e's edges (the unaligned slab takes the kernel's texel-by-texel copy):
   1e-4 absolute; the bf16 render against the fp32 render of the same
   stacks within 2e-2 (the JAX package's gate); K1 fp32, bf16, bf16, fp32 in
   turns at the serving path's MPI, each with its bound (bf16: 2 bytes a
   texel); ``BF16_STEPS`` train steps with ``fused_compute_dtype="bf16"``
   (launches as phase 4's) beside phase 4's fp32 step and peak GB, then
   fp32 and bf16 steps in turns on two states from one seed, and the bf16
   route's ``rgba`` gradient against the fp32 route's (2e-2 of max|grad|).  (b) Ranks spawned as ``python3 chip_smoke.py --rank <job>
   <rank> <world> <dir>``, every one on ``cuda:0``: 2 ranks over gloo render
   plane-sharded (the fused slab kernel per rank), pipelined and
   tile-sharded (fused, and banded with K7 per shard) at 4 views x 96
   planes against the single process's render (5e-4) with the plane-sharded
   ``rgba`` gradient (1e-3 of max), then take ``RANK_STEPS``
   ``renderer_plane_shards=2`` train steps (step ms, peak GB, bytes handed to
   collectives a step, ``check_replica_consistency(atol=0)`` over the whole
   state after each); 4 ranks render plane x tile 2 x 2 (fused and banded)
   with the same gates; 2 ranks run ``train_gmpi_torch.main --multihost
   --device cuda:0`` (which picks gloo for ranks that share a card)
   data-parallel on a dataset like
   phase 8's (global batch 8, 4 a rank, 2 steps: disjoint shards, rank 0
   alone saves, equal replicas); one rank in an NCCL group renders through
   the same sharded calls with groups of one, so that NCCL gathers and
   reduces device tensors.  Any rank that fails fails the phase.  Two ranks
   on one card measure correctness and per-rank cost, not scaling;
13. the 1024^2 and 512^2 presets at full width — (a) every fused kernel
   against its plain version at 1024^2 (phase 2's gates) on the three
   stacks at the truncation corners of FFHQ1024 and of MetFaces, each with
   its own planes: K1 serving (one stack of 96 planes in 4 views, fp32 and
   bf16), and at 32 planes K1's training, D-phase, worst-view (V=16 in
   groups of 4) and bf16 training forms, the composite backward, the splat
   in both paths and the adjoint; (b) the counterpart of
   ``tests/test_tpu_full_scale.py``: uniform rgba of 96 planes at 1024^2 and
   a normal cotangent at the JAX bench pose and a +2 sigma corner, the fused
   renderer (5e-4 of max|oracle|; bf16 textures 2e-2) and the banded route
   through K7 and K8 (5e-4), forward and ``rgba`` gradient, against
   ``render_mpi_chunked(plane_chunk=4)``, and K7 and K8 at that route's
   inputs;
   (c) ``FakeImageGenerator`` at FFHQ1024: 2 seeds of 96-plane MPIs, 4 views
   each, one K1 a render call, the last render against the gather
   renderer, K1 timed at its inputs, and the sampler's graph against eager
   ``generate_mpi`` in turns as in phase 3; (d) ``make_train_step`` on the FFHQ1024
   preset (batch 4, ``batch_split`` 2, ``d_batch_split``, worst of 4 views
   at full resolution): 5 steps, one by phase and one past
   ``lighting_start_iter``, then 2 steps with each of ``fused_remat``,
   ``r1_remat``, ``worst_view_render_res=256``, bf16 textures and all four
   together; launches per run as ``step_launches`` works them out from the
   step's code, step ms (D / G) and peak GB per run, metrics finite, every
   parameter of G and D changed, one G micro-batch's ``rgba`` gradient
   against the gather renderer's (1e-3 of max), and the kernels timed at
   that micro-batch's inputs as in phase 5; (e) through the entry points:
   ``train_gmpi_torch.main --dataset FFHQ1024`` on 8 noise PNGs of 1024^2
   (2 steps, the checkpoint loaded back bitwise, resumed to 3),
   ``eval_gmpi_torch.main --task prepare_fake`` on it, banded and fused (4
   fakes; dumps at most 1 level apart, K7 exact and the banded render within
   5e-4 of the gather renderer on the banded run's own inputs), and
   ``train_gmpi_torch.main --dataset AFHQCat`` on a folder of 8 PNGs of
   512^2 with an EG3D ``dataset.json`` (2 steps), then 4 views of one of
   its MPIs through K1 against the gather renderer.  Only depth is cut
   (seeds, steps, images), and the phase prints its cuts;
14. the tile-banded route at full width — (a) ``bands_for_config`` of each
   of the five presets at its eval size (96 planes) planned on the card,
   twice, and on the host, each timed: the tuples must be equal, or the
   card's plan must cover; either way it must cover the spans measured on
   the card at the 9 corner poses and at 64 sampled poses; (b)
   ``train_gmpi_torch.main --no_fused_renderer`` on FFHQ256 and on FFHQ1024
   at the presets' settings from noise PNGs in a zip: 1 step, resumed to 2,
   each step's D and G phases timed and its peak memory read by span (D
   phase, G before worst views, worst views, G after them); launches reset
   before and read after: one patch gather and one tap sampler a tile-row
   step, nothing else; K7 equal to its plain version on the first inputs of each shape that the
   steps hand it (worst-view groups, D- and G-phase renders); metrics
   finite, every G and D parameter moved from the initial weights, a G
   micro-batch's ``rgba`` gradient through the step's banded render within
   1e-3 of max of the gather renderer's; (c) ``eval_gmpi_torch.main --task
   prepare_fake``, banded (eval's default), on the FFHQ1024 banded
   checkpoint and on the MetFaces checkpoint of (d), 4 fakes each: the
   planning timed on the card, one K7 and one K8 a tile-row step, one
   ``render.composite`` span a banded render call (under ``torch.profiler``),
   K7 equal to its plain version and the render within 5e-4 of the gather
   renderer on the run's own last inputs; then ``--task prepare_real`` of the
   training PNGs and ``--task fid_kid`` between them and the banded fakes
   (random Inception weights), finite; (d) ``train_gmpi_torch.main`` (fused) on
   FFHQ512 (a zip), AFHQCat (a folder of PNGs with an EG3D ``dataset.json``)
   and MetFaces (a folder of PNGs with a pose folder), 2 steps each:
   launches as ``step_launches`` works them out, step, D and G ms and peak
   GB by span; (e) as (c) on the FFHQ512 and AFHQCat checkpoints of (d) at
   512^2, banded and ``--fused_renderer`` (dumps at most 1 level apart, one
   K1 an image fused), with K7's and K8's device ms an image read by
   ``torch.profiler`` over the banded call, then ``fid_kid`` on the banded
   fakes.

Each phase prints its seconds.  The patch gather's launches are counted by
kernel path too, zeroed and read with each main path's launch counts: all of
the main paths' must take the TMA path (their shapes are all ones it takes).
Every launch count also expects one K9 launch a synthesis block that ran on
the card without autograd (``K9_BLOCKS``, counted by a wrapper of
``SynthesisBlock.forward``: the sampler's eager call and its capture, the
train step's D-phase fakes and worst views), and none under autograd.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import types

import torch

# fp32 operations per live (pixel, plane) pair: taps, lerps and composite;
# the recurrence of the backward; coordinates, weights and 16 products
FLOP_PER_PAIR = {"fused_fwd": 60, "composite_bwd": 25, "splat": 30, "adjoint": 30}
TOL = 1e-4
GRAD_REL = 1e-3
N_STEPS = (2, 3)  # warm-up, timed
N_DIRECT_STEPS = 4  # phase 8: steps timed outside the loop (the first warms up)


def log(*args):
    print(*args, flush=True)


def card_rates(chip):
    """``(bytes/s, fp32 FLOP/s)`` of a ``utils.roofline.ChipSpec``."""
    return chip.hbm_gbps * 1e9, chip.fp32_tflops * 1e12


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


def launch_calls(fn) -> int:
    """The kernel-launch calls ``fn()`` makes on the host, under
    ``torch.profiler`` (the calls ``benchmark.port_spans`` counts, a CUDA
    graph's launch among them)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.port_spans import LAUNCH_CALLS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)


SAMPLER_ROUNDS = 3  # rounds of graph, eager, eager, graph over the seeds
SAMPLER_GATE = 1e-6  # replayed against eager MPI, of max|eager|: the same kernels run


def sampler_graph_turns(gen, seeds, card, label):
    """``gen.sample_mpi`` (the generator's replayed CUDA graph) against eager
    ``generate_mpi`` on the same seeds' z, in turns (graph, eager, eager,
    graph a seed, ``SAMPLER_ROUNDS`` times): host ms a request after a
    synchronize, the launch calls of one request each way, and the largest
    gap of the two MPIs over max|eager| (gate ``SAMPLER_GATE``).  Prints
    ``SAMPLER_GRAPH``'s counts of these calls; returns the record."""
    from gmpi_tpu_torch.eval.generate import generate_mpi
    from gmpi_tpu_torch.eval.harness import SAMPLER_GRAPH

    @torch.no_grad()
    def eager(seed):
        z = torch.randn((1, gen.cfg.train.z_dim), generator=torch.Generator().manual_seed(seed))
        return generate_mpi(gen.G, z.to(gen.device), gen.xyz_dict, gen.n_planes,
                            chunk_n_planes=gen.chunk, truncation_psi=gen.psi, noise_mode="const")

    runs = {"graph": gen.sample_mpi, "eager": eager}
    before = SAMPLER_GRAPH.copy()
    ms = {"graph": [], "eager": []}
    err, equal = 0.0, True
    for _ in range(SAMPLER_ROUNDS):
        for seed in seeds:
            out = {}
            for route in ("graph", "eager", "eager", "graph"):
                out[route], t = host_ms(lambda: runs[route](seed))
                ms[route].append(t)
            err = max(err, float((out["graph"] - out["eager"]).abs().max()
                                 / out["eager"].abs().max()))
            equal = equal and torch.equal(out["graph"], out["eager"])
            del out
    launches = {route: launch_calls(lambda: run(seeds[0])) for route, run in runs.items()}
    counted = dict(SAMPLER_GRAPH - before)
    record = {"graph_ms": ms["graph"], "eager_ms": ms["eager"],
              "graph_ms_median": statistics.median(ms["graph"]),
              "eager_ms_median": statistics.median(ms["eager"]), "launch_calls": launches,
              "max_rel_gap": err, "bitwise_equal": equal, "sampler_graph": counted}
    log(f"{label} sampler, {len(seeds)} seeds x {SAMPLER_ROUNDS} rounds in turns: graph "
        f"{record['graph_ms_median']:.2f} ms, eager generate_mpi {record['eager_ms_median']:.2f} "
        f"ms a request (medians, host clock after a synchronize); launch calls a request: "
        f"graph {launches['graph']}, eager {launches['eager']}; SAMPLER_GRAPH {counted} over "
        f"these calls; replayed vs eager MPI: bitwise equal {equal}, max gap {err:.3e} of "
        f"max|eager| (gate {SAMPLER_GATE:g}) ({card})")
    if not err <= SAMPLER_GATE:  # also catches NaN
        raise RuntimeError(f"{label}: the replayed generator disagrees with eager generate_mpi")
    return record


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
        bands = fr.AdjointBands() if tweak == "nan" else fr.plan_adjoint(scal, rx, ry)
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


def backward_kernels_at(fr, mpi, dhw, rays, cot, adj_bands, rates, card, plain_iters=5):
    """Phase 5 (and 13a at 1024^2): at a G micro-batch's inputs (``mpi``
    rendered into ``rays = (ray_dir, eye, z_dir)`` with the color cotangent
    ``cot``), the forward's training form, the composite backward, the splat
    in both of its paths and the adjoint against their plain versions, then
    timed (CUDA events, one launch a pair with everything the wrapper
    launches; the backward kernels also 10 queued), each beside the bound of
    the bytes and operations these inputs need, and ``grid_sample``'s
    backward as the library yardstick of the splat and the adjoint.  Returns
    ``(errors by kernel, timings)``; raises on an error above ``TOL``."""
    from gmpi_tpu_torch.core.renderer import homography_grid

    ray_dir, eye, z_dir = rays
    bs, n_train, res = mpi.shape[0], mpi.shape[1], mpi.shape[-1]
    rx, ry, q, scal = fused_inputs(fr, dhw, ray_dir, eye, z_dir, res)
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
    errs = {"composite_bwd": rel_err(d_samp, d_samp_ref),
            "splat": worse(splat_errs["box"], splat_errs["direct"]),
            "adjoint": worse(rel_err(a_tex, a_tex_ref), rel_err(a_tex, d_tex))}
    del a_tex, a_tex_ref
    if not all(e <= TOL for e in errs.values()):  # also catches NaN
        raise RuntimeError(f"a backward kernel disagrees with its plain version on the main "
                           f"path's inputs: {errs}")
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
            iters=plain_iters, warmup=1)
        t_bwd = time_ms(lambda: fr.composite_bwd(warped, q, scal, cot, n_live=n_live,
                                                 grad_tau=fr.GRAD_TAU))
        t_bwd_queued = time_ms(lambda: fr.composite_bwd(warped, q, scal, cot, n_live=n_live,
                                                        grad_tau=fr.GRAD_TAU), queued=10)
        t_bwd_plain = time_ms(lambda: fr.composite_bwd_ref(warped, q, scal, cot, n_live=n_live,
                                                           grad_tau=fr.GRAD_TAU),
                              iters=plain_iters, warmup=1)
        # the splat's direct path at the same inputs (that of a box beyond its shared memory)
        splat_direct = lambda: fr._launch_splat(  # noqa: E731
            d_samp, rx, ry, scal, n_live, res, res, boxed=False)
        t_splat_direct = time_ms(splat_direct)
        t_splat_direct_queued = time_ms(splat_direct, queued=10)
        t_splat = time_ms(lambda: fr.warp_splat(d_samp, rx, ry, scal, res, res, n_live=n_live))
        t_splat_plain = time_ms(lambda: fr.warp_splat_ref(d_samp, rx, ry, scal, res, res,
                                                          n_live=n_live), iters=plain_iters, warmup=1)
        # the adjoint in turn with the splat: splat, adjoint, adjoint, splat
        t_adj = [time_ms(lambda: fr.warp_adjoint(d_samp, rx, ry, scal, adj_bands, res, res))
                 for _ in range(2)]
        t_splat_again = time_ms(lambda: fr.warp_splat(d_samp, rx, ry, scal, res, res,
                                                      n_live=n_live))
        t_adj_plain = time_ms(lambda: fr.warp_adjoint_ref(d_samp, rx, ry, scal, res, res),
                              iters=plain_iters, warmup=1)
        t_adj_queued = time_ms(lambda: fr.warp_adjoint(d_samp, rx, ry, scal, adj_bands, res, res),
                               queued=10)
        t_splat_queued = time_ms(lambda: fr.warp_splat(d_samp, rx, ry, scal, res, res,
                                                       n_live=n_live), queued=10)
    t_adj = min(t_adj)
    # one PyTorch call that computes the splat's and the adjoint's function:
    # grid_sample's backward (timed here as a yardstick, used nowhere in the port)
    per_plane = lambda x: x[:, None].expand(bs, n_train, *x.shape[1:]).reshape(  # noqa: E731
        bs * n_train, *x.shape[1:])
    grid, _ = homography_grid(dhw.repeat(bs, 1), per_plane(eye), per_plane(ray_dir),
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
    log(f"adjoint: {t_adj:.4f} ms with everything its wrapper "
        f"launches (the kernel alone: no op precedes it); the splat timed around it "
        f"{t_splat:.4f} / {t_splat_again:.4f} ms; 10 launches queued: adjoint "
        f"{t_adj_queued:.4f}, splat {t_splat_queued:.4f} a launch; plain {t_adj_plain:.3f} ms, "
        f"grid_sample "
        f"backward {t_splat_lib:.4f} ms, needs {work['adjoint']} B; bound "
        f"{bounds['adjoint'][0]:.5f} ms ({card})")
    del warped, d_samp
    torch.cuda.empty_cache()
    timings = dict(fwd_train=t_fwd_train, fwd_train_plain=t_fwd_train_plain, bwd=t_bwd,
                   bwd_queued=t_bwd_queued, bwd_plain=t_bwd_plain, splat=t_splat,
                   splat_queued=t_splat_queued, splat_plain=t_splat_plain,
                   splat_direct=t_splat_direct, splat_direct_queued=t_splat_direct_queued,
                   splat_again=t_splat_again, splat_lib=t_splat_lib, adj=t_adj,
                   adj_plain=t_adj_plain, adj_queued=t_adj_queued, splat_errs=splat_errs,
                   bounds=bounds, work=work, pairs=pairs, texels=texels)
    return errs, timings


def no_grad_forms_at(fr, mpi_d, rays_d, mpi_w, rays_w, rates, card, plain_iters=5):
    """The forward's two no-grad launches of a train step at a main path's
    inputs (phase 5, and 13a at 1024^2), as fused inputs ``(rx, ry, q,
    scal)``: the D phase's fakes (``mpi_d`` into ``rays_d``, a view each) and
    worst-view selection (each of ``mpi_w`` read by the group of its
    candidate views in ``rays_w``, as ``TrainStep.worst_views`` renders it;
    beside it the
    materialized repeat that this form read before stacks could be grouped),
    each against its plain version and timed beside its bound.  Returns
    ``(max abs error, timings)``."""
    n_train, res = mpi_w.shape[1], mpi_w.shape[-1]
    n_cand = rays_w[0].shape[0] // mpi_w.shape[0]
    no_grad_forms, err = {}, 0.0
    for form, tex, rays in (("d_phase_form", mpi_d, rays_d), ("worst_views_form", mpi_w, rays_w)):
        n_v = rays[0].shape[0]
        err = worse(err, check_inference_form(fr, f"main path's inputs, {form}, V={n_v}", tex,
                                              *rays, False))
        t_kernel = time_ms(lambda: fr.warp_composite_fwd(tex, *rays, with_disp=False))
        t_plain = time_ms(lambda: fr.warp_composite_fwd_ref(tex, *rays, with_disp=False),
                          iters=plain_iters, warmup=1)
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
    repeat = mpi_w.repeat_interleave(n_cand, dim=0)
    t_repeat = time_ms(lambda: fr.warp_composite_fwd(repeat, *rays_w, with_disp=False))
    log(f"fused_fwd worst_views_form on a materialized repeat of the stacks ({repeat.numel() * 4} "
        f"B): {t_repeat:.4f} ms ({card})")
    no_grad_forms["worst_views_form_repeat_ms"] = t_repeat
    del repeat
    torch.cuda.empty_cache()
    return err, no_grad_forms


def k7_path(pg, fn):
    """``(fn(), the kernel path of the one K7 launch fn makes)``."""
    before = dict(pg.PATH_LAUNCHES)
    out = fn()
    taken = [p for p in pg.PATH_LAUNCHES if pg.PATH_LAUNCHES[p] != before[p]]
    if len(taken) != 1 or sum(pg.PATH_LAUNCHES.values()) != sum(before.values()) + 1:
        raise RuntimeError(f"expected one patch_gather launch, paths {before} -> "
                           f"{pg.PATH_LAUNCHES}")
    return out, taken[0]


def patch_gather_at(pg, texf, offs, band_x, band_yc, rates, card, label):
    """The patch gather at a path's inputs (its last tile-row step's texture
    and offsets), in fp32 and on a bf16 copy of the texture: exactly its
    plain version, then timed (one launch per event pair with the wrapper's
    host work, and 10 queued) beside its plain version, one PyTorch call for
    the same copy (the advanced index alone, its indices made beforehand)
    and its byte bound: each texel that some patch covers read once (patches
    overlap), the offsets read and the patches written once.  Returns the
    fp32 timings, with the bf16 ones under ``"bf16"``; raises on a
    difference."""
    dev = texf.device
    n_idx = torch.arange(texf.shape[0], device=dev).reshape(-1, 1, 1, 1)
    rows_i = (offs[..., 0, None].long() + torch.arange(band_x, device=dev))[..., None]
    cols_i = (offs[..., 1, None].long() + torch.arange(band_yc, device=dev))[:, :, None, :]
    covered = torch.zeros(texf.shape, dtype=torch.bool, device=dev)
    covered[n_idx, rows_i, cols_i] = True
    n_covered = int(covered.sum())
    del covered
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        tex = texf if texf.dtype == dtype else texf.to(dtype)
        out, path = k7_path(pg, lambda: pg.gather_patches(tex, offs, band_x, band_yc))
        ref = pg.gather_patches_ref(tex, offs, band_x, band_yc)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise RuntimeError(f"patch_gather [{dtype}] disagrees with its plain version at "
                               f"{label}")
        run = lambda: pg.gather_patches(tex, offs, band_x, band_yc, validate=False)  # noqa: E731
        ms, queued_ms = time_ms(run), time_ms(run, queued=10)
        plain_ms = time_ms(lambda: pg.gather_patches_ref(tex, offs, band_x, band_yc))
        lib_ms = time_ms(lambda: tex[n_idx, rows_i, cols_i])
        n_bytes = (n_covered + out.numel()) * out.element_size() + offs.numel() * 4
        b = bound(n_bytes, 0, rates)
        name = str(dtype).split(".")[1]
        t = {"ms": ms, "queued_ms": queued_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "bound_ms": b[0], "bound_by": b[1], "bytes": n_bytes, "path": path,
             "geometry": pg.launch_geometry(tex.shape[2], band_x, band_yc,
                                            tex.element_size())._asdict()}
        log(f"patch_gather at {label} ({tuple(out.shape)} {name} from {tuple(tex.shape)}, "
            f"{path} path {tuple(t['geometry'].values())[1:]}): equal to its plain version; "
            f"{ms:.4f} ms, queued {queued_ms:.4f} ms, plain {plain_ms:.4f} ms, one advanced "
            f"index {lib_ms:.4f} ms, needs {n_bytes} B; bound {b[0]:.5f} ms "
            f"({b[0] / queued_ms:.0%} of it queued, {b[0] / ms:.0%} one launch a pair) ({card})")
        record[name] = t
        del tex, out, ref
    torch.cuda.empty_cache()
    return {**record.pop("float32"), **record}


def patch_sample_at(tw, gather_args, sample_args, rates, card, label):
    """The tap sampler (K8) at a path's inputs (its last tile-row step's
    patches, band starts and coordinates): against its plain version (1e-4 of
    max|plain| over the step's pixels), then timed (one launch per event pair
    with the wrapper's host work, and 10 queued) beside its plain version and
    its byte bound: the coordinates read, each tap texel that the step's
    pixels touch read once, the samples written.  The yardstick is the step
    it replaced: the tile-row step on the same inputs through K7 and the hat
    contractions, against K7 and K8, on as many of the step's textures as
    the contractions' step budget (``renderer.TILED_STEP_BYTES``) held.
    Returns the record; raises on a difference."""
    from gmpi_tpu_torch.core import renderer as renderer_mod
    from gmpi_tpu_torch.ops import patch_sample as ps

    texf, _, band_x, band_yc = gather_args
    pm, offs, fx, fy, pad, tile, out, first_tile = sample_args
    n, t = pm.shape[:2]
    c, ho, wo = out.shape[1:]
    band_y, (pad_y, pad_x) = band_yc // c, pad
    oy, ox = ps._tile_pixels(offs, ho, wo, tile, first_tile)
    rows, cols = oy[:, :, None], ox[:, None, :]
    buf = torch.zeros_like(out)  # the path's own output may be a view made under no_grad
    got = ps.sample_patches(pm, offs, fx, fy, pad, tile, torch.zeros_like(out), first_tile)
    ref = ps.sample_patches_ref(pm, offs, fx, fy, pad, tile, torch.zeros_like(out), first_tile)
    torch.cuda.synchronize()
    err = rel_err(got[:, :, rows, cols], ref[:, :, rows, cols])
    if not err <= TOL:  # also catches NaN
        raise RuntimeError(f"patch_sample disagrees with its plain version at {label}: {err}")

    # the tap texels the step's pixels touch, each counted once
    rx = fx[:, rows, cols] - (offs[..., 0].long() - pad_x)[..., None, None]
    ry = fy[:, rows, cols] - (offs[..., 1].long() // c - pad_y)[..., None, None]
    j0, i0 = torch.floor(rx).long(), torch.floor(ry).long()
    patch = torch.arange(n * t, device=pm.device).reshape(n, t, 1, 1)
    keys = []
    for dj in (0, 1):
        for di in (0, 1):
            j, i = j0 + dj, i0 + di
            inside = (j >= 0) & (j < band_x) & (i >= 0) & (i < band_y)
            keys.append(((patch * band_x + j) * band_y + i)[inside])
    n_taps = int(torch.unique(torch.cat(keys)).numel())
    pixels = n * t * tile[0] * tile[1]
    n_bytes = (n_taps * c + pixels * (2 + c)) * 4 + offs.numel() * 4
    del rx, ry, j0, i0, keys, got, ref
    b = bound(n_bytes, 0, rates)
    run = lambda: ps.sample_patches(pm, offs, fx, fy, pad, tile, buf, first_tile)  # noqa: E731
    ms, queued_ms = time_ms(run), time_ms(run, queued=10)
    plain_ms = time_ms(lambda: ps.sample_patches_ref(pm, offs, fx, fy, pad, tile, buf,
                                                     first_tile), iters=5, warmup=1)
    # the whole step each way, on the textures one step of the contractions held
    hats_row = 4 * tile[0] * wo * (band_x + band_y + band_y * c)
    k = max(1, min(n, renderer_mod.TILED_STEP_BYTES // (t // (wo // tile[1]) * hats_row)))
    h, w = texf.shape[2] // c - 2 * pad_y, texf.shape[1] - 2 * pad_x
    fx_k, fy_k = fx[:k, rows, cols], fy[:k, rows, cols]
    step = lambda into: tw._warp_row_tiles(  # noqa: E731
        texf[:k], fx_k, fy_k, band_y, band_x, pad_y, pad_x, h, w, c, None, into)
    with torch.no_grad():
        step_ms = time_ms(lambda: step((buf[:k], fx[:k], fy[:k], first_tile)), iters=5)
        hats_ms = time_ms(lambda: step(None), iters=5, warmup=1)
    log(f"patch_sample at {label} ({n} x {t} patches of {band_x} x {band_yc}, {pixels} "
        f"pixels of {c} channels, tile {tuple(tile)}): {err:.2e} of max from its plain "
        f"version; {ms:.4f} ms, queued {queued_ms:.4f} ms, plain {plain_ms:.3f} ms; needs "
        f"{n_bytes} B ({n_taps} tap texels); bound {b[0]:.5f} ms ({b[0] / queued_ms:.0%} of it "
        f"queued, {b[0] / ms:.0%} one launch a pair); the tile-row step on {k} textures: K7 "
        f"and K8 {step_ms:.3f} ms, the advanced index and the hat contractions {hats_ms:.3f} ms "
        f"({card})")
    torch.cuda.empty_cache()
    return {"ms": ms, "queued_ms": queued_ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "bytes": n_bytes, "tap_texels": n_taps, "max_rel_err": err,
            "step_textures": k, "step_ms": step_ms, "hats_step_ms": hats_ms}


# K9's shapes on the main paths: label -> (resolution, batch, planes, with an input
# stack, with the alpha head, final_act, timed).  Heads bf16 (float32 at the first
# block), a float32 background plane; a last block (final_act tanh) also sets the
# background alpha.  Timed: the last block of FFHQ256's and of FFHQ1024's 96-plane
# MPI at batch 1.  Compared only: the raw 512^2 block of a fused 1024^2 request
# (planes in chunks of 24), the first block (no stack), and the last blocks of the
# train steps' no-gradient G calls (FFHQ256: batch 8, AFHQCat 512^2: batch 4).
K9_SHAPES = {
    "serve256_last": (256, 1, 96, True, True, "tanh", True),
    "serve1024_last": (1024, 1, 96, True, False, "tanh", True),
    "serve512_raw": (512, 1, 96, True, False, None, False),
    "first_block": (4, 1, 96, False, True, None, False),
    "train256_last": (256, 8, 32, True, True, "tanh", False),
    "train512_last": (512, 4, 32, True, False, "tanh", False),
}


def mpi_stack_at(label, rates, card, dev):
    """K9 alone at one of ``K9_SHAPES``, on seeded inputs in the generator's
    dtypes: against its plain form (the library chain it replaces, fp32
    rounding: 1e-6 of max(1, max|plain|)); where the shape is timed, then
    timed (CUDA events, median of 20, one launch a pair, and 10 queued) beside
    its plain form, the FIR alone (``upsample2d``, the chain's cuDNN
    convolution) and its byte bound: the old stack and the heads read once,
    the new stack written once.  Returns the record; raises on a
    difference."""
    from gmpi_tpu_torch.ops import mpi_stack as ms
    from gmpi_tpu_torch.ops.upfirdn2d import setup_filter, upsample2d

    res, bs, n_planes, with_stack, with_alpha, final_act, timed = K9_SHAPES[label]
    heads = torch.bfloat16 if with_stack else torch.float32
    g = torch.Generator(device=dev).manual_seed(res + bs)
    stack = (torch.randn((bs, n_planes * 4, res // 2, res // 2), device=dev, generator=g)
             if with_stack else None)
    rgb = torch.randn((bs, 3, res, res), device=dev, generator=g).to(heads)
    background = torch.randn((bs, 3, res, res), device=dev, generator=g)
    alpha = (torch.randn((bs * n_planes, 1, res, res), device=dev, generator=g).to(heads)
             if with_alpha else None)
    f = torch.from_numpy(setup_filter([1, 3, 3, 1])).to(dev)
    args = (stack, rgb, background, alpha, f, n_planes, final_act, final_act is not None)
    what = (f"{res}^2, batch {bs}, {n_planes} planes ({'a' if with_stack else 'no'} stack, "
            f"{'with' if with_alpha else 'no'} alpha head, {final_act or 'raw'})")
    with torch.no_grad():
        before = ms.LAUNCHES["mpi_stack"]
        got = ms.mpi_stack(*args)
        torch.cuda.synchronize()
        if ms.LAUNCHES["mpi_stack"] != before + 1:
            raise RuntimeError(f"mpi_stack at {what} did not launch K9")
        ref = ms.mpi_stack_ref(*args)
        err = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        if not err <= 1e-6:  # also catches NaN
            raise RuntimeError(f"mpi_stack disagrees with its plain form at {what}: {err}")
        del got, ref
        record = {"max_rel_err": err}
        if timed:
            n_bytes = bs * n_planes * 4 * res * res * 4 + sum(
                t.numel() * t.element_size() for t in (stack, rgb, background, alpha)
                if t is not None)
            b = bound(n_bytes, 0, rates)
            kernel_ms, queued_ms = time_ms(lambda: ms.mpi_stack(*args)), time_ms(
                lambda: ms.mpi_stack(*args), queued=10)
            plain_ms = time_ms(lambda: ms.mpi_stack_ref(*args), warmup=1)
            fir_ms = time_ms(lambda: upsample2d(stack, f), warmup=1)
            record.update(ms=kernel_ms, queued_ms=queued_ms, plain_ms=plain_ms, fir_ms=fir_ms,
                          bound_ms=b[0], bound_by=b[1], bytes=n_bytes)
    if timed:
        log(f"mpi_stack (K9) at {what}: {err:.2e} of max from its plain form; {kernel_ms:.4f} "
            f"ms, queued {queued_ms:.4f} ms; plain form (the library chain it replaces) "
            f"{plain_ms:.4f} ms, its FIR alone {fir_ms:.4f} ms; needs {n_bytes} B, bound "
            f"{b[0]:.5f} ms ({b[0] / kernel_ms:.0%} of it one launch a pair, "
            f"{b[0] / queued_ms:.0%} queued) ({card})")
    else:
        log(f"mpi_stack (K9) at {what}: {err:.2e} of max from its plain form ({card})")
    torch.cuda.empty_cache()
    return record


# K7 at the edges of its design: (label, n, t, wp, hpc, band_x, band_yc, dtype, start step in
# elements, tweak).  Starts are drawn on the step; a start 4 elements past 8 is a bf16 start
# 8 bytes off the TMA's 16; "clamp" hands starts outside the texture with validate=False.
K7_EDGES = (
    ("bf16, starts 8 bytes off 16", 3, 7, 90, 1200, 30, 416, "bfloat16", 4, "odd"),
    ("f32, any start", 3, 17, 72, 640, 24, 128, "float32", 1, None),
    ("bf16, any start", 3, 7, 90, 1200, 30, 416, "bfloat16", 1, None),
    ("f32, starts to clamp", 3, 9, 80, 800, 33, 300, "float32", 1, "clamp"),
    ("bf16, starts to clamp", 3, 9, 80, 800, 33, 304, "bfloat16", 4, "clamp"),
    ("one patch, the whole texture", 1, 1, 50, 520, 50, 520, "float32", 1, None),
    ("a row of three TMA boxes", 2, 5, 100, 1200, 37, 600, "float32", 4, None),
    ("loop: f32 odd pitch", 3, 17, 37, 91, 7, 13, "float32", 1, None),
    ("loop: bf16 odd padded height", 3, 9, 60, 4 * 35, 21, 4 * 12, "bfloat16", 4, None),
    ("loop: bf16 odd band", 2, 9, 80, 800, 33, 4 * 51, "bfloat16", 4, None),
    ("loop: texture not on 16 bytes", 2, 5, 60, 512, 20, 256, "float32", 1, "unaligned"),
)


def patch_gather_edges(pg, dev, g):
    """Phase 2c's edge cases of K7 (``K7_EDGES``): each held bitwise against
    its plain version (on the clamped starts where they are out of range),
    with the path it took, which must be the one ``launch_geometry`` names
    (the loop for the ``loop:`` cases).  Returns ``{label: path}``."""
    paths = {}
    for label, n, t, wp, hpc, band_x, band_yc, dtype, step, tweak in K7_EDGES:
        dtype = getattr(torch, dtype)
        size = n * wp * hpc
        flat = torch.randn((size + 1,), device=dev, generator=g).to(dtype)
        texf = (flat[1:] if tweak == "unaligned" else flat[:size]).view(n, wp, hpc)
        offs = torch.stack([
            torch.randint(0, wp - band_x + 1, (n, t), device=dev, generator=g),
            torch.randint(0, (hpc - band_yc) // step + 1, (n, t), device=dev, generator=g) * step],
            dim=-1).to(torch.int32)
        if tweak == "odd":  # every start 4 elements past a multiple of 8
            offs[..., 1] = (offs[..., 1] // 8 * 8 + 4).clamp(max=hpc - band_yc)
        offs[0, 0] = 0
        offs[-1, -1] = torch.tensor([wp - band_x, (hpc - band_yc) // step * step], device=dev)
        want = offs.clone()
        if tweak == "clamp":
            offs[0, 1] = torch.tensor([wp + 5, -7], device=dev)
            offs[-1, 0] = torch.tensor([-100, hpc], device=dev)
            want[..., 0] = offs[..., 0].clamp(0, wp - band_x)
            want[..., 1] = offs[..., 1].clamp(0, hpc - band_yc)
        out, path = k7_path(pg, lambda: pg.gather_patches(texf, offs, band_x, band_yc,
                                                          validate=tweak != "clamp"))
        named = pg.launch_geometry(hpc, band_x, band_yc, texf.element_size(),
                                   base_aligned=texf.data_ptr() % 16 == 0)
        equal = torch.equal(out, pg.gather_patches_ref(texf, want, band_x, band_yc))
        log(f"patch_gather edge [{label}: {n} x {t} patches of {band_x} x {band_yc} from "
            f"{(n, wp, hpc)} {str(dtype).split('.')[1]}]: {path} path {tuple(named)[1:]}, "
            f"equal {equal}")
        if not equal:
            raise RuntimeError(f"patch_gather disagrees with its plain version at [{label}]")
        if path != named.path or (path == "loop") != label.startswith("loop"):
            raise RuntimeError(f"patch_gather [{label}] took the {path} path, not {named.path}")
        paths[label] = path
        del flat, texf, out
    return paths


class Counts(dict):
    """Launches by kernel since ``reset_counts`` (a dict: compared with and
    built from plain ones), with K7's launches by kernel path read at the
    same point, ``k7_paths``, and the synthesis blocks that should each have
    launched K9, ``k9_blocks`` (``K9_BLOCKS``).  ``a + b`` adds all three."""

    def __init__(self, launches, k7_paths, k9_blocks=0):
        super().__init__(launches)
        self.k7_paths = dict(k7_paths)
        self.k9_blocks = k9_blocks

    def __add__(self, other):
        return Counts({k: n + other[k] for k, n in self.items()},
                      {p: n + other.k7_paths[p] for p, n in self.k7_paths.items()},
                      self.k9_blocks + other.k9_blocks)


# synthesis blocks run on the card with the shared-RGB head and nothing recorded
# by autograd since ``reset_counts`` (counted by ``count_k9_blocks``' wrapper): the
# blocks whose MPI stack K9 must update, one launch each
K9_BLOCKS = {"n": 0}


def count_k9_blocks():
    """Wrap ``SynthesisBlock.forward`` to count ``K9_BLOCKS``: a block on the
    card with the ``only_alpha`` heads whose new stack needs no gradient."""
    from gmpi_tpu_torch.models import generator as gen_mod

    forward = gen_mod.SynthesisBlock.forward
    if getattr(forward, "counts_k9", False):
        return

    def counted(self, x, img, block_ws, *args, **kw):
        out = forward(self, x, img, block_ws, *args, **kw)
        if block_ws.is_cuda and self.cfg.only_alpha and not out[1].requires_grad:
            K9_BLOCKS["n"] += 1
        return out

    counted.counts_k9 = True
    gen_mod.SynthesisBlock.forward = counted


def reset_counts(fr):
    """Zero the launch counts by kernel, K7's by kernel path and ``K9_BLOCKS``."""
    from gmpi_tpu_torch.ops import patch_gather as pg

    for table in (fr.LAUNCHES, pg.PATH_LAUNCHES):
        for key in table:
            table[key] = 0
    K9_BLOCKS["n"] = 0


def read_counts(fr) -> Counts:
    """The launches since ``reset_counts``, by kernel and K7's by path, and
    the blocks that should have launched K9."""
    from gmpi_tpu_torch.ops import patch_gather as pg

    return Counts(fr.LAUNCHES, pg.PATH_LAUNCHES, K9_BLOCKS["n"])


def no_counts(fr) -> Counts:
    """Counts of no launch, to add to."""
    from gmpi_tpu_torch.ops import patch_gather as pg

    return Counts(dict.fromkeys(fr.LAUNCHES, 0), dict.fromkeys(pg.PATH_LAUNCHES, 0))


def generator_only(counts: Counts) -> dict:
    """What ``counts`` must read where no renderer kernel ran: one K9 launch
    a synthesis block that ran without autograd, nothing else."""
    return {**dict.fromkeys(counts, 0), "mpi_stack": counts.k9_blocks}


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
        launches = read_counts(fr)
        decodes = {k: ds_mod.DECODES[k] - decodes0[k] for k in decodes0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n_steps = sum(len(st.step_ms) for _, st, _ in runs)
    n_snaps = sum(len(st.snapshot_steps) for _, st, _ in runs)
    renders = 2 * 3 * 4  # a snapshot: EMA and raw weights x 3 view rows x 4 images
    all_steps = n_steps + N_DIRECT_STEPS
    expected = {**generator_only(launches), "fused_fwd": 3 * all_steps + renders * n_snaps,
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
EVAL_FAKES = 32  # the JAX CLI's default is 2048; this depth keeps the script near 10 min
EVAL_PAIRS = 8  # consistency pairs and geometry images; the default is 1024
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
                      "n_imgs": n_imgs, "launches": read_counts(fr),
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

    # launches by task: fused, one K1 a render call; banded, one K7 and one K8 a tile-row step
    by_task = {}
    for t in tasks:
        renders = t["n_imgs"]  # one render call an image (its views in one call)
        want = generator_only(t["launches"])
        if t["fused"]:
            want["fused_fwd"] = renders
        else:
            want["patch_gather"] = want["patch_sample"] = t["row_steps"]
        label = f"{t['task']} {t['size']}^2 {'fused' if t['fused'] else 'banded'}"  # label_of
        log(f"prepare_fake_images [{label}]: {t['n_imgs']} images in {t['seconds']:.2f} s, "
            f"{t['n_imgs'] / t['seconds']:.2f} images/s; {t['row_steps']} tile-row steps, "
            f"launches {t['launches']} ({card})")
        if t["launches"] != want or (not t["fused"] and t["row_steps"] == 0):
            raise RuntimeError(f"prepare_fake_images [{label}] launched {t['launches']}, "
                               f"expected {want}")
        by_task.setdefault(label, []).append(t)
    launches = sum((t["launches"] for t in tasks), no_counts(fr))
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
    train_launches = read_counts(fr)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        fids = [json.loads(line)["fid"] for line in f if '"fid"' in line]
    split = cfg.hparams.batch_split
    want = {**generator_only(train_launches), "composite_bwd": 2 * split, "splat": 2 * split,
            "fused_fwd": 2 * 3 + -(-fid_n_imgs // 8)}  # 3 a step; the FID's renders of 8
    log(f"in-training FID (train_gmpi_torch.main, 2 steps, --fid_interval 1 --fid_n_imgs "
        f"{fid_n_imgs}): logged {fids}, {fid_s_train[0] / 1e3:.2f} s for one; launches "
        f"{train_launches} ({card})")
    if len(fids) != 1 or not np.isfinite(fids[0]):
        raise RuntimeError(f"the in-training FID logged {fids}")
    if train_launches != want:
        raise RuntimeError(f"the train CLI with the FID launched {train_launches}, "
                           f"expected {want}")
    launches += train_launches

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
    launches = read_counts(fr)
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
    if launches != generator_only(launches):
        raise RuntimeError(f"the video path launched {launches}; it renders by the gather")
    return {"launches": launches, "frame_ms_median": statistics.median(frame_ms),
            "marching_tetrahedra_s": mt_ms[0] / 1e3, "verts": n_v, "faces": n_f,
            "videos": videos, "seconds": total_s}

# phase 11: depth of the variants and checkpoints run (widths stay FFHQ256's)
VARIANT_SEEDS = (0, 1)
VARIANT_VIEWS = 4
VARIANT_CHUNK = 24  # plane chunk of generate_mpi for the per-plane RGBA head
VANILLA_PLANES = 32
D_BATCH = 4
D_STEPS = 2  # train steps with each D architecture
WARM_STEPS = 2
LABELS = 10  # c_dim of the label-conditioned generator
VARIANTS = (  # label, ModelPreset fields, extra inputs
    ("add_z/mlp", dict(cond_mode="add_z", embed_func="mlp"), None),
    ("normalize_add_z/conv_lrelu", dict(cond_mode="normalize_add_z", embed_func="conv_lrelu"),
     None),
    ("normalize_add_xyz/modulated_lrelu", dict(cond_mode="normalize_add_xyz",
                                               embed_func="modulated_lrelu"), None),
    ("cat_xyz/mlp/torgba", dict(cond_mode="cat_xyz", embed_func="mlp", only_alpha=False,
                                sep_background=False), None),
    ("cond_z/mlp", dict(cond_mode="cond_z", embed_func="mlp"), None),
    ("cond_xyz/conv_lrelu", dict(cond_mode="cond_xyz", embed_func="conv_lrelu"), None),
    ("learnable_param/32->96", dict(embed_func="learnable_param"), "z_interpolation_ws"),
    (f"c_dim={LABELS}", {}, "label"),
)


def variants_phase(fr, cfg, card, chip, dev):
    """Phase 11: the generator variants, the vanilla and depth2alpha families,
    a toy scene, the discriminator's ``orig`` and ``skip`` architectures, and
    a warm start from a converted TF-era StyleGAN2 pickle, all at full
    FFHQ256 width.  Returns ``(record, K1's largest error against its plain
    version)``; raises on a failed check."""
    import copy
    import os
    import shutil
    import tempfile

    import numpy as np

    import convert_checkpoint_torch
    import train_gmpi_torch
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.geometry import plane_interp_weights
    from gmpi_tpu_torch.core.renderer import render_mpi
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.models import legacy_tf
    from gmpi_tpu_torch.models.discriminator import Discriminator
    from gmpi_tpu_torch.models.generator import Generator
    from gmpi_tpu_torch.models.generator_vanilla import VanillaGenerator, VanillaGeneratorCfg
    from gmpi_tpu_torch.ops import bias_act as bias_act_mod
    from gmpi_tpu_torch.tools.tf_pickle import (tf_discriminator_vars, tf_generator_vars,
                                                write_tf_pickle)
    from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step
    from gmpi_tpu_torch.train.loop import LoopStats
    from gmpi_tpu_torch.train.step import make_optimizers
    from gmpi_tpu_torch.utils.roofline import attained, render_cost
    from gmpi_tpu_torch.utils.toy_mpi import layered_scene

    res, n_views = cfg.resolution, VARIANT_VIEWS
    launches = {"renders": no_counts(fr), "d_steps": no_counts(fr), "warm_steps": no_counts(fr)}
    k1_err = 0.0
    record = {"renders": {}}

    def render_case(label, fake, sample):
        """Two seeds: ``sample(seed)`` -> an MPI, 4 views through
        ``fake.render`` (one K1 launch each, counted), K1 against its plain
        version and the render against the gather renderer on those inputs."""
        nonlocal k1_err
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the phases before, and the generator
        sample_ms, render_ms, e_k1, e_gather = [], [], 0.0, 0.0
        lo, hi = cfg.planes.min_d * 0.9, cfg.planes.max_d * 1.4
        for seed in VARIANT_SEEDS:
            mpi, ms = host_ms(lambda: sample(seed))
            sample_ms.append(ms)
            n_pl = mpi.shape[1]
            if (mpi.shape != (1, n_pl, 4, res, res) or not torch.isfinite(mpi).all()
                    or mpi.min() < 0 or mpi.max() > 1):
                raise RuntimeError(f"{label}, seed {seed}: bad MPI {tuple(mpi.shape)}")
            yv, pv = fake.sample_views(seed, n_views)
            mpi_v = mpi.expand(n_views, -1, -1, -1, -1)
            reset_counts(fr)
            (color, depth), ms = host_ms(lambda: fake.render(mpi_v, yv, pv))
            counts = read_counts(fr)
            if counts != {**generator_only(counts), "fused_fwd": 1}:
                raise RuntimeError(f"{label}: a render launched {counts}, expected one K1")
            launches["renders"] += counts
            render_ms.append(ms)
            # colours in [-1, 1] up to fp32 rounding (a saturated tanh gives
            # RGB exactly 1); depths in the plane range where the last plane is
            # opaque (a chunked stack without a background plane need not be)
            opaque = bool((mpi[:, -1, 3] == 1).all())
            ranges = [float(x) for x in (color.min(), color.max(), depth.min(), depth.max())]
            if not (torch.isfinite(color).all() and torch.isfinite(depth).all()
                    and ranges[0] >= -1.0 - 1e-6 and ranges[1] <= 1.0 + 1e-6
                    and (not opaque or (ranges[2] >= lo and ranges[3] <= hi))):
                raise RuntimeError(f"{label}, seed {seed}: color {ranges[:2]}, depth "
                                   f"{ranges[2:]} (last plane opaque: {opaque}) out of range")
            c2w, _, _ = poses.sample_sphere_poses(None, n_views, cfg.camera, given_yaws=yv,
                                                  given_pitches=pv, device=dev)
            rays = cam.generate_rays(fake.intr, c2w)
            rx, ry, q, scal = fused_inputs(fr, fake.geom.dhw, *rays, res)
            out = fr.warp_composite_fwd(mpi_v, rx, ry, q, scal)
            ref = fr.warp_composite_fwd_ref(mpi_v, rx, ry, q, scal)
            e_k1 = worse(e_k1, max(float((a - b).abs().max()) for a, b in zip(out, ref)))
            with torch.no_grad():
                gather = render_mpi(mpi_v, fake.geom.dhw, *rays)
            e_gather = worse(e_gather, max(float((color - (gather.color * 2 - 1)).abs().max()),
                                           float((depth - gather.depth).abs().max())))
            del out, ref, gather
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        t_k1 = time_ms(lambda: fr.warp_composite_fwd(mpi_v, rx, ry, q, scal))
        # the least bytes of one stack read once for its views (the JAX model's
        # patch_overread of 1/views) and its 4 images written
        share = attained(t_k1 / 1e3, render_cost(n_views, n_pl, res, res, res, res,
                                                 patch_overread=1.0 / n_views), chip)
        log(f"[{label}] {n_pl} planes: sample ms {['%.1f' % x for x in sample_ms]}, render ms "
            f"{['%.2f' % x for x in render_ms]}, peak {peak_gb:.2f} GB above the {held / 1e9:.2f} "
            f"held before; K1 vs plain {e_k1:.3e} "
            f"(gate {TOL}), render vs gather {e_gather:.3e} (gate 5e-4); K1 {t_k1:.4f} ms, "
            f"{share['sol_fraction']:.1%} of the render_cost {share['bound']} bound "
            f"{share['speed_of_light_s'] * 1e3:.5f} ms ({card})")
        if not (e_k1 <= TOL and e_gather <= 5e-4):  # also catches NaN
            raise RuntimeError(f"{label}: K1 or the render disagrees")
        k1_err = worse(k1_err, e_k1)
        record["renders"][label] = {
            "planes": n_pl, "sample_ms": sample_ms, "render_ms": render_ms, "peak_gb": peak_gb,
            "held_gb": held / 1e9,
            "k1_err": e_k1, "gather_err": e_gather, "k1_ms": t_k1,
            "k1_bound_ms": share["speed_of_light_s"] * 1e3, "k1_share": share["sol_fraction"]}

    # -- 11a. generator variants, 96 planes --------------------------------------
    for i, (label, model_kw, extra) in enumerate(VARIANTS):
        cfg_v = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_kw))
        gen_cfg = cfg_v.generator_cfg()
        if extra == "label":
            gen_cfg = dataclasses.replace(gen_cfg, c_dim=LABELS)
        t0 = time.perf_counter()
        g_v = Generator(gen_cfg, generator=torch.Generator().manual_seed(100 + i))
        chunk = VARIANT_CHUNK if not model_kw.get("only_alpha", True) else -1
        fake = FakeImageGenerator(cfg_v, g_v, chunk_n_planes=chunk, use_fused=True, device=dev)
        log(f"[{label}] generator built in {time.perf_counter() - t0:.1f} s "
            f"({sum(p.numel() for p in g_v.parameters())} params), plane chunk {chunk}")
        if extra is None:
            sample = fake.sample_mpi
        else:
            ws = c = None
            if extra == "z_interpolation_ws":  # tokens of 32 training planes -> 96
                ws = plane_interp_weights(cfg.planes.min_d, cfg.planes.max_d,
                                          gen_cfg.synthesis.n_planes_train, fake.n_planes,
                                          device=dev)
            else:
                c = torch.nn.functional.one_hot(torch.tensor([3]), LABELS).float().to(dev)

            @torch.no_grad()
            def sample(seed, ws=ws, c=c, g_v=g_v, fake=fake):
                z = torch.randn((1, cfg.train.z_dim), generator=torch.Generator().manual_seed(seed))
                return g_v(z.to(dev), c, fake.xyz_dict, fake.n_planes, noise_mode="const",
                           z_interpolation_ws=ws)
        render_case(label, fake, sample)
        del g_v, fake, sample

    # -- 11b. vanilla and depth2alpha at 32 fixed planes; a toy scene at 96 ---------
    gen_cfg = cfg.generator_cfg()
    syn = gen_cfg.synthesis
    for head in ("vanilla", "depth2alpha"):
        v_cfg = VanillaGeneratorCfg(
            z_dim=gen_cfg.z_dim, w_dim=gen_cfg.w_dim, img_resolution=res,
            n_planes=VANILLA_PLANES, head_type=head, channel_base=syn.channel_base,
            channel_max=syn.channel_max, num_bf16_res=syn.num_bf16_res,
            conv_clamp=syn.conv_clamp, background_alpha_full=True)
        g_v = VanillaGenerator(v_cfg, generator=torch.Generator().manual_seed(200))
        fake = FakeImageGenerator(cfg, g_v, n_planes=VANILLA_PLANES, use_fused=True, device=dev)
        render_case(head, fake, fake.sample_mpi)
        del g_v, fake
    fake = FakeImageGenerator(cfg, Generator(gen_cfg), use_fused=True, device=dev)
    scene = torch.from_numpy(layered_scene(cfg.eval_n_planes, res, seed=0))[None].to(dev)
    render_case("toy_mpi.layered_scene", fake, lambda seed: scene)
    del fake, scene
    torch.cuda.empty_cache()

    # -- 11c. discriminator architectures ------------------------------------------------
    data = torch.Generator().manual_seed(21)
    imgs = torch.rand((D_BATCH, 3, res, res), generator=data) * 2.0 - 1.0
    pose = torch.randn((D_BATCH, cfg.train.d_cond_pose_dim), generator=data)
    bs = cfg.hparams.batch_size
    real = (torch.rand((bs, 3, res, res), generator=data) * 2.0 - 1.0).to(dev)
    real_c2w, _, _ = poses.sample_sphere_poses(data, bs, cfg.camera, device=dev)
    real_pose = flat_pose_from_c2w(real_c2w, cfg.train.d_cond_pose_dim)
    record["discriminators"] = {}

    def score_and_r1_grad(d, device, branches=None):
        """``(scores, d(sum D)/d(img), the branch every lrelu took)``, each
        lrelu taking the branches given (a list in call order) if any."""
        taken, replay = [], iter(branches or ())

        def lrelu(x, alpha):
            pos = next(replay).to(x.device) if branches is not None else x > 0
            taken.append(pos.cpu())
            return torch.where(pos, x, x * alpha)

        spec = bias_act_mod.activation_funcs["lrelu"]
        bias_act_mod.activation_funcs["lrelu"] = spec._replace(fn=lrelu)
        try:
            x = imgs.to(device).requires_grad_()
            s = d(x, pose.to(device))
            (g,) = torch.autograd.grad(s.sum(), x)
        finally:
            bias_act_mod.activation_funcs["lrelu"] = spec
        return s.detach().cpu(), g.cpu(), taken

    for arch in ("orig", "skip"):
        d_cfg = dataclasses.replace(cfg.discriminator_cfg(), architecture=arch)
        # fp32 blocks for the card-vs-CPU comparison: bf16 rounds the two
        # devices' different summation orders apart by a bf16 ulp
        d_cpu = Discriminator(dataclasses.replace(d_cfg, num_bf16_res=0),
                              generator=torch.Generator().manual_seed(31))
        d_gpu = copy.deepcopy(d_cpu).to(dev)
        (s_gpu, g_gpu, m_gpu), gpu_ms = host_ms(lambda: score_and_r1_grad(d_gpu, dev))
        t0 = time.perf_counter()
        s_cpu, g_cpu, m_cpu = score_and_r1_grad(d_cpu, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        # the R1 gradient is piecewise linear in each lrelu: an activation within
        # fp32 rounding of zero may take the other branch on the other device and
        # move the input gradient under its receptive field by ~1e-2 of its max.
        # So the gradient is held against the CPU copy taking the card's branches
        _, g_cpu_same, _ = score_and_r1_grad(d_cpu, torch.device("cpu"), branches=m_gpu)
        flips = sum(int((a != b).sum()) for a, b in zip(m_gpu, m_cpu))
        n_act = sum(m.numel() for m in m_gpu)
        e_s, e_g = rel_err(s_gpu, s_cpu), rel_err(g_gpu, g_cpu_same)
        e_g_own = rel_err(g_gpu, g_cpu)
        e_g_l2 = float((g_gpu - g_cpu).norm() / g_cpu.norm())
        # one train step with a D of this architecture (bf16 top blocks as the
        # preset's): make_train_step reads D from the state
        state = init_train_state(cfg, torch.Generator().manual_seed(32), device=dev)
        state.D = Discriminator(d_cfg, generator=torch.Generator().manual_seed(33)).to(dev)
        state.opt_g, state.opt_d = make_optimizers(cfg, state.G, state.D)
        step = make_train_step(cfg, device=dev)
        rng = torch.Generator().manual_seed(34)
        reset_counts(fr)
        step_ms, all_vals = [], []
        for _ in range(D_STEPS):  # the first meets this D's shapes in cuDNN first
            (_, metrics), ms = host_ms(lambda: step(state, real, real_pose, rng))
            step_ms.append(ms)
            all_vals.append({k: float(v) for k, v in metrics.items()})
        counts = read_counts(fr)
        split = cfg.hparams.batch_split
        want = {**generator_only(counts), "fused_fwd": 3 * D_STEPS,
                "composite_bwd": split * D_STEPS,
                "splat": split * D_STEPS}
        vals = all_vals[-1]
        log(f"[D {arch}] {sum(p.numel() for p in d_gpu.parameters())} params, batch {D_BATCH} "
            f"at {res}^2: score {e_s:.3e} of max|CPU| (gate 1e-4), R1 gradient {e_g:.3e} of "
            f"max|CPU grad| with the card's lrelu branches (gate {GRAD_REL}); with the CPU's own "
            f"branches {e_g_own:.3e} of max, {e_g_l2:.3e} in L2 norm, {flips} of {n_act} "
            f"activations on the other branch; card {gpu_ms:.1f} ms, CPU {cpu_s:.1f} s; train "
            f"steps ms {['%.1f' % x for x in step_ms]}, launches {counts}, last metrics "
            + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()) + f" ({card})")
        if not (e_s <= 1e-4 and e_g <= GRAD_REL):
            raise RuntimeError(f"D {arch}: the card disagrees with the CPU")
        if counts != want:
            raise RuntimeError(f"D {arch}: the step launched {counts}, expected {want}")
        for v in all_vals:
            if not all(x == x and abs(x) != float("inf") for x in v.values()) or not v["r1"] > 0:
                raise RuntimeError(f"D {arch}: bad metrics {v}")
        launches["d_steps"] += counts
        record["discriminators"][arch] = {
            "score_err": e_s, "r1_grad_err": e_g, "r1_grad_err_own_branches": e_g_own,
            "r1_grad_l2_err_own_branches": e_g_l2, "branch_flips": flips, "activations": n_act,
            "fwd_r1_ms": gpu_ms, "step_ms": step_ms}
        del state, step, d_cpu, d_gpu
        torch.cuda.empty_cache()
    del real, real_pose

    # -- 11d. TF-era StyleGAN2 pickle -> .npz -> warm-started training ----------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        paper256 = dict(resolution=res, channel_base=syn.channel_base,
                        channel_max=syn.channel_max)
        g_vars = tf_generator_vars(z_dim=gen_cfg.z_dim, w_dim=gen_cfg.w_dim,
                                   mapping_layers=gen_cfg.mapping_num_layers, seed=41, **paper256)
        pkl, npz = os.path.join(tmp, "stylegan2-paper256.pkl"), os.path.join(tmp, "g.npz")
        write_tf_pickle(pkl, g_vars, tf_discriminator_vars(seed=42, **paper256), res)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_checkpoint_torch.main(["--src", pkl, "--out", npz, "--which", "G_ema"])
        convert_s = time.perf_counter() - t0
        table = legacy_tf.convert_tf_generator_params(g_vars, res)
        zpath, pose_dir = write_ffhq_dataset(tmp, 20, res, seed=8)  # phase 8's dataset
        seed = 5
        args = ["--dataset", "FFHQ256", "--data_root", zpath, "--pose_root", pose_dir,
                "--seed", str(seed), "--warm_start", npz, "--no_resume"]
        warm = train_gmpi_torch.main(args + ["--output_dir", os.path.join(tmp, "w0"),
                                             "--total_iters", "0"])
        init = Generator(gen_cfg, generator=torch.Generator().manual_seed(seed)).state_dict()
        own = warm.G.state_dict()
        from_file = [k for k in own if k in table]
        heads = [k for k in own if k not in table]
        file_ok = all(torch.equal(own[k].cpu(), torch.from_numpy(np.array(table[k])))
                      for k in from_file)
        heads_ok = all(torch.equal(own[k].cpu(), init[k]) for k in heads)
        head_kinds = sorted({k.split(".")[2] for k in heads})
        log(f"TF-era pickle at paper256 shapes ({len(g_vars)} G variables, "
            f"{os.path.getsize(pkl)} B) written in {write_s:.1f} s; convert_checkpoint_torch "
            f"--which G_ema {convert_s:.2f} s -> {os.path.getsize(npz)} B of .npz, {len(table)} "
            f"tensors; warm start before the first step: {len(from_file)} mapping/trunk/torgb/"
            f"noise tensors bitwise the table's {file_ok}, {len(heads)} head tensors "
            f"({head_kinds}) at their initial values {heads_ok}")
        if not (file_ok and heads_ok and len(from_file) == len(table)
                and head_kinds == ["pos_enc_embed", "toalpha"]):
            raise RuntimeError("the warm start from the converted pickle is not exact")
        del warm, init, own
        torch.cuda.empty_cache()
        stats = LoopStats()
        reset_counts(fr)
        state = train_gmpi_torch.main(args + ["--output_dir", os.path.join(tmp, "w2"),
                                              "--total_iters", str(WARM_STEPS)], stats=stats)
        counts = read_counts(fr)
        split = cfg.hparams.batch_split
        n_snaps = len(stats.snapshot_steps)
        want = {**generator_only(counts), "fused_fwd": 3 * WARM_STEPS + 24 * n_snaps,
                "composite_bwd": split * WARM_STEPS, "splat": split * WARM_STEPS}
        log(f"warm-started training: {len(stats.step_ms)} steps, step ms "
            f"{['%.1f' % x for x in stats.step_ms]}, launches {counts}; "
            + "; ".join(", ".join(f"{k} {v:.4f}" for k, v in m.items()) for m in stats.metrics)
            + f" ({card})")
        if state.step != WARM_STEPS or counts != want:
            raise RuntimeError(f"warm-started run: step {state.step}, launches {counts}, "
                               f"expected {want}")
        for m in stats.metrics:
            if not all(v == v and abs(v) != float("inf") for v in m.values()) or not m["r1"] > 0:
                raise RuntimeError(f"warm-started run: bad metrics {m}")
        launches["warm_steps"] = counts
        record["checkpoint"] = {"pickle_bytes": os.path.getsize(pkl), "convert_s": convert_s,
                                "npz_bytes": os.path.getsize(npz), "tensors": len(table),
                                "step_ms": stats.step_ms}
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    record["launches"] = launches
    return record, k1_err


BF16_RENDER_GATE = 2e-2  # bf16 textures against fp32 (tests/test_pallas_warp.py:243-262)
BF16_STEPS = 3  # train steps with fused_compute_dtype="bf16": 2 whole, 1 timed by phase
RANK_STEPS = 2  # train steps of each multi-rank run
RANK_TIMEOUT = 420  # seconds a spawn of ranks may take
RANK_DEVICE = "cuda:0"  # every rank of phase 12b on the one card


def check_bf16_training_form(fr, label, tex16, rx, ry, q, scal):
    """K1's bf16 form in its training form (grad-safe early-out, residual,
    ``n_live``) against its bf16 plain version: outputs 1e-4 absolute, the
    residual on slots both reached, ``n_live`` within a plane on at most 1e-4
    of the pixels.  Returns the largest absolute error."""
    kw = dict(early_out="grad", with_disp=False, with_warped=True)
    out = fr.warp_composite_fwd(tex16, rx, ry, q, scal, **kw)
    ref = fr.warp_composite_fwd_ref(tex16, rx, ry, q, scal, **kw)
    torch.cuda.synchronize()
    n_l = scal.shape[1]
    planes = torch.arange(n_l, device=rx.device).reshape(1, n_l, 1, 1, 1)
    both = planes < torch.minimum(out[-1], ref[-1])[:, None, None]
    errs = [float((a - b).abs().max()) for a, b in zip(out[:3], ref[:3])]
    errs.append(float(torch.where(both, out[3] - ref[3], 0.0).abs().max()))
    moved = float((out[-1] != ref[-1]).float().mean())
    step = int((out[-1] - ref[-1]).abs().max())
    log(f"fused_fwd bf16 training form vs plain [{label}]: max abs err {max(errs):.3e} "
        f"(color, depth, trans, residual {['%.2e' % e for e in errs]}); n_live moved on "
        f"{moved:.2e} of pixels, by at most {step}")
    if not (all(e <= TOL for e in errs) and step <= 1 and moved <= 1e-4):
        raise RuntimeError(f"fused_fwd bf16 training form [{label}] disagrees with its plain "
                           f"version: {errs}, n_live moved {moved} by {step}")
    return max(errs)


def check_bf16_edges(fr, cam, poses, cfg, dev):
    """K1's bf16 form against its bf16 plain version at phase 2e's edge shapes
    (the unaligned slab takes the kernel's texel-by-texel copy), every
    ``early_out`` mode, with the residual; 1e-4 absolute on real rays."""
    n_v, n_l = 3, 9
    geom = dataclasses.replace(
        cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_l)).plane_geometry(device=dev)
    c2w, _, _ = poses.sample_sphere_poses(
        None, n_v, cfg.camera, given_yaws=torch.tensor([[0.5], [-0.3], [0.0]]),
        given_pitches=torch.tensor([[0.2], [-0.25], [0.1]]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    err = 0.0
    for label, (h, w), (th, tw), tweak in EDGE_CASES:
        ray_dir, eye, z_dir = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, h, w), c2w)
        scal = fr.plane_affine(geom.dhw, eye, th, tw).contiguous()
        rx, ry, q = (x.contiguous() for x in fr.ray_fields(ray_dir, z_dir))
        if tweak == "outside":
            scal[..., 1] += 1e4
        if tweak == "nan":
            rx[0, 5, 7] = ry[0, 5, 7] = float("nan")
        real = torch.isfinite(rx) & torch.isfinite(ry)
        uniform = torch.rand((n_v, n_l + 4, 4, th, tw), device=dev, generator=gen)
        sparse = uniform.clone()
        sparse[:, :, 3] *= 0.05
        opaque_mid = sparse.clone()
        opaque_mid[:, 5:8, 3] = 1.0
        case_err = 0.0
        for stack in (uniform, sparse, opaque_mid):
            parent = stack.to(torch.bfloat16)
            tex = unaligned_copy(parent)[:, 2:2 + n_l] if tweak == "slab" else \
                parent[:, 2:2 + n_l].contiguous()
            for early_out in (False, True, "grad"):
                kw = dict(early_out=early_out, with_disp=True, with_warped=early_out is not True)
                out = fr.warp_composite_fwd(tex, rx, ry, q, scal, **kw)
                ref = fr.warp_composite_fwd_ref(tex, rx, ry, q, scal, **kw)
                torch.cuda.synchronize()
                for a, b in zip(out[:4], ref[:4]):
                    case_err = worse(case_err, float(torch.where(real[:, None], a - b,
                                                                 0.0).abs().max()))
                if early_out == "grad" and int(torch.where(real, out[-1] - ref[-1],
                                                           0).abs().max()) > 1:
                    raise RuntimeError(f"fused_fwd bf16 [{label}]: n_live moved by more "
                                       f"than one plane")
        log(f"fused_fwd bf16 vs plain at the edge [{label}: image {h}x{w}, texture {th}x{tw}]: "
            f"max abs err {case_err:.3e} over 3 stacks x 3 early_out modes")
        if not case_err <= TOL:
            raise RuntimeError(f"fused_fwd bf16 [{label}] disagrees with its plain version")
        err = worse(err, case_err)
    return err


def bf16_phase(fr, cfg, card, chip, dev, fp32_step):
    """Phase 12a: K1's bf16-texture form on the card: against its bf16 plain
    version at the serving and training shapes on the three stacks and at the
    edges; the bf16 render against the fp32 render; K1 bf16 and fp32 timed in
    turns with their bounds; ``BF16_STEPS`` train steps with
    ``fused_compute_dtype="bf16"`` beside phase 4's fp32 step (``fp32_step``),
    their launches and the ``rgba`` gradient against the fp32 route's.
    Returns the phase's record; raises on a failed check."""
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import render_mpi_fused
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.models.generator import Generator
    from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step
    from gmpi_tpu_torch.utils.roofline import attained, render_cost

    bf = torch.bfloat16
    rates = card_rates(chip)
    n_planes, res, n_train = cfg.eval_n_planes, cfg.resolution, cfg.planes.n_planes
    c, k = cfg.camera, cfg.camera.n_truncated_stds
    intr = cam.intrinsics_from_fov(cfg.fov_deg, res, res)
    geom = dataclasses.replace(cfg, planes=dataclasses.replace(
        cfg.planes, n_planes=n_planes)).plane_geometry(device=dev)
    geom_train = cfg.plane_geometry(device=dev)

    def rays_at(yaws, pitches):
        c2w, _, _ = poses.sample_sphere_poses(None, len(yaws), c, given_yaws=yaws,
                                              given_pitches=pitches, device=dev)
        return cam.generate_rays(intr, c2w)

    record = {"max_abs_err": 0.0}
    # serving shapes: 4 views x 96 planes, inference form; the bf16 render against fp32
    yaws = torch.tensor([[k * c.yaw_std], [-k * c.yaw_std], [k * c.yaw_std], [0.0]])
    pitches = torch.tensor([[k * c.pitch_std], [-k * c.pitch_std], [-k * c.pitch_std], [0.0]])
    rays = fused_inputs(fr, geom.dhw, *rays_at(yaws, pitches), res)
    vs_fp32 = 0.0
    for case, tex in three_stacks(4, n_planes, res, dev, seed=20):
        tex16 = tex.to(bf)
        for with_disp in (False, True):
            record["max_abs_err"] = worse(record["max_abs_err"], check_inference_form(
                fr, f"bf16 {case}, V=4, L={n_planes}", tex16, *rays, with_disp))
        out16 = fr.warp_composite_fwd(tex16, *rays)
        out32 = fr.warp_composite_fwd(tex, *rays)
        vs_fp32 = worse(vs_fp32, max(float((a - b).abs().max()) for a, b in zip(out16, out32)))
        del tex, tex16, out16, out32
    log(f"fused_fwd bf16 render vs the fp32 render of the same stacks: max abs diff "
        f"{vs_fp32:.3e} (gate {BF16_RENDER_GATE})")
    if not vs_fp32 <= BF16_RENDER_GATE:
        raise RuntimeError("the bf16 render strays from the fp32 render")
    record["bf16_vs_fp32_max_abs_diff"] = vs_fp32
    # training shapes: 8 views x 32 planes, training form and the D phase's inference form
    sy, sp = k * c.yaw_std, k * c.pitch_std
    yaws = torch.tensor([[sy], [-sy], [sy], [-sy], [0.0], [sy], [0.0], [-sy]])
    pitches = torch.tensor([[sp], [-sp], [-sp], [sp], [0.0], [0.0], [sp], [0.0]])
    rays_t = fused_inputs(fr, geom_train.dhw, *rays_at(yaws, pitches), res)
    for case, tex in three_stacks(8, n_train, res, dev, seed=21):
        tex16 = tex.to(bf)
        e = check_bf16_training_form(fr, f"{case}, V=8, L={n_train}", tex16, *rays_t)
        e = worse(e, check_inference_form(fr, f"bf16 {case}, V=8, L={n_train}", tex16, *rays_t,
                                          False))
        record["max_abs_err"] = worse(record["max_abs_err"], e)
        del tex, tex16
    record["max_abs_err"] = worse(record["max_abs_err"], check_bf16_edges(fr, cam, poses, cfg,
                                                                           dev))
    torch.cuda.empty_cache()

    # K1 bf16 and fp32 in turns at the serving path's inputs (phase 3's first MPI)
    gen = FakeImageGenerator(cfg, Generator(cfg.generator_cfg(),
                                            generator=torch.Generator().manual_seed(0)),
                             use_fused=True, device=dev)
    mpi = gen.sample_mpi(0)
    yv, pv = gen.sample_views(0, 4)
    mpi_v = mpi.expand(4, -1, -1, -1, -1)
    rays = fused_inputs(fr, geom.dhw, *rays_at(yv, pv), res)
    mpi16 = fr.cast_texture(mpi_v, bf)
    record["max_abs_err"] = worse(record["max_abs_err"], check_inference_form(
        fr, "bf16 serving main path's MPI, V=4", mpi16, *rays, True))
    with torch.no_grad():
        turns = [time_ms(lambda t=t: fr.warp_composite_fwd(t, *rays))
                 for t in (mpi_v, mpi16, mpi16, mpi_v)]
        plain16 = time_ms(lambda: fr.warp_composite_fwd_ref(mpi16, *rays), iters=5, warmup=1)
    texels, pairs = needed_work(fr, mpi_v, *rays[:2], rays[3])
    texels16, pairs16 = needed_work(fr, mpi16, *rays[:2], rays[3])
    n_pix = rays[0].numel()
    other = 3 * n_pix * 4 + rays[3].numel() * 4 + 6 * n_pix * 4  # rays, scal, outputs
    b32 = bound(texels * 16 + other, FLOP_PER_PAIR["fused_fwd"] * pairs, rates)
    b16 = bound(texels16 * 8 + other, FLOP_PER_PAIR["fused_fwd"] * pairs16, rates)
    # phase 11's model bound, one stack read once for its 4 views: 2 bytes a texel read
    model = {name: attained(min(turns[1:3] if tbe == 2 else (turns[0], turns[3])) / 1e3,
                            render_cost(4, n_planes, res, res, res, res,
                                        patch_overread=0.25, tex_bytes_per_el=tbe), chip)
             for name, tbe in (("bf16", 2), ("fp32", 4))}
    log(f"fused_fwd in turns at the serving inputs (fp32, bf16, bf16, fp32): "
        f"{['%.4f' % t for t in turns]} ms; bf16 needs {texels16 * 8 + other} B "
        f"({pairs16} live pairs), bound {b16[0]:.5f} ms by {b16[1]}; fp32 needs "
        f"{texels * 16 + other} B, bound {b32[0]:.5f} ms; bf16 plain {plain16:.3f} ms; "
        f"render_cost bound bf16 {model['bf16']['speed_of_light_s'] * 1e3:.5f} ms by "
        f"{model['bf16']['bound']} ({model['bf16']['sol_fraction']:.1%}), fp32 "
        f"{model['fp32']['speed_of_light_s'] * 1e3:.5f} ms ({model['fp32']['sol_fraction']:.1%}) "
        f"({card})")
    record.update(ms=min(turns[1:3]), fp32_ms=min(turns[0], turns[3]), turns_ms=turns,
                  plain_ms=plain16, bound_ms=b16[0], bound_by=b16[1], fp32_bound_ms=b32[0],
                  render_cost_share={k: v["sol_fraction"] for k, v in model.items()})
    del gen, mpi, mpi_v, mpi16
    torch.cuda.empty_cache()

    # train steps with bf16 textures beside phase 4's fp32 step
    cfg16 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                               fused_compute_dtype="bf16"))
    state = init_train_state(cfg16, torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(cfg16, device=dev)
    bs, split = cfg.hparams.batch_size, cfg.hparams.batch_split
    data = torch.Generator().manual_seed(1)
    real = (torch.rand((bs, 3, res, res), generator=data) * 2.0 - 1.0).to(dev)
    real_c2w, _, _ = poses.sample_sphere_poses(data, bs, c, device=dev)
    real_pose = flat_pose_from_c2w(real_c2w, cfg.train.d_cond_pose_dim)
    rng = torch.Generator().manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fr)
    step_ms, metrics = [], []
    for _ in range(BF16_STEPS - 1):
        (_, m), ms = host_ms(lambda: step(state, real, real_pose, rng))
        step_ms.append(ms)
        metrics.append(m)
    (dm, _), d_ms = host_ms(lambda: step.d_phase(state, real, real_pose, rng))
    (gm, _), g_ms = host_ms(lambda: step.g_phase(state, bs, rng))
    state.step += 1
    metrics.append({**dm, **gm})
    launches = read_counts(fr)
    peak = torch.cuda.max_memory_allocated() / 1e9
    expected = {**generator_only(launches), "fused_fwd": 3 * BF16_STEPS,
                "composite_bwd": split * BF16_STEPS, "splat": split * BF16_STEPS}
    if launches != expected:
        raise RuntimeError(f"bf16 train steps launched {launches}, expected {expected}")
    for i, m in enumerate(metrics):
        vals = {key: float(val) for key, val in m.items()}
        if not all(x == x and abs(x) != float("inf") for x in vals.values()):
            raise RuntimeError(f"bf16 step {i}: non-finite metric {vals}")
    log(f"bf16 train steps ({BF16_STEPS}, fused_compute_dtype='bf16'): launches {launches}; "
        f"step ms {['%.1f' % x for x in step_ms]}, by phase D {d_ms:.1f} G {g_ms:.1f}; peak "
        f"{peak:.2f} GB; phase 4's fp32 step: median {fp32_step['ms']:.1f} ms, D "
        f"{fp32_step['d_ms']:.1f} G {fp32_step['g_ms']:.1f}, peak {fp32_step['peak_gb']:.2f} "
        f"GB ({card})")
    # an fp32 state from the same seed, one step to warm it (Adam's moments), then
    # whole steps in turns: fp32, bf16, bf16, fp32, each with its own peak
    state32 = init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step32 = make_train_step(cfg, device=dev)
    step32(state32, real, real_pose, rng)
    in_turns = []
    for tag, st, fn in (("fp32", state32, step32), ("bf16", state, step), ("bf16", state, step),
                        ("fp32", state32, step32)):
        torch.cuda.reset_peak_memory_stats()
        _, ms = host_ms(lambda: fn(st, real, real_pose, rng))
        in_turns.append((tag, ms, torch.cuda.max_memory_allocated() / 1e9))
    log("train steps in turns (fp32, bf16, bf16, fp32; host clock, peak GB each): "
        + ", ".join(f"{tag} {ms:.1f} ms {gb:.2f} GB" for tag, ms, gb in in_turns) + f" ({card})")
    record["step_turns"] = in_turns
    del state32, step32
    # the rgba gradient of the bf16 route against the fp32 route's
    z = torch.randn((bs, cfg.train.z_dim), generator=rng).to(dev)
    with torch.no_grad():
        mpi = step.synth(state.G, z, rng)
    yv, pv = step.sample_views(rng, bs)
    ray_dir, eye, z_dir = rays_at(yv, pv)
    cot = torch.randn((bs, 3, res, res), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    grads = []
    for cd in (None, bf):
        x = mpi.clone().requires_grad_()
        out = render_mpi_fused(x, geom_train.dhw, ray_dir, eye, z_dir, with_disp=False,
                               compute_dtype=cd)
        grads.append(torch.autograd.grad((out.color * cot).sum(), x)[0])
    err_g = rel_err(grads[1], grads[0])
    log(f"bf16 route's rgba gradient (fp32 backward on the bf16 forward's residual) vs the fp32 "
        f"route's: {err_g:.3e} of max|grad| (gate {BF16_RENDER_GATE}); dtype {grads[1].dtype}")
    if not (err_g <= BF16_RENDER_GATE and grads[1].dtype == torch.float32):
        raise RuntimeError("the bf16 route's gradient strays from the fp32 route's")
    record.update(train_launches=launches, step_ms=step_ms, d_ms=d_ms, g_ms=g_ms, peak_gb=peak,
                  fp32_step=fp32_step, grad_vs_fp32=err_g)
    del state, step, mpi, grads, x, out
    torch.cuda.empty_cache()
    return record


# -- phase 12b: ranks on the one card ---------------------------------------------------


def _spawn_ranks(job, world, work, env=None):
    """Run ``job`` in ``world`` processes of this script (``--rank``); every
    rank's result.  A rank that fails, hangs past ``RANK_TIMEOUT`` or writes
    no result fails the phase; every process is stopped before returning."""
    import os

    env = dict(os.environ, **(env or {}))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(sys.argv[0]), "--rank", job,
                               str(r), str(world), work], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        deadline = time.time() + RANK_TIMEOUT
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"  [{job} rank {r}/{world}] {line}")
        path = os.path.join(work, f"{job}_{r}.json")
        if p.returncode != 0 or not os.path.exists(path):
            raise RuntimeError(f"{job}: rank {r} of {world} exited {p.returncode}")
        with open(path) as f:
            results.append(json.load(f))
    return results


def ranks_phase(fr, card, dev):
    """Phase 12b: ranks sharing the one card over ``gloo`` (every rank on
    ``cuda:0``; two ranks on one card measure correctness and per-rank cost,
    not scaling), and one rank in an NCCL group.  Returns the phase's record
    with the launches every rank made; raises if any rank failed."""
    import os
    import shutil
    import socket
    import tempfile

    from gmpi_tpu_torch.config import get_config

    cfg = get_config("FFHQ256")
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        t0 = time.perf_counter()
        two = _spawn_ranks("sharded", 2, work)
        four = _spawn_ranks("render4", 4, work)
        zpath, pose_dir = write_ffhq_dataset(work, 20, cfg.resolution, seed=9)
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        cli = _spawn_ranks("cli", 2, work, env={"MASTER_ADDR": "localhost",
                                                "MASTER_PORT": str(port),
                                                "CHIP_SMOKE_DATA": f"{zpath}:{pose_dir}"})
        nccl = _spawn_ranks("nccl", 1, work)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the CLI run: disjoint shards, rank 0 alone saved, the same parameters
    idx = [r["shard"][3] for r in cli]
    # 19 images in 2 shards of 10: disjoint but for the one padding sample
    if (len(set(idx[0]) | set(idx[1])) != 19 or len(idx[0]) + len(idx[1]) != 20
            or [r["shard"][:3] for r in cli] != [[i, 2, cfg.hparams.batch_size // 2]
                                                 for i in (0, 1)]):
        raise RuntimeError(f"CLI ranks' shards are not disjoint shares: {[r['shard'] for r in cli]}")
    if cli[0]["saves"] != 1 or cli[1]["saves"] != 0 or cli[0]["digest"] != cli[1]["digest"]:
        raise RuntimeError(f"CLI ranks: saves {[r['saves'] for r in cli]}, digests "
                           f"{[r['digest'] for r in cli]}")
    log(f"ranks on the one card: 2 + 4 + 2 + 1 processes in {seconds:.1f} s ({card}; ranks "
        f"share the card: correctness and per-rank cost, not scaling)")
    # each rank's counts as read at the end of each of its main paths
    launches = sum((Counts(r["launches"], r["k7_paths"], r["k9_blocks"])
                    for r in two + four + cli + nccl),
                   no_counts(fr))
    return {"sharded2": two, "render4": four, "cli2": cli, "nccl1": nccl,
            "launches": launches, "seconds": seconds}


def _rank_renders(mesh_p, mesh_t, mesh_pt, dev, gates, record, fr):
    """The sharded renders of one rank at the serving shapes (4 views x 96
    planes of 256^2, FFHQ256 geometry, the same seeded stack on every rank)
    against ``render_mpi_fused`` in this process: 5e-4; the plane-sharded
    ``rgba`` gradient against the single process's: 1e-3 of max|grad|.
    Counts each render's launches."""
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import bands as bands_mod
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import make_fused_slab_renderer, render_mpi_fused
    from gmpi_tpu_torch.parallel import render as pr

    cfg = get_config("FFHQ256")
    n_planes, res = cfg.eval_n_planes, cfg.resolution
    geom = dataclasses.replace(cfg, planes=dataclasses.replace(
        cfg.planes, n_planes=n_planes)).plane_geometry(device=dev)
    k = cfg.camera.n_truncated_stds
    yaws = torch.tensor([[k * 0.289], [-k * 0.289], [0.1], [0.0]])
    pitches = torch.tensor([[k * 0.127], [-0.1], [-k * 0.127], [0.0]])
    c2w, _, _ = poses.sample_sphere_poses(None, 4, cfg.camera, given_yaws=yaws,
                                          given_pitches=pitches, device=dev)
    rays = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)
    g = torch.Generator(device=dev).manual_seed(30)
    rgba = torch.rand((4, n_planes, 4, res, res), device=dev, generator=g)
    rgba[:, :, 3] *= 0.1
    cot = torch.randn((4, 3, res, res), device=dev, generator=g)
    with torch.no_grad():
        ref = render_mpi_fused(rgba, geom.dhw, *rays, with_disp=False)
    bands = tuple(bands_mod.bands_for_config(cfg, img_size=res, n_planes=n_planes,
                                             device=dev)[:2])
    slab = make_fused_slab_renderer()

    def fused(r, d, rd, e, z):
        return render_mpi_fused(r, d, rd, e, z, with_disp=False)

    cases = {}
    if mesh_p is not None:
        cases["plane_fused"] = lambda x: pr.render_mpi_plane_sharded(
            mesh_p, x, geom.dhw, *rays, slab_fn=slab)
        cases["pipelined_fused"] = lambda x: pr.render_mpi_plane_sharded_pipelined(
            mesh_p, x, geom.dhw, *rays, n_sub=2, slab_fn=slab)
    if mesh_t is not None:
        cases["tile_fused"] = lambda x: pr.render_mpi_tile_sharded(
            mesh_t, x, geom.dhw, *rays, render_fn=fused)
        cases["tile_banded"] = lambda x: pr.render_mpi_tile_sharded(
            mesh_t, x, geom.dhw, *rays, tiled_bands=bands)
    if mesh_pt is not None:
        cases["plane_tile_fused"] = lambda x: pr.render_mpi_plane_tile_sharded(
            mesh_pt, x, geom.dhw, *rays, slab_fn=slab)
        cases["plane_tile_banded"] = lambda x: pr.render_mpi_plane_tile_sharded(
            mesh_pt, x, geom.dhw, *rays, tiled_bands=bands)
    for name, fn in cases.items():
        reset_counts(fr)
        with torch.no_grad():
            out, ms = host_ms(lambda: fn(rgba))
        err = max(float((out.color - ref.color).abs().max()),
                  float((out.depth - ref.depth).abs().max()))
        record["renders"][name] = {"err": err, "ms": ms, "launches": read_counts(fr)}
        record["launches"] += record["renders"][name]["launches"]
        if not err <= gates[0]:
            raise RuntimeError(f"{name}: {err} from the single-process render")
    # the rgba gradient of the plane-sharded (or plane x tile) fused render
    name, fn = next((n, f) for n, f in cases.items() if n.startswith("plane"))
    grads = []
    reset_counts(fr)
    for render in (fn, lambda x: render_mpi_fused(x, geom.dhw, *rays, with_disp=False)):
        x = rgba.clone().requires_grad_()
        grads.append(torch.autograd.grad((render(x).color * cot).sum(), x)[0])
    record["launches"] += read_counts(fr)
    err_g = rel_err(grads[0], grads[1])
    record["grad"] = {"case": name, "rel_err": err_g}
    if not err_g <= gates[1]:
        raise RuntimeError(f"{name}: rgba gradient {err_g} of max from the single process's")


def _rank_job(job, rank, world, work):
    """One rank of phase 12b (``python3 chip_smoke.py --rank <job> <rank>
    <world> <dir>``): joins the group, runs ``job``, writes its JSON result."""
    import os

    import torch.distributed as dist

    from gmpi_tpu_torch.ops import fused_render as fr
    from gmpi_tpu_torch.parallel import mesh as mesh_mod
    from gmpi_tpu_torch.parallel.mesh import Mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    count_k9_blocks()
    dev = torch.device(RANK_DEVICE)
    torch.cuda.set_device(dev)
    record = {"rank": rank, "world": world, "renders": {},
              "launches": no_counts(fr)}
    gates = (5e-4, GRAD_REL)
    if job == "cli":
        record.update(_rank_cli(rank, world, work, fr))
    else:
        backend = "nccl" if job == "nccl" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{work}/{job}.rendezvous",
                                rank=rank, world_size=world)
        try:
            if job == "sharded":
                _rank_renders(Mesh([2], ("plane",), dev), Mesh([2], ("tile",), dev), None, dev,
                              gates, record, fr)
                record.update(_rank_train(dev, fr, record))
            elif job == "render4":
                _rank_renders(None, None, Mesh([2, 2], ("plane", "tile"), dev), dev, gates,
                              record, fr)
            else:  # one rank in an NCCL group: every collective on device tensors
                before = mesh_mod.COLLECTIVE_BYTES["bytes"]
                # a mesh's axis of one has no group; these are the world of one, so
                # that every gather and reduce of the sharded calls goes through NCCL
                one = types.SimpleNamespace(group=lambda axis: dist.group.WORLD)
                _rank_renders(one, one, None, dev, gates, record, fr)
                record["backend"] = dist.get_backend()
                record["collective_bytes"] = mesh_mod.COLLECTIVE_BYTES["bytes"] - before
                if record["backend"] != "nccl" or record["collective_bytes"] == 0:
                    raise RuntimeError(f"no NCCL collective was made: {record}")
        finally:
            dist.destroy_process_group()
    record["k7_paths"] = record["launches"].k7_paths
    record["k9_blocks"] = record["launches"].k9_blocks
    with open(os.path.join(work, f"{job}_{rank}.json"), "w") as f:
        json.dump(record, f)
    print(json.dumps({k: v for k, v in record.items() if k != "launches"}), flush=True)
    return 0


def _rank_train(dev, fr, record):
    """``RANK_STEPS`` train steps of the full FFHQ256 preset with
    ``renderer_plane_shards=2`` on this rank: step ms, peak GB, bytes handed
    to collectives a step, and ``check_replica_consistency(atol=0)`` over G,
    D, both EMAs and both Adam states after each step."""
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.parallel import mesh as mesh_mod
    from gmpi_tpu_torch.parallel.mesh import replicate
    from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step
    from gmpi_tpu_torch.train.loop import make_train_mesh
    from gmpi_tpu_torch.train.step import state_tensors
    from gmpi_tpu_torch.utils.inspect import check_replica_consistency

    cfg = get_config("FFHQ256")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, renderer_plane_shards=2))
    mesh = make_train_mesh(cfg, dev)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    for part in (state.G, state.D, state.ema, state.ema2):
        replicate(mesh, part)
    step = make_train_step(cfg, device=dev, mesh=mesh)
    bs, res = cfg.hparams.batch_size, cfg.resolution
    data = torch.Generator().manual_seed(1)
    real = (torch.rand((bs, 3, res, res), generator=data) * 2.0 - 1.0).to(dev)
    real_c2w, _, _ = poses.sample_sphere_poses(data, bs, cfg.camera, device=dev)
    real_pose = flat_pose_from_c2w(real_c2w, cfg.train.d_cond_pose_dim)
    rng = torch.Generator().manual_seed(2)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"step_ms": [], "bytes_a_step": [], "metrics": [], "replica_checks": 0}
    reset_counts(fr)
    for _ in range(RANK_STEPS):
        before = mesh_mod.COLLECTIVE_BYTES["bytes"]
        (_, metrics), ms = host_ms(lambda: step(state, real, real_pose, rng))
        out["bytes_a_step"].append(mesh_mod.COLLECTIVE_BYTES["bytes"] - before)
        out["step_ms"].append(ms)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        check_replica_consistency(state_tensors(state), atol=0.0)
        out["replica_checks"] += 1
    out["train_launches"] = read_counts(fr)
    record["launches"] += out["train_launches"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    for m in out["metrics"]:
        if not all(x == x and abs(x) != float("inf") for x in m.values()):
            raise RuntimeError(f"non-finite metric {m}")
    split = cfg.hparams.batch_split
    want = {"fused_fwd": 3 * RANK_STEPS, "composite_bwd": split * RANK_STEPS,
            "splat": split * RANK_STEPS}
    if {k: out["train_launches"][k] for k in want} != want:
        raise RuntimeError(f"plane-sharded steps launched {out['train_launches']}, want {want}")
    return {"train": out}


def _rank_cli(rank, world, work, fr):
    """This rank of ``train_gmpi_torch.main --multihost --device cuda:0``:
    data-parallel FFHQ256 (global batch 8, 4 a rank), 2 steps on the phase's
    dataset; the backend the CLI chose, its loader shard, its checkpoint
    saves, its metrics and step ms, and the replicas checked after
    training."""
    import hashlib
    import os

    import torch.distributed as dist

    import train_gmpi_torch
    from gmpi_tpu_torch.data import loader as loader_mod
    from gmpi_tpu_torch.train import loop as loop_mod
    from gmpi_tpu_torch.train.loop import LoopStats
    from gmpi_tpu_torch.train.step import state_tensors
    from gmpi_tpu_torch.utils.inspect import check_replica_consistency

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    zpath, pose_dir = os.environ["CHIP_SMOKE_DATA"].split(":")
    saves, shards = [], []
    real_save, real_init = loop_mod.save_checkpoint, loader_mod.ShardedLoader.__init__

    def counted_save(*a, **kw):
        saves.append(a[0])
        return real_save(*a, **kw)

    def recorded_init(self, *a, **kw):
        real_init(self, *a, **kw)
        shards.append([self.shard_id, self.num_shards, self.batch_size,
                       [int(i) for i in self._epoch_indices(0)]])

    backends, real_group = [], dist.init_process_group

    def recorded_group(backend=None, **kw):
        backends.append(backend)
        return real_group(backend, **kw)

    loop_mod.save_checkpoint = counted_save
    loader_mod.ShardedLoader.__init__ = recorded_init
    dist.init_process_group = recorded_group
    reset_counts(fr)
    stats = LoopStats()
    state = train_gmpi_torch.main(
        ["--dataset", "FFHQ256", "--data_root", zpath, "--pose_root", pose_dir,
         "--output_dir", os.path.join(work, "cli_run"), "--multihost", "--device", RANK_DEVICE, "--total_iters", str(RANK_STEPS), "--seed", "5",
         "--sample_interval", "1000", "--model_save_interval", "1000"], stats=stats)
    launches = read_counts(fr)
    dist.init_process_group = real_group
    if backends != ["gloo"]:  # two ranks on one card: NCCL would refuse them
        raise RuntimeError(f"CLI rank {rank}: process groups {backends}, expected gloo")
    dist.init_process_group("gloo", init_method=f"file://{work}/cli_check.rendezvous",
                            rank=rank, world_size=world)
    try:
        check_replica_consistency(state_tensors(state), atol=0.0)
    finally:
        dist.destroy_process_group()
    h = hashlib.sha256()
    for k, v in sorted(state.G.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    if len(shards) != 1 or state.step != RANK_STEPS:
        raise RuntimeError(f"CLI rank {rank}: {len(shards)} loaders, step {state.step}")
    return {"shard": shards[0], "saves": len(saves), "digest": h.hexdigest(),
            "step_ms": stats.step_ms, "metrics": stats.metrics, "launches": launches}


# -- phase 13: the 1024^2 and 512^2 presets ---------------------------------------------
# depth of phase 13; every width is the preset's own
PRESET_SEEDS = (0, 1)  # FFHQ1024 serving seeds, 96 planes each (an FID set is 50k)
PRESET_VIEWS = 4
PRESET_STEPS = (2, 3)  # FFHQ1024 steps at the preset's own settings: warm-up, timed
SWITCH_STEPS = 2  # steps with each memory switch: one whole, one timed by phase
PRESET_IMAGES = 8  # noise PNGs of each synthetic dataset
PRESET_LOOP_STEPS = (2, 3)  # train CLI steps, then resumed to
PRESET_FAKES = 4  # prepare_fake images of the FFHQ1024 checkpoint, banded and fused
FULL_SCALE_PLANES = 96
FULL_SCALE_POSES = ((0.1, 0.05), (0.578, 0.254))  # the JAX bench pose; a +2 sigma corner
FULL_SCALE_BF16_GATE = 2e-2  # the JAX package's bf16 gate
PLAIN_ITERS = 3  # timed runs of a plain version at 1024^2
REMAT_PLANE_CHUNK = 8  # render_mpi_fused_remat's slab, which the train step takes


def step_launches(cfg):
    """Kernel launches of one fused train step of ``cfg``, as ``train/step.py``
    makes them: the D phase renders its fakes in ``d_split`` micro-batches
    without a gradient, worst-view selection renders every candidate in one
    call (none when ``worst_view_render_res`` sends it through the gather
    path), and each of the ``batch_split`` G micro-batches renders with a
    gradient (one forward, one composite backward, one splat).  Under
    ``fused_remat`` every render is ``render_mpi_fused_remat``'s slabs, and
    the backward runs each slab's forward again."""
    t, h = cfg.train, cfg.hparams
    split = h.batch_split
    d_split = split if (t.d_batch_split and h.batch_size % split == 0) else 1
    slabs = -(-cfg.planes.n_planes // REMAT_PLANE_CHUNK) if t.fused_remat else 1
    worst = t.n_view_per_z > 1 and t.select_worst_view and not t.worst_view_render_res
    fwd = d_split * slabs + (slabs if worst else 0) + split * slabs * (2 if t.fused_remat else 1)
    return {"fused_fwd": fwd, "composite_bwd": split * slabs, "splat": split * slabs}


def scaled(launches, n):
    return {k: v * n for k, v in launches.items()}


def memory_switches(res):
    """Phase 13d's memory switches of the 1024^2 preset (``docs/TPU_TRAIN.md``),
    each alone, then all four together."""
    each = (("fused_remat", dict(fused_remat=True)), ("r1_remat", dict(r1_remat=True)),
            (f"worst_view_render_res={res // 4}", dict(worst_view_render_res=res // 4)),
            ("bf16 textures", dict(fused_compute_dtype="bf16")))
    return each + (("all four", {k: v for _, sw in each for k, v in sw.items()}),)


def corner_angles(cfg):
    """``[4, 1]`` yaws and pitches at the four truncation corners of ``cfg``'s
    pose range."""
    c, k = cfg.camera, cfg.camera.n_truncated_stds
    sy, sp = k * c.yaw_std, k * c.pitch_std
    return (torch.tensor([[c.yaw_mean + sy], [c.yaw_mean - sy], [c.yaw_mean + sy],
                          [c.yaw_mean - sy]]),
            torch.tensor([[c.pitch_mean + sp], [c.pitch_mean - sp], [c.pitch_mean - sp],
                          [c.pitch_mean + sp]]))


def preset_rays(cfg, n_planes, yaws, pitches, dev):
    """``(plane geometry at n_planes, (ray_dir, eye, z_dir))`` of ``cfg`` at its
    resolution, one camera a row of ``yaws``/``pitches``."""
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses

    geom = dataclasses.replace(cfg, planes=dataclasses.replace(
        cfg.planes, n_planes=n_planes)).plane_geometry(device=dev)
    c2w, _, _ = poses.sample_sphere_poses(None, yaws.shape[0], cfg.camera, given_yaws=yaws,
                                          given_pitches=pitches, device=dev)
    res = cfg.resolution
    return geom, cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)


def render_checks(label, color, depth, gather, lo, hi):
    """A render's outputs: finite, colour in [-1, 1] up to fp32 rounding (a
    saturated tanh gives an RGB of exactly 1, and the compositing weights sum
    to 1 within rounding), depth in ``[lo, hi]`` and within 5e-4 of the
    gather renderer's; returns the largest difference."""
    if not (torch.isfinite(color).all() and torch.isfinite(depth).all()):
        raise RuntimeError(f"{label}: non-finite render")
    if color.min() < -1.0 - 1e-6 or color.max() > 1.0 + 1e-6:
        raise RuntimeError(f"{label}: colour {float(color.min())}..{float(color.max())} outside "
                           f"[-1, 1]")
    if depth.min() < lo or depth.max() > hi:
        raise RuntimeError(f"{label}: depth {float(depth.min())}..{float(depth.max())} outside "
                           f"[{lo}, {hi}]")
    err = max(float((color - (gather.color * 2.0 - 1.0)).abs().max()),
              float((depth - gather.depth).abs().max()))
    if not err <= 5e-4:  # also catches NaN
        raise RuntimeError(f"{label}: {err} from the gather renderer (gate 5e-4)")
    return err


def preset_kernels(fr, ffhq, metfaces, dev):
    """Phase 13a: every fused kernel against its plain version at 1024^2, on the
    three stacks, at the truncation corners of FFHQ1024 and of MetFaces (each
    with its own planes): K1's serving form (one stack of 96 planes in 4
    views; with disparity for MetFaces) in fp32 and bf16; at 32 planes in
    the 4 corner views, K1's training form, the composite backward, the splat
    (both paths) and the adjoint (``check_training_kernels``), K1's D-phase
    and bf16 training forms, and its worst-view form (4 stacks, each into 4
    views at 4 scales of its corner: V=16).  Gates as phase 2.  Returns the
    largest error by kernel."""
    from gmpi_tpu_torch.core.renderer import plan_fused

    bf = torch.bfloat16
    errs = dict.fromkeys(("fused_fwd", "composite_bwd", "splat", "adjoint"), 0.0)
    gen = torch.Generator(device=dev).manual_seed(30)
    n_eval, n_train, n_cand = ffhq.eval_n_planes, ffhq.planes.n_planes, ffhq.train.n_view_per_z
    for cfg in (ffhq, metfaces):
        res = cfg.resolution
        yaws, pitches = corner_angles(cfg)
        geom, rays = preset_rays(cfg, n_eval, yaws, pitches, dev)
        f = fused_inputs(fr, geom.dhw, *rays, res)
        for case, tex in three_stacks(1, n_eval, res, dev, seed=30):
            label = f"{cfg.name} {case}, V=4, L={n_eval}, {res}^2"
            e = check_inference_form(fr, label, tex.expand(4, -1, -1, -1, -1), *f,
                                     cfg is metfaces)
            e = worse(e, check_inference_form(fr, f"bf16 {label}", tex.to(bf).expand(
                4, -1, -1, -1, -1), *f, cfg is metfaces))
            errs["fused_fwd"] = worse(errs["fused_fwd"], e)
            del tex
        geom_t, rays_t = preset_rays(cfg, n_train, yaws, pitches, dev)
        f_t = fused_inputs(fr, geom_t.dhw, *rays_t, res)
        scales = torch.linspace(1.0, 0.25, n_cand).reshape(1, n_cand)
        _, rays_w = preset_rays(cfg, n_train, (yaws * scales).reshape(-1, 1),
                                (pitches * scales).reshape(-1, 1), dev)
        f_w = fused_inputs(fr, geom_t.dhw, *rays_w, res)
        t0 = time.perf_counter()
        adj = plan_fused(geom_t.dhw, *rays_t, res, res)[1][0]  # also checks the warp is monotone
        log(f"adjoint plan at {cfg.name}'s 4 corner poses, {n_train} planes, {res}^2: {adj} in "
            f"{time.perf_counter() - t0:.1f} s (host)")
        for case, tex in three_stacks(4, n_train, res, dev, seed=31):
            label = f"{cfg.name} {case}, V=4, L={n_train}, {res}^2"
            for kname, e in check_training_kernels(fr, label, tex, *f_t, gen, adj).items():
                errs[kname] = worse(errs[kname], e)
            d_samp = torch.randn(tex.shape, device=dev, generator=gen)
            e_s = check_splat_paths(fr, d_samp, f_t[0], f_t[1], f_t[3], res, res)
            log(f"splat vs plain [{label}] by path: {e_s}")
            errs["splat"] = worse(errs["splat"], worse(e_s["box"], e_s["direct"]))
            del d_samp
            e = check_inference_form(fr, f"{label}, D-phase form", tex, *f_t, False)
            e = worse(e, check_inference_form(fr, f"{cfg.name} {case}, V={4 * n_cand}, 4 stacks "
                                                  f"in groups of {n_cand} views, L={n_train}",
                                              tex, *f_w, False))
            e = worse(e, check_bf16_training_form(fr, label, tex.to(bf), *f_t))
            errs["fused_fwd"] = worse(errs["fused_fwd"], e)
            del tex
        del f, f_t, f_w
        torch.cuda.empty_cache()
    if not all(e <= TOL for e in errs.values()):  # also catches NaN
        raise RuntimeError(f"a kernel disagrees with its plain version at 1024^2: {errs}")
    log(f"13a: kernels vs plain versions at 1024^2, largest error by kernel {errs} (gate {TOL})")
    return errs


def chunked_gather_fp64(rgba, dhw, ray_dir, eye, z_dir, plane_chunk=4):
    """The colour of ``render_mpi_chunked(plane_chunk=4)`` evaluated in float64
    from the same float32 inputs, differentiable in ``rgba``: the exact
    function that the float32 renderers round.  At 1024^2 the float32 gather
    renderer's texel coordinates are up to 3e-4 of a texel off at a +2 sigma
    corner pose, the fused kernels' (``plane_affine`` and ``ray_fields``,
    one FMA) up to 2e-4."""
    from gmpi_tpu_torch.core.renderer import combine_segments, composite_partial, homography_grid
    from gmpi_tpu_torch.ops.grid_sample import grid_sample_bilinear

    v, n_l, _, th, tw = rgba.shape
    h, w = ray_dir.shape[2:]
    carry = None
    for lo in range(0, n_l, plane_chunk):
        k = min(plane_chunk, n_l - lo)
        with torch.no_grad():
            grid, depth = homography_grid(
                dhw[lo:lo + k].double().repeat(v, 1), eye.double().repeat_interleave(k, 0),
                ray_dir.double().repeat_interleave(k, 0), z_dir.double().repeat_interleave(k, 0))
        samp = grid_sample_bilinear(rgba[:, lo:lo + k].double().reshape(v * k, 4, th, tw),
                                    grid).reshape(v, k, 4, h, w)
        part = composite_partial(samp[:, :, :3], samp[:, :, 3:4], depth.reshape(v, k, 1, h, w))
        carry = part if carry is None else combine_segments(carry, part)
    return carry[0]


def full_scale_checks(fr, tw, pg, cfg, rates, card, dev):
    """Phase 13b, the counterpart of ``tests/test_tpu_full_scale.py``: uniform
    rgba ``[1, 96, 4, 1024, 1024]`` and a normal cotangent on the colour, at
    the JAX bench pose and at a +2 sigma corner, forward and ``rgba``
    gradient under autograd: the fused renderer (fp32, 5e-4 of max|oracle|;
    bf16 textures, 2e-2) against ``render_mpi_chunked(plane_chunk=4)``'s
    function in float64 (``chunked_gather_fp64``), and the banded route
    (``render_mpi(tiled_bands=bands_for_config(...))``, patches through K7;
    5e-4) against ``render_mpi_chunked(plane_chunk=4)`` itself, whose float32
    texel coordinates it shares; every pair of the four is printed.
    Launches are read per route; the last patch gather is held against its
    plain version (exactly) and timed.  Returns the phase's record."""
    from gmpi_tpu_torch.core.bands import bands_for_config
    from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_chunked, render_mpi_fused

    res, n_l = cfg.resolution, FULL_SCALE_PLANES
    g = torch.Generator(device=dev).manual_seed(40)
    rgba = torch.rand((1, n_l, 4, res, res), device=dev, generator=g)
    cot = torch.randn((1, 3, res, res), device=dev, generator=g)
    t0 = time.perf_counter()
    bands = bands_for_config(cfg, img_size=res, n_planes=n_l, device=dev)
    bands_s = time.perf_counter() - t0
    log(f"tile bands for {n_l} planes at {res}^2: {bands} in {bands_s:.1f} s (planned on "
        f"{dev})")
    kept = {}
    gather, sample = tw.gather_patches, tw.sample_patches

    def recorded_gather(texf, offs, band_x, band_yc, **kw):
        kept["gather"] = (texf, offs, band_x, band_yc)
        return gather(texf, offs, band_x, band_yc, **kw)

    def recorded_sample(*args):
        kept["sample"] = args
        return sample(*args)

    record = {"bands": list(bands), "bands_s": bands_s, "poses": {}}
    gates = {"fused": 5e-4, "fused bf16": FULL_SCALE_BF16_GATE, "banded": 5e-4}
    tw.gather_patches, tw.sample_patches = recorded_gather, recorded_sample
    try:
        for yaw, pitch in FULL_SCALE_POSES:
            geom, rays = preset_rays(cfg, n_l, torch.tensor([[yaw]]), torch.tensor([[pitch]]),
                                     dev)

            def color_and_grad(render):
                x = rgba.clone().requires_grad_()
                color = render(x).color
                return color.detach(), torch.autograd.grad((color * cot).sum(), x)[0]

            oracle, oracle_ms = host_ms(lambda: color_and_grad(
                lambda x: render_mpi_chunked(x, geom.dhw, *rays, plane_chunk=4)))
            exact = color_and_grad(lambda x: types.SimpleNamespace(
                color=chunked_gather_fp64(x, geom.dhw, *rays)))
            exact = tuple(t.float() for t in exact)
            err_o = (rel_err(oracle[0], exact[0]), rel_err(oracle[1], exact[1]))
            log(f"full scale [the float32 chunked gather, yaw {yaw}, pitch {pitch}]: colour "
                f"{err_o[0]:.3e}, rgba gradient {err_o[1]:.3e} of max from its float64 "
                f"evaluation ({card})")
            routes = {
                "fused": lambda x: render_mpi_fused(x, geom.dhw, *rays, with_disp=False),
                "fused bf16": lambda x: render_mpi_fused(x, geom.dhw, *rays, with_disp=False,
                                                         compute_dtype=torch.bfloat16),
                "banded": lambda x: render_mpi(x, geom.dhw, *rays, tiled_bands=bands)}
            pose = {"oracle_ms": oracle_ms, "fp32_oracle_vs_fp64": err_o}
            for name, render in routes.items():
                reset_counts(fr)
                torch.cuda.reset_peak_memory_stats()
                (color, grad), ms = host_ms(lambda: color_and_grad(render))
                launches = read_counts(fr)
                errs = {ref: (rel_err(color, o[0]), rel_err(grad, o[1]))
                        for ref, o in (("fp64", exact), ("fp32", oracle))}
                gated = "fp32" if name == "banded" else "fp64"
                err_c, err_g = errs[gated]
                peak = torch.cuda.max_memory_allocated() / 1e9
                log(f"full scale [{name}, yaw {yaw}, pitch {pitch}, {n_l} x {res}^2]: colour, "
                    f"rgba gradient of max|oracle| against the float64 chunked gather "
                    f"{errs['fp64'][0]:.3e}, {errs['fp64'][1]:.3e}, against the float32 one "
                    f"{errs['fp32'][0]:.3e}, {errs['fp32'][1]:.3e} (gate {gates[name]} on the "
                    f"{gated} one); forward + backward {ms:.1f} ms host-timed (oracle "
                    f"{oracle_ms:.1f}), peak {peak:.2f} GB; launches {launches} ({card})")
                if not (err_c <= gates[name] and err_g <= gates[name]):  # also catches NaN
                    raise RuntimeError(f"full scale [{name}] disagrees with the chunked gather")
                want = {**generator_only(launches),
                        **({"patch_gather": launches["patch_gather"],
                            "patch_sample": launches["patch_gather"]} if name == "banded" else
                           {"fused_fwd": 1, "composite_bwd": 1, "splat": 1})}
                if launches != want or (name == "banded" and not launches["patch_gather"]):
                    raise RuntimeError(f"full scale [{name}] launched {launches}")
                pose[name] = {"rel_err_vs_fp64": errs["fp64"], "rel_err_vs_fp32": errs["fp32"],
                              "ms": ms, "peak_gb": peak, "launches": launches}
            record["poses"][f"{yaw},{pitch}"] = pose
            del oracle, exact, color, grad
            torch.cuda.empty_cache()
    finally:
        tw.gather_patches, tw.sample_patches = gather, sample

    # K8 and K7 at the banded route's own inputs (its last tile-row step)
    record["patch_sample"] = patch_sample_at(tw, kept["gather"], kept.pop("sample"), rates, card,
                                             "the full-scale banded route's inputs")
    record["patch_gather"] = patch_gather_at(pg, *kept.pop("gather"), rates, card,
                                             "the full-scale banded route's inputs")
    return record


def preset_serving(fr, cfg, rates, card, dev):
    """Phase 13c: ``FakeImageGenerator`` at the full width of ``cfg`` (FFHQ1024),
    fused: for each seed ``sample_mpi`` at 96 planes, then ``render`` of 4
    views; one K1 launch a render call, checks as phase 3's, the last render
    against the gather renderer, then K1 at the last render's inputs against
    its plain version and timed beside its bound, and the sampler's graph
    against eager ``generate_mpi`` (``sampler_graph_turns``).  Returns the
    record and K1's timings."""
    from gmpi_tpu_torch.core.renderer import render_mpi
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.models.generator import Generator

    res, n_planes = cfg.resolution, cfg.eval_n_planes
    t0 = time.perf_counter()
    gen = FakeImageGenerator(cfg, Generator(cfg.generator_cfg(),
                                            generator=torch.Generator().manual_seed(0)),
                             use_fused=True, device=dev)
    log(f"generator: {cfg.name} full width ({sum(p.numel() for p in gen.G.parameters())} "
        f"params, {n_planes} planes), built in {time.perf_counter() - t0:.1f} s")
    lo, hi = cfg.planes.min_d * 0.9, cfg.planes.max_d * 1.4
    gen_ms, render_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fr)
    for seed in PRESET_SEEDS:
        mpi, ms = host_ms(lambda: gen.sample_mpi(seed))
        gen_ms.append(ms)
        yv, pv = gen.sample_views(seed, PRESET_VIEWS)
        mpi_v = mpi.expand(PRESET_VIEWS, -1, -1, -1, -1)
        (color, depth), ms = host_ms(lambda: gen.render(mpi_v, yv, pv))
        render_ms.append(ms)
        if mpi.shape != (1, n_planes, 4, res, res) or not torch.isfinite(mpi).all():
            raise RuntimeError(f"{cfg.name} seed {seed}: bad MPI {tuple(mpi.shape)}")
        if color.shape != (PRESET_VIEWS, 3, res, res):
            raise RuntimeError(f"{cfg.name} seed {seed}: bad render shape {tuple(color.shape)}")
    launches = read_counts(fr)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != {**generator_only(launches), "fused_fwd": len(PRESET_SEEDS)}:
        raise RuntimeError(f"{cfg.name} serving launched {launches}, expected one fused_fwd "
                           f"a render call")
    geom, rays = gen.geom, preset_rays(cfg, n_planes, yv, pv, dev)[1]
    with torch.no_grad():
        gather = render_mpi(mpi_v, geom.dhw, *rays)
    err = render_checks(f"{cfg.name} serving", color, depth, gather, lo, hi)
    log(f"13c: {cfg.name} serving, {len(PRESET_SEEDS)} seeds x {PRESET_VIEWS} views x "
        f"{n_planes} planes: launches {launches}; sample_mpi ms {['%.1f' % x for x in gen_ms]}, "
        f"render ms {['%.2f' % x for x in render_ms]} (host clock after synchronize), peak "
        f"{peak:.2f} GB; the last render vs the gather renderer {err:.2e} (gate 5e-4) ({card})")
    del gather
    f = fused_inputs(fr, geom.dhw, *rays, res)
    err_k = check_inference_form(fr, f"{cfg.name} serving inputs, V={PRESET_VIEWS}", mpi_v, *f,
                                 True)
    with torch.no_grad():
        ms = time_ms(lambda: fr.warp_composite_fwd(mpi_v, *f))
        queued = time_ms(lambda: fr.warp_composite_fwd(mpi_v, *f), queued=10)
        plain = time_ms(lambda: fr.warp_composite_fwd_ref(mpi_v, *f), iters=PLAIN_ITERS, warmup=1)
    texels, pairs = needed_work(fr, mpi_v, f[0], f[1], f[3])
    n_pix = f[0].numel()
    n_bytes = texels * 16 + 3 * n_pix * 4 + f[3].numel() * 4 + 6 * n_pix * 4
    b = bound(n_bytes, FLOP_PER_PAIR["fused_fwd"] * pairs, rates)
    log(f"fused_fwd at {cfg.name}'s serving inputs ({PRESET_VIEWS} views x {n_planes} planes, "
        f"{res}^2): {ms:.4f} ms (10 queued: {queued:.4f} a launch), plain {plain:.3f} ms, needs "
        f"{n_bytes} B ({pairs} live pairs); bound {b[0]:.5f} ms by {b[1]} ({card})")
    # K1's bf16 form at the same inputs: 2 bytes a texel
    mpi16 = fr.cast_texture(mpi_v, torch.bfloat16)
    err_k = worse(err_k, check_inference_form(fr, f"bf16 {cfg.name} serving inputs", mpi16, *f,
                                              True))
    with torch.no_grad():
        ms16 = time_ms(lambda: fr.warp_composite_fwd(mpi16, *f))
        plain16 = time_ms(lambda: fr.warp_composite_fwd_ref(mpi16, *f), iters=PLAIN_ITERS,
                          warmup=1)
    texels16, pairs16 = needed_work(fr, mpi16, f[0], f[1], f[3])
    bytes16 = n_bytes - texels * 16 + texels16 * 8
    b16 = bound(bytes16, FLOP_PER_PAIR["fused_fwd"] * pairs16, rates)
    log(f"fused_fwd bf16 at {cfg.name}'s serving inputs: {ms16:.4f} ms, plain {plain16:.3f} ms, "
        f"needs {bytes16} B; bound {b16[0]:.5f} ms by {b16[1]} ({card})")
    record = {"sample_mpi_ms": gen_ms, "render_ms": render_ms, "peak_gb": peak,
              "launches": launches, "vs_gather": err,
              "sampler_graph": sampler_graph_turns(gen, PRESET_SEEDS, card, cfg.name)}
    timing = {"ms": ms, "queued_ms": queued, "plain_ms": plain, "bound_ms": b[0],
              "bound_by": b[1], "max_abs_err": err_k, "bf16_ms": ms16, "bf16_plain_ms": plain16,
              "bf16_bound_ms": b16[0], "bf16_bound_by": b16[1]}
    del gen, mpi, mpi_v, mpi16, color, depth
    torch.cuda.empty_cache()
    return record, timing


@contextlib.contextmanager
def phases_timed(spans):
    """While active, every ``TrainStep``'s D and G phases are timed (host clock
    between ``synchronize`` calls) into ``spans["D ms"]`` / ``spans["G ms"]``,
    one entry a step, and the peak memory of each of 13d's spans is read into
    ``spans["<span> GB"]``: the D phase, G before worst-view selection, worst
    views, G after them."""
    from gmpi_tpu_torch.train.step import TrainStep

    d_phase, g_phase, worst_views = TrainStep.d_phase, TrainStep.g_phase, TrainStep.worst_views

    def peak(span):
        spans.setdefault(f"{span} GB", []).append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    def timed(phase, key, last_span):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = phase(self, *args, **kw)
            torch.cuda.synchronize()
            spans.setdefault(f"{key} ms", []).append((time.perf_counter() - t0) * 1e3)
            peak(last_span)
            return out
        return run

    def worst_views_apart(self, *args, **kw):
        peak("G before worst views")
        out = worst_views(self, *args, **kw)
        torch.cuda.synchronize()
        peak("worst views")
        return out

    TrainStep.d_phase = timed(d_phase, "D", "D phase")
    TrainStep.g_phase = timed(g_phase, "G", "G after worst views")
    TrainStep.worst_views = worst_views_apart
    try:
        yield spans
    finally:
        TrainStep.d_phase, TrainStep.g_phase, TrainStep.worst_views = (d_phase, g_phase,
                                                                       worst_views)


def preset_training(fr, cfg, rates, card, dev):
    """Phase 13d: ``make_train_step`` on ``cfg`` (FFHQ1024: batch 4,
    ``batch_split`` 2, ``d_batch_split``, worst of 4 views at full
    resolution) on one seeded state: ``PRESET_STEPS`` steps as the preset
    stands, one step timed by phase, one past ``lighting_start_iter`` (the
    state stays past it), then ``SWITCH_STEPS`` steps with each memory switch
    (one whole, one timed by phase).  Each run's launches are reset before
    and read after and must be ``step_launches``'s; metrics finite, ``r1 >
    0``; peak GB a run.  Then every parameter of G and D must have changed,
    the ``rgba`` gradient of one G micro-batch must match the gather
    renderer's autograd (1e-3 of max), and the kernels are held and timed at
    that micro-batch's inputs (phase 5's functions).  Returns the record, the
    launches of all runs, the largest kernel errors and the timings."""
    from gmpi_tpu_torch.core import bands as bands_mod
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import plan_fused, render_mpi, render_mpi_fused
    from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step

    res, bs, split = cfg.resolution, cfg.hparams.batch_size, cfg.hparams.batch_split
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    data = torch.Generator().manual_seed(1)
    real = (torch.rand((bs, 3, res, res), generator=data) * 2.0 - 1.0).to(dev)
    real_c2w, _, _ = poses.sample_sphere_poses(data, bs, cfg.camera, device=dev)
    real_pose = flat_pose_from_c2w(real_c2w, cfg.train.d_cond_pose_dim)
    log(f"train state: {cfg.name} full width (G {sum(p.numel() for p in state.G.parameters())} "
        f"params, D {sum(p.numel() for p in state.D.parameters())}), batch {bs}, batch_split "
        f"{split}, d_batch_split {cfg.train.d_batch_split}, {cfg.planes.n_planes} planes, worst "
        f"of {cfg.train.n_view_per_z} views; built in {time.perf_counter() - t0:.1f} s")
    before = {"G": snapshot(state.G.parameters()), "D": snapshot(state.D.parameters())}
    rng = torch.Generator().manual_seed(2)
    runs, all_launches = {}, no_counts(fr)
    for label, switches in (("preset", {}),) + memory_switches(res):
        run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **switches))
        step = make_train_step(run_cfg, device=dev)
        if not step.use_fused:
            raise RuntimeError("the train step did not select the fused renderer on a card")
        n_whole = sum(PRESET_STEPS) if label == "preset" else SWITCH_STEPS - 1
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fr)
        step_ms, metrics = [], []
        for _ in range(n_whole):
            (_, m), ms = host_ms(lambda: step(state, real, real_pose, rng))
            step_ms.append(ms)
            metrics.append(m)
        # one step by phase, each phase's peak apart, worst-view selection's inside G's
        spans = {"whole steps GB": [torch.cuda.max_memory_allocated() / 1e9]}
        with phases_timed(spans):
            (_, m), _ = host_ms(lambda: step(state, real, real_pose, rng))
        metrics.append(m)
        d_ms, g_ms = spans.pop("D ms")[0], spans.pop("G ms")[0]
        peaks = {k[:-3]: v[0] for k, v in spans.items()}
        if label == "preset":  # past the lighting augmentation's start, for this and later runs
            state.step = cfg.train.lighting_start_iter + 500
            torch.cuda.reset_peak_memory_stats()
            (_, m), lit_ms = host_ms(lambda: step(state, real, real_pose, rng))
            peaks["lit step"] = torch.cuda.max_memory_allocated() / 1e9
            step_ms.append(lit_ms)
            metrics.append(m)
        launches = read_counts(fr)
        peak = max(peaks.values())
        want = {**generator_only(launches), **scaled(step_launches(run_cfg), len(metrics))}
        if launches != want:
            raise RuntimeError(f"{cfg.name} [{label}] launched {launches} in {len(metrics)} "
                               f"steps, expected {want}")
        for i, m in enumerate(metrics):
            vals = {key: float(val) for key, val in m.items()}
            if not all(x == x and abs(x) != float("inf") for x in vals.values()):
                raise RuntimeError(f"{cfg.name} [{label}] step {i}: non-finite metric {vals}")
            if not vals["r1"] > 0:
                raise RuntimeError(f"{cfg.name} [{label}] step {i}: r1 = {vals['r1']}")
        log(f"13d: {cfg.name} [{label}]: {len(metrics)} steps, launches {launches} (a step "
            f"{step_launches(run_cfg)}); whole steps ms {['%.1f' % x for x in step_ms]}, one by "
            f"phase D {d_ms:.1f} + G {g_ms:.1f}; peak {peak:.2f} GB (by span "
            + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + "); last metrics "
            + ", ".join(f"{k} {float(v):.4f}" for k, v in metrics[-1].items()) + f" ({card})")
        runs[label] = {"switches": switches, "step_ms": step_ms, "d_ms": d_ms, "g_ms": g_ms,
                       "peak_gb": peak, "peak_gb_by_span": peaks, "launches": launches}
        all_launches += launches
        del step
    for part in ("G", "D"):
        module = getattr(state, part)
        still = [name for (name, p), b in zip(module.named_parameters(), before[part])
                 if torch.equal(p.detach(), b)]
        if still:
            raise RuntimeError(f"{cfg.name}: {len(still)} {part} parameters did not change over "
                               f"13d's steps: {still[:5]}")
    del before

    # one G micro-batch: the rgba gradient against the gather renderer's autograd, then
    # the kernels held and timed at its inputs (and at the step's no-grad renders')
    step = make_train_step(cfg, device=dev)
    mbs = bs // split
    z = torch.randn((bs, cfg.train.z_dim), generator=rng).to(dev)
    with torch.no_grad():
        mpi = step.synth(state.G, z, rng)
    del state, real, real_pose
    torch.cuda.empty_cache()
    yv, pv = step.sample_views(rng, mbs)
    geom, rays = preset_rays(cfg, cfg.planes.n_planes, yv, pv, dev)
    cot = torch.randn((mbs, 3, res, res), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(41))
    grads = []
    for render in (render_mpi_fused, render_mpi):
        x = mpi[:mbs].clone().requires_grad_()
        grads.append(torch.autograd.grad((render(x, geom.dhw, *rays).color * cot).sum(), x)[0])
    err_g = rel_err(grads[0], grads[1])
    log(f"{cfg.name} G micro-batch rgba gradient, fused Function vs gather autograd: rel err "
        f"{err_g:.3e} (gate {GRAD_REL})")
    if not err_g <= GRAD_REL:
        raise RuntimeError(f"{cfg.name}: the fused gradient disagrees with the gather renderer's")
    del grads, x
    corner = bands_mod._corner_rays(cfg.camera, cfg.fov_deg, res, res, device=dev)
    adj_bands = plan_fused(geom.dhw, *corner, res, res)[1][0]
    errs, k = backward_kernels_at(fr, mpi[:mbs].contiguous(), geom.dhw, rays, cot, adj_bands,
                                  rates, card, plain_iters=PLAIN_ITERS)
    n_cand = cfg.train.n_view_per_z
    yv_w, pv_w = step.sample_views(rng, bs * n_cand)
    rays_w = fused_inputs(fr, geom.dhw, *preset_rays(cfg, cfg.planes.n_planes, yv_w, pv_w,
                                                     dev)[1], res)
    err_f, forms = no_grad_forms_at(fr, mpi[:mbs].contiguous(), fused_inputs(fr, geom.dhw, *rays,
                                                                             res),
                                    mpi, rays_w, rates, card, plain_iters=PLAIN_ITERS)
    errs["fused_fwd"] = err_f
    del mpi
    torch.cuda.empty_cache()
    record = {"runs": runs, "grad_vs_gather": err_g}
    return record, all_launches, errs, {**k, **forms}


def write_afhq_dataset(root, n_images, res, seed):
    """An AFHQ-cat style folder in ``root``: ``n_images`` seeded noise PNGs of
    ``res``^2 and an EG3D ``dataset.json`` whose labels hold a random
    camera-to-world matrix and 9 intrinsics each (as
    ``tests/test_torch_data.py`` writes them).  Returns the folder."""
    import json
    import os

    import numpy as np
    from PIL import Image
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "afhq")
    os.makedirs(folder)
    labels = []
    for i in range(n_images):
        name = f"cat{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (res, res, 3), dtype=np.uint8)).save(
            os.path.join(folder, name))
        c2w = np.eye(4)
        c2w[:3, :3] = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        c2w[:3, 3] = rng.standard_normal(3) * 2.0 + np.array([0, 0, 3.0])
        labels.append([name, list(c2w.reshape(-1)) + [0.0] * 9])
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    return folder


def prepare_fake_routes(fr, tw, pg, label, cfg, ckpt_dir, routes, tmp, card, dev):
    """``eval_gmpi_torch.main --task prepare_fake`` of ``PRESET_FAKES`` fakes
    at ``cfg``'s eval planes from the checkpoint in ``ckpt_dir``, by each of
    ``routes`` (``"banded"``, the default, and ``"fused"``,
    ``--fused_renderer``), into ``tmp/<label> <route>``.  Launches are reset
    before and read after each call: banded, one patch gather and one tap
    sampler a tile-row step; fused, one forward an image; nothing else.  The banded generator's
    planning (``bands_for_config`` on the card) is timed apart.  On the banded
    run's own last inputs K7 must equal its plain version and the banded
    render be within 5e-4 of the gather renderer; with both routes the dumps
    must be at most 1 level apart.  The banded call runs under
    ``torch.profiler``: K7's and K8's device ms an image (their kernels'
    summed durations over the fakes) go into the record, and it must open
    one ``render.composite`` span a banded render call.  Returns the record
    (with each route's dump directory) and the launches by route."""
    import copy
    import os

    import eval_gmpi_torch
    from gmpi_tpu_torch.eval import harness

    common = ["--dataset", cfg.name, "--task", "prepare_fake", "--ckpt", ckpt_dir,
              "--n_planes", str(cfg.eval_n_planes), "--n_imgs", str(PRESET_FAKES),
              "--device", str(dev)]
    kept, row_steps, renders, plan_s = {}, {"n": 0}, {"n": 0}, []
    row_step, gather = tw._warp_row_tiles, tw.gather_patches
    render, plan = harness.FakeImageGenerator.render, harness.bands_for_config

    def counted_row_step(*a, **kw):
        row_steps["n"] += 1
        return row_step(*a, **kw)

    def recorded_gather(texf, offs, band_x, band_yc, **kw):
        kept["gather"] = (texf, offs, band_x, band_yc)
        return gather(texf, offs, band_x, band_yc, **kw)

    def recorded_render(gen, mpi, yaws, pitches):
        if not gen.use_fused:
            kept["render"] = (gen, mpi, yaws, pitches)
            renders["n"] += 1
        return render(gen, mpi, yaws, pitches)

    def timed_plan(*a, **kw):
        t0 = time.perf_counter()
        bands = plan(*a, **kw)
        plan_s.append(time.perf_counter() - t0)  # its ints are on the host: the card is done
        return bands

    tw._warp_row_tiles, tw.gather_patches = counted_row_step, recorded_gather
    harness.FakeImageGenerator.render, harness.bands_for_config = recorded_render, timed_plan
    eval_s, launches, dirs = {}, {}, {}
    try:
        for route in routes:
            reset_counts(fr)
            row_steps["n"] = 0
            dirs[route] = os.path.join(tmp, f"{label} {route}")
            argv = common + (["--fused_renderer"] if route == "fused" else []) + [
                "--out", dirs[route]]
            t0 = time.perf_counter()
            if route == "banded":
                renders["n"] = 0
                per_image, spans = kernel_ms_per_image(
                    lambda: eval_gmpi_torch.main(argv), ("patch_gather", "patch_sample"),
                    PRESET_FAKES, spans=("render.composite",))
                if spans["render.composite"] != renders["n"] or not renders["n"]:
                    raise RuntimeError(f"{label}: {cfg.name} prepare_fake [banded] opened "
                                       f"{spans['render.composite']} render.composite spans "
                                       f"for {renders['n']} banded render calls")
            else:
                eval_gmpi_torch.main(argv)
            eval_s[route] = time.perf_counter() - t0
            launches[route] = read_counts(fr)
            want = {**generator_only(launches[route]),
                    **({"patch_gather": row_steps["n"], "patch_sample": row_steps["n"]}
                       if route == "banded" else {"fused_fwd": PRESET_FAKES})}
            if launches[route] != want or (route == "banded" and not row_steps["n"]):
                raise RuntimeError(f"{label}: {cfg.name} prepare_fake [{route}] launched "
                                   f"{launches[route]}, expected {want}")
    finally:
        tw._warp_row_tiles, tw.gather_patches = row_step, gather
        harness.FakeImageGenerator.render, harness.bands_for_config = render, plan
    worst = share = None
    if len(dirs) == 2:
        worst, share = _pngs_apart(*(os.path.join(d, "rgb") for d in dirs.values()))
    texf, offs, band_x, band_yc = kept.pop("gather")
    same = torch.equal(pg.gather_patches(texf, offs, band_x, band_yc),
                       pg.gather_patches_ref(texf, offs, band_x, band_yc))
    gen, mpi, yaws, pitches = kept.pop("render")
    plain = copy.copy(gen)
    plain.tiled_bands = None
    color, depth = gen.render(mpi, yaws, pitches)
    color_g, depth_g = plain.render(mpi, yaws, pitches)
    err = max(float((color - color_g).abs().max()), float((depth - depth_g).abs().max()))
    log(f"{label}: eval_gmpi_torch.main --task prepare_fake on the {cfg.name} checkpoint, "
        f"{PRESET_FAKES} fakes x {cfg.eval_n_planes} planes: "
        + ", ".join(f"{route} {sec:.1f} s" for route, sec in eval_s.items())
        + f" (the banded generator's tile bands {gen.tiled_bands} planned on {dev} in "
        f"{', '.join('%.2f' % x for x in plan_s)} s); launches {launches}"
        + (f"; dumps at most {worst} level apart ({share:.3e} of pixel channels differ)"
           if worst is not None else "")
        + f"; device ms an image under the profiler: K7 {per_image['patch_gather']:.4f}, "
        f"K8 {per_image['patch_sample']:.4f}; render.composite spans "
        f"{spans['render.composite']} for {renders['n']} banded render calls"
        + f"; K7 on the banded run's last inputs {tuple(texf.shape)} equal to its plain "
        f"version: {same}; its last banded render vs the gather renderer {err:.2e} (gate "
        f"5e-4) ({card})")
    if (worst is not None and worst > 1) or not same or not err <= 5e-4:
        raise RuntimeError(f"{label}: {cfg.name} prepare_fake: the dumps, the patch gather or "
                           f"the banded render disagree")
    return {"seconds": eval_s, "plan_s": plan_s, "launches": launches, "max_level_apart": worst,
            "k7_exact": same, "banded_vs_gather": err, "dirs": dirs,
            "kernel_ms_per_image": per_image, "composite_spans": spans["render.composite"],
            "banded_renders": renders["n"]}, launches


def kernel_ms_per_image(fn, names, n_images, spans=()):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA): for each of
    ``names``, the summed device ms of the kernels whose names hold it, over
    ``n_images``; and for each of ``spans``, how many host spans of that
    name it opened."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    return ({name: sum(e.time_range.elapsed_us() for e in device if name in e.name) / 1e3
             / n_images for name in names}, {span: host.count(span) for span in spans})


def preset_loop_eval(fr, tw, pg, card, dev, tmp):
    """Phase 13e, through the entry points: ``train_gmpi_torch.main
    --dataset FFHQ1024`` on ``PRESET_IMAGES`` noise PNGs of 1024^2 for
    ``PRESET_LOOP_STEPS[0]`` steps (its checkpoint loaded into a fresh state
    must equal the live state bitwise), resumed to ``PRESET_LOOP_STEPS[1]``;
    ``eval_gmpi_torch.main --task prepare_fake`` on that checkpoint,
    banded and ``--fused_renderer`` (dumps at most 1 level apart, launches per
    route, K7 equal to its plain version and the banded render within 5e-4
    of the gather renderer on the banded run's own last inputs); then
    ``train_gmpi_torch.main --dataset AFHQCat`` on a folder of 512^2 PNGs
    with an EG3D ``dataset.json`` for ``PRESET_LOOP_STEPS[0]`` steps, and 4
    views of one of its MPIs through K1 against the gather renderer.
    Returns the record and the launches of its main paths; writes under
    ``tmp``."""
    import os

    import train_gmpi_torch
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core.renderer import render_mpi
    from gmpi_tpu_torch.eval import harness
    from gmpi_tpu_torch.train import checkpoint as ckpt_mod
    from gmpi_tpu_torch.train import init_train_state
    from gmpi_tpu_torch.train.loop import LoopStats

    record, paths = {}, []
    ffhq = get_config("FFHQ1024")
    t0 = time.perf_counter()
    zpath, pose_dir = write_ffhq_dataset(tmp, PRESET_IMAGES, ffhq.resolution, seed=10)
    log(f"dataset: {PRESET_IMAGES} noise PNGs of {ffhq.resolution}^2 in a zip "
        f"({os.path.getsize(zpath)} B), one fail-listed, written in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "ffhq1024")
    ckpt_dir = os.path.join(out, "checkpoints")
    args = ["--dataset", "FFHQ1024", "--data_root", zpath, "--pose_root", pose_dir,
            "--output_dir", out, "--seed", "5", "--device", str(dev)]
    first, last = PRESET_LOOP_STEPS
    reset_counts(fr)
    stats1 = LoopStats()
    state = train_gmpi_torch.main(args + ["--total_iters", str(first)], stats=stats1)
    fresh = init_train_state(ffhq, torch.Generator().manual_seed(77), device=dev)
    loaded = ckpt_mod.load_checkpoint(ckpt_dir, fresh)
    restored = same_tree(ckpt_mod.state_payload(loaded), ckpt_mod.state_payload(state))
    if state.step != first or not restored:
        raise RuntimeError(f"FFHQ1024 train CLI ended at step {state.step}; checkpoint bitwise "
                           f"the live state: {restored}")
    del state, fresh, loaded
    torch.cuda.empty_cache()
    stats2 = LoopStats()
    state = train_gmpi_torch.main(args + ["--total_iters", str(last)], stats=stats2)
    if stats2.start_step != first or state.step != last:
        raise RuntimeError(f"the resumed FFHQ1024 run went from {stats2.start_step} to "
                           f"{state.step}, expected {first} to {last}")
    del state
    torch.cuda.empty_cache()
    launches = read_counts(fr)
    want = {**generator_only(launches), **scaled(step_launches(ffhq), last)}
    if launches != want:
        raise RuntimeError(f"the FFHQ1024 train CLI launched {launches} in {last} steps, "
                           f"expected {want}")
    for st in (stats1, stats2):
        for m in st.metrics:
            if not all(v == v and abs(v) != float("inf") for v in m.values()) or not m["r1"] > 0:
                raise RuntimeError(f"FFHQ1024 loop: bad metrics {m}")
    paths.append(launches)
    steps = stats1.step_ms + stats2.step_ms
    log(f"13e: train_gmpi_torch.main --dataset FFHQ1024: {first} steps, a checkpoint of "
        f"{stats1.save_bytes[-1]} B saved in {stats1.save_s[-1]:.2f} s and loaded back bitwise, "
        f"resumed from step {stats2.start_step} to {last} (load {stats2.load_s:.2f} s); step ms "
        f"{['%.1f' % x for x in steps]}, data wait ms "
        f"{['%.2f' % x for x in stats1.data_wait_ms + stats2.data_wait_ms]}; launches "
        f"{launches} ({card})")
    record["ffhq1024_loop"] = {"step_ms": steps, "save_s": stats1.save_s + stats2.save_s,
                               "save_bytes": stats1.save_bytes + stats2.save_bytes,
                               "load_s": stats2.load_s, "launches": launches}

    # prepare_fake on that checkpoint, banded then fused
    record["ffhq1024_eval"], eval_launches = prepare_fake_routes(
        fr, tw, pg, "13e", ffhq, ckpt_dir, ("banded", "fused"), tmp, card, dev)
    paths += list(eval_launches.values())
    torch.cuda.empty_cache()

    # AFHQCat at 512^2 from a folder with an EG3D dataset.json
    afhq = get_config("AFHQCat")
    folder = write_afhq_dataset(tmp, PRESET_IMAGES, afhq.resolution, seed=11)
    reset_counts(fr)
    stats = LoopStats()
    state = train_gmpi_torch.main(["--dataset", "AFHQCat", "--data_root", folder,
                                   "--pose_root", folder, "--output_dir",
                                   os.path.join(tmp, "afhq_run"), "--seed", "6",
                                   "--total_iters", str(first), "--device", str(dev)],
                                  stats=stats)
    launches = read_counts(fr)
    want = {**generator_only(launches), **scaled(step_launches(afhq), first)}
    if state.step != first or launches != want:
        raise RuntimeError(f"the AFHQCat train CLI ended at step {state.step} with launches "
                           f"{launches}, expected {first} steps and {want}")
    for m in stats.metrics:
        if not all(v == v and abs(v) != float("inf") for v in m.values()) or not m["r1"] > 0:
            raise RuntimeError(f"AFHQCat loop: bad metrics {m}")
    paths.append(launches)
    gen = harness.FakeImageGenerator(afhq, state.G, use_fused=True, device=dev)
    mpi = gen.sample_mpi(0)
    yv, pv = gen.sample_views(0, PRESET_VIEWS)
    mpi_v = mpi.expand(PRESET_VIEWS, -1, -1, -1, -1)
    reset_counts(fr)
    color, depth = gen.render(mpi_v, yv, pv)
    render_launches = read_counts(fr)
    if render_launches != {**generator_only(render_launches), "fused_fwd": 1}:
        raise RuntimeError(f"an AFHQCat render launched {render_launches}")
    paths.append(render_launches)
    _, rays = preset_rays(afhq, afhq.eval_n_planes, yv, pv, dev)
    with torch.no_grad():
        gather = render_mpi(mpi_v, gen.geom.dhw, *rays)
    err_a = render_checks("AFHQCat render", color, depth, gather, afhq.planes.min_d * 0.9,
                          afhq.planes.max_d * 1.4)
    err_k = check_inference_form(fr, f"AFHQCat render inputs, V={PRESET_VIEWS}", mpi_v,
                                 *fused_inputs(fr, gen.geom.dhw, *rays, afhq.resolution), False)
    log(f"13e: train_gmpi_torch.main --dataset AFHQCat ({PRESET_IMAGES} PNGs of "
        f"{afhq.resolution}^2, dataset.json poses): {first} steps, step ms "
        f"{['%.1f' % x for x in stats.step_ms]}, launches {launches}; {PRESET_VIEWS} views x "
        f"{afhq.eval_n_planes} planes of one of its MPIs through K1 vs the gather renderer "
        f"{err_a:.2e} (gate 5e-4) ({card})")
    record["afhqcat"] = {"step_ms": stats.step_ms, "launches": launches, "vs_gather": err_a}
    del state, gen, mpi, mpi_v, gather
    torch.cuda.empty_cache()
    return record, paths, err_k


def presets_phase(fr, tw, pg, card, rates, dev):
    """Phase 13: the 1024^2 and 512^2 presets at full width (13a kernels, 13b
    the full-scale tier, 13c FFHQ1024 serving, 13d FFHQ1024 training with
    each memory switch, 13e the train and eval entry points on FFHQ1024 and
    AFHQCat).  Returns ``(record, launches of its main paths, largest kernel
    errors, kernel timings at 1024^2)``."""
    import shutil
    import tempfile

    from gmpi_tpu_torch.config import get_config

    ffhq, metfaces = get_config("FFHQ1024"), get_config("MetFaces")
    log(f"phase 13 depth (widths are the presets'): {len(PRESET_SEEDS)} serving seeds x "
        f"{PRESET_VIEWS} views, {sum(PRESET_STEPS)} + 1 preset steps and {SWITCH_STEPS} a "
        f"memory switch, {PRESET_IMAGES} PNGs a dataset, {PRESET_LOOP_STEPS} CLI steps, "
        f"{PRESET_FAKES} fakes a route")
    laps, t0 = {}, time.perf_counter()

    def lap(name):
        laps[name] = time.perf_counter() - t0 - sum(laps.values())
        log(f"phase {name}: {laps[name]:.1f} s")

    errs = preset_kernels(fr, ffhq, metfaces, dev)
    lap("13a")
    full = full_scale_checks(fr, tw, pg, ffhq, rates, card, dev)
    torch.cuda.empty_cache()
    lap("13b")
    serving, k1_serving = preset_serving(fr, ffhq, rates, card, dev)
    lap("13c")
    training, train_launches, train_errs, k = preset_training(fr, ffhq, rates, card, dev)
    for kname, e in train_errs.items():
        errs[kname] = worse(errs[kname], e)
    errs["fused_fwd"] = worse(errs["fused_fwd"], k1_serving["max_abs_err"])
    lap("13d")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_presets_")
    try:
        loop_eval, paths, err_k = preset_loop_eval(fr, tw, pg, card, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errs["fused_fwd"] = worse(errs["fused_fwd"], err_k)
    lap("13e")
    paths = [serving["launches"], train_launches] + paths
    timings = {"fused_fwd": {**k1_serving, "train_form_ms": k["fwd_train"],
                             "train_form_plain_ms": k["fwd_train_plain"],
                             "train_form_bound_ms": k["bounds"]["fused_fwd_train"][0],
                             **{key: val for key, val in k.items() if "_form_" in key}},
               "composite_bwd": {"ms": k["bwd"], "queued_ms": k["bwd_queued"],
                                 "plain_ms": k["bwd_plain"],
                                 "bound_ms": k["bounds"]["composite_bwd"][0],
                                 "bound_by": k["bounds"]["composite_bwd"][1]},
               "splat": {"ms": k["splat"], "queued_ms": k["splat_queued"],
                         "plain_ms": k["splat_plain"], "library_ms": k["splat_lib"],
                         "direct_path_ms": k["splat_direct"], "bound_ms": k["bounds"]["splat"][0],
                         "bound_by": k["bounds"]["splat"][1]},
               "adjoint": {"ms": k["adj"], "queued_ms": k["adj_queued"], "plain_ms": k["adj_plain"],
                           "library_ms": k["splat_lib"], "bound_ms": k["bounds"]["adjoint"][0],
                           "bound_by": k["bounds"]["adjoint"][1]},
               "patch_gather": full.pop("patch_gather"),
               "patch_sample": full.pop("patch_sample")}
    for kname, t in timings.items():
        t["launches"] = sum(path.get(kname, 0) for path in paths)
    record = {"full_scale": full, "serving": serving, "training": training,
              "loop_eval": loop_eval, "seconds": laps}
    return record, paths, errs, timings


# phase 14: the tile-banded route on the card (widths are the presets')
BANDED_PRESETS = ("FFHQ256", "FFHQ512", "FFHQ1024", "AFHQCat", "MetFaces")
BANDED_PLAN_POSES = 64  # sampled poses at which each card plan is held, besides the 9 corners
BANDED_TRAIN = ("FFHQ256", "FFHQ1024")  # trained through --no_fused_renderer
FUSED_TRAIN = ("FFHQ512", "AFHQCat", "MetFaces")  # trained through the fused default
EVAL_BANDED = ("FFHQ1024", "MetFaces")  # 14c: prepare_fake on eval's default route
EVAL_512 = ("FFHQ512", "AFHQCat")  # 14e: prepare_fake on both routes at 512^2
BANDED_LOOP_STEPS = (1, 2)  # train CLI steps, then resumed to (a FFHQ1024 step takes ~53 s)
FUSED_LOOP_STEPS = 2


def write_metfaces_dataset(root, n_images, res, seed):
    """A MetFaces-style dataset in ``root``: a folder of ``n_images`` seeded
    noise PNGs of ``res``^2 and a pose folder with a Deep3DFace ``.mat`` file
    per image under ``coeffs/``.  Returns ``(image folder, pose folder)``."""
    import os

    import numpy as np
    import scipy.io as sio
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder, pose_dir = os.path.join(root, "metfaces"), os.path.join(root, "metfaces_poses")
    os.makedirs(folder)
    os.makedirs(os.path.join(pose_dir, "coeffs"))
    for i in range(n_images):
        Image.fromarray(rng.integers(0, 256, (res, res, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"{i:05d}.png"))
        sio.savemat(os.path.join(pose_dir, "coeffs", f"{i:05d}.mat"), {
            "angle": (rng.standard_normal((1, 3)) * 0.2).astype(np.float32),
            "trans": (rng.standard_normal((1, 3)) * 0.1).astype(np.float32)})
    return folder, pose_dir


def planning_checks(card, dev):
    """Phase 14a: ``bands_for_config`` at each preset's eval size (its
    resolution, 96 planes: what the banded ``FakeImageGenerator`` plans) on
    the card, twice (the first call meets its kernels for the first time),
    and on the host, each timed; the two plans must be equal tuples, or else
    the card's plan must still cover.  Either way the card's plan must cover
    the spans that ``required_spans`` measures on the card at the 9 corner
    poses and at ``BANDED_PLAN_POSES`` sampled poses (forward bands and the
    tiled adjoint's output bands; the warp monotone).  Returns the record."""
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import bands as bands_mod
    from gmpi_tpu_torch.core import poses

    record = {}
    for name in BANDED_PRESETS:
        cfg = get_config(name)
        res, n_l = cfg.resolution, cfg.eval_n_planes
        card_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = bands_mod.bands_for_config(cfg, img_size=res, n_planes=n_l, device=dev)
            card_s.append(time.perf_counter() - t0)  # its ints are on the host: the card is done
        t0 = time.perf_counter()
        host = bands_mod.bands_for_config(cfg, img_size=res, n_planes=n_l, device="cpu")
        host_s = time.perf_counter() - t0
        yaws, pitches = poses.sample_yaw_pitch(torch.Generator().manual_seed(60),
                                               BANDED_PLAN_POSES, cfg.camera, device=dev)
        geom, sampled = preset_rays(cfg, n_l, yaws, pitches, dev)
        corners = bands_mod._corner_rays(cfg.camera, cfg.fov_deg, res, res, device=dev)
        spans = {which: bands_mod.required_spans(geom.dhw, rays, res, res)
                 for which, rays in (("corners", corners), ("sampled", sampled))}
        covered = len(plan) == 4 and all(None not in sp and all(a <= b for a, b in zip(sp, plan))
                                         for sp in spans.values())
        log(f"14a: {name} tile bands for {n_l} planes at {res}^2 (band_y, band_x, adjoint rows, "
            f"cols): on the card {plan} in {card_s[0]:.3f} s, again {card_s[1]:.3f} s; on the "
            f"host {host} in {host_s:.2f} s; equal {plan == host}; spans without margin at the "
            f"9 corners {spans['corners']}, at {BANDED_PLAN_POSES} sampled poses "
            f"{spans['sampled']}: covered {covered} ({card})")
        if not covered:
            raise RuntimeError(f"{name}: the card's tile bands {plan} do not cover {spans}")
        if plan != host:
            log(f"14a: {name}: the card's plan {plan} differs from the host's {host} (a rounding "
                f"edge); the card's plan covers and is the one the port uses")
        record[name] = {"card": list(plan), "host": list(host), "card_s": card_s,
                        "host_s": host_s, "equal": plan == host,
                        "spans": {k: list(v) for k, v in spans.items()}}
    return record


def banded_training(fr, tw, pg, card, dev, tmp, name):
    """Phase 14b: ``train_gmpi_torch.main --no_fused_renderer`` on preset
    ``name`` (its batch, split, planes and views) from ``PRESET_IMAGES``
    noise PNGs in a zip, ``BANDED_LOOP_STEPS[0]`` steps, resumed to
    ``BANDED_LOOP_STEPS[1]``, with each step's D and G phases timed and
    peaks read by span (``phases_timed``).  Launches are reset before and read
    after both runs: one patch gather and one tap sampler a tile-row step
    of the tiled warp, nothing else.  In each of the step's D phase, worst-view selection and
    G phase, the first K7 call of each input shape (texture group, offsets,
    bands) is held exactly against ``gather_patches_ref`` on the same inputs,
    in the step (a transient copy of that call's patches, once a key).
    Metrics finite, ``r1 > 0``; every parameter of G and D moved from the
    CLI's initial weights; then a G micro-batch's ``rgba`` gradient through
    the step's banded render (K7, the tiled adjoint) against the gather
    renderer's autograd (1e-3 of max).  Returns the record, the
    launches, the checkpoint directory and the dataset's ``(data_root,
    pose_root)``."""
    import os

    import train_gmpi_torch
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core.renderer import render_mpi
    from gmpi_tpu_torch.train import init_train_state, make_train_step
    from gmpi_tpu_torch.train.loop import LoopStats
    from gmpi_tpu_torch.train.step import TrainStep

    cfg = get_config(name)
    res, bs, split = cfg.resolution, cfg.hparams.batch_size, cfg.hparams.batch_split
    root = os.path.join(tmp, f"banded {name}")
    os.makedirs(root)
    # a batch and more once the fail list leaves one out (FFHQ256's batch is 8)
    zpath, pose_dir = write_ffhq_dataset(root, max(PRESET_IMAGES, bs + 2), res, seed=12)
    out = os.path.join(root, "run")
    args = ["--dataset", name, "--data_root", zpath, "--pose_root", pose_dir, "--output_dir",
            out, "--seed", "5", "--device", str(dev), "--no_fused_renderer"]
    first, last = BANDED_LOOP_STEPS
    spans, row_steps, k7_equal, span = {}, {"n": 0}, {}, {"name": None}
    row_step, gather = tw._warp_row_tiles, tw.gather_patches
    step_spans = {k: getattr(TrainStep, k) for k in ("d_phase", "worst_views", "g_phase")}

    def in_span(fn, label):
        def run(self, *a, **kw):
            outer, span["name"] = span["name"], label
            try:
                return fn(self, *a, **kw)
            finally:
                span["name"] = outer
        return run

    def counted_row_step(*a, **kw):
        row_steps["n"] += 1
        return row_step(*a, **kw)

    def checked_gather(texf, offs, band_x, band_yc, **kw):
        out = gather(texf, offs, band_x, band_yc, **kw)
        key = (span["name"], tuple(texf.shape), tuple(offs.shape), band_x, band_yc,
               str(texf.dtype))
        if key not in k7_equal:
            k7_equal[key] = torch.equal(out, pg.gather_patches_ref(texf, offs, band_x, band_yc))
        return out

    tw._warp_row_tiles, tw.gather_patches = counted_row_step, checked_gather
    reset_counts(fr)
    try:
        with phases_timed(spans):
            for k, label in (("d_phase", "D"), ("worst_views", "worst views"), ("g_phase", "G")):
                setattr(TrainStep, k, in_span(getattr(TrainStep, k), label))
            stats1 = LoopStats()
            state = train_gmpi_torch.main(args + ["--total_iters", str(first)], stats=stats1)
            if state.step != first:
                raise RuntimeError(f"{name} banded train CLI ended at step {state.step}")
            del state
            torch.cuda.empty_cache()
            stats2 = LoopStats()
            state = train_gmpi_torch.main(args + ["--total_iters", str(last)], stats=stats2)
    finally:
        tw._warp_row_tiles, tw.gather_patches = row_step, gather
        for k, fn in step_spans.items():
            setattr(TrainStep, k, fn)
    launches = read_counts(fr)
    want = {**generator_only(launches), "patch_gather": row_steps["n"],
            "patch_sample": row_steps["n"]}
    if launches != want or not row_steps["n"]:
        raise RuntimeError(f"the {name} banded train CLI launched {launches}, expected {want}")
    k7_shapes = [f"{k[0]}: {k[1]} at {k[2][:2]} offsets -> {k[3]}x{k[4]}" for k in k7_equal]
    log(f"14b: {name}: K7 in the banded steps vs gather_patches_ref on the same inputs, the "
        f"first call of each of {len(k7_equal)} spans and input shapes (texture group "
        f"[N, Wp, Hp*C]): "
        + "; ".join(f"{sh} equal {ok}" for sh, ok in zip(k7_shapes, k7_equal.values())))
    missed = {"D", "worst views", "G"} - {k[0] for k in k7_equal}
    if missed or not all(k7_equal.values()):
        raise RuntimeError(f"{name}: K7 in the banded step disagrees with its plain version "
                           f"or was not checked in {missed}")
    if stats2.start_step != first or state.step != last:
        raise RuntimeError(f"the resumed {name} banded run went from {stats2.start_step} to "
                           f"{state.step}, expected {first} to {last}")
    metrics = stats1.metrics + stats2.metrics
    for m in metrics:
        if not all(v == v and abs(v) != float("inf") for v in m.values()) or not m["r1"] > 0:
            raise RuntimeError(f"{name} banded loop: bad metrics {m}")
    init = init_train_state(cfg, torch.Generator().manual_seed(5), device=dev)  # the CLI's seed
    for part in ("G", "D"):
        still = [k for (k, p), (_, p0) in zip(getattr(state, part).named_parameters(),
                                               getattr(init, part).named_parameters())
                 if torch.equal(p.detach(), p0.detach())]
        if still:
            raise RuntimeError(f"{name} banded: {len(still)} {part} parameters did not move "
                               f"from the initial weights: {still[:5]}")
    del init

    # a G micro-batch's rgba gradient: the step's banded render against the gather's
    step = make_train_step(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, use_fused_renderer=False)), device=dev)
    if len(step.tiled_bands) != 4:
        raise RuntimeError(f"{name}: the banded step planned bands {step.tiled_bands}, with no "
                           f"tiled adjoint")
    rng = torch.Generator().manual_seed(3)
    mbs = bs // split
    with torch.no_grad():
        mpi = step.synth(state.G, torch.randn((mbs, cfg.train.z_dim), generator=rng).to(dev), rng)
    del state
    torch.cuda.empty_cache()
    yv, pv = step.sample_views(rng, mbs)
    geom, rays = preset_rays(cfg, cfg.planes.n_planes, yv, pv, dev)
    cot = torch.randn((mbs, 3, res, res), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(42))
    x = mpi.clone().requires_grad_()
    before = read_counts(fr)
    imgs, _, _ = step.render_views(x, yv, pv)
    k78 = {k: read_counts(fr)[k] - before[k] for k in ("patch_gather", "patch_sample")}
    if not k78["patch_gather"] == k78["patch_sample"] > 0:  # the taps, under autograd
        raise RuntimeError(f"{name}: the banded step's G render launched {k78} of K7 and K8")
    grad_b = torch.autograd.grad((imgs * cot).sum(), x)[0]
    x = mpi.clone().requires_grad_()
    grad_g = torch.autograd.grad(((render_mpi(x, geom.dhw, *rays).color * 2.0 - 1.0)
                                  * cot).sum(), x)[0]
    err_g = rel_err(grad_b, grad_g)
    del mpi, x, imgs, grad_b, grad_g
    torch.cuda.empty_cache()
    peaks = {k[:-3]: max(v) for k, v in spans.items() if k.endswith(" GB")}
    log(f"14b: train_gmpi_torch.main --dataset {name} --no_fused_renderer (batch {bs}, "
        f"batch_split {split}, {cfg.planes.n_planes} planes, worst of {cfg.train.n_view_per_z} "
        f"views, tile bands {step.tiled_bands}): {first} steps, resumed to {last}; step ms "
        f"{['%.1f' % x for x in stats1.step_ms + stats2.step_ms]}, D ms "
        f"{['%.1f' % x for x in spans['D ms']]}, G ms {['%.1f' % x for x in spans['G ms']]}; "
        f"peak GB by span " + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
        + f"; {row_steps['n']} tile-row steps, launches {launches}; a checkpoint of "
        f"{stats1.save_bytes[-1]} B saved in {stats1.save_s[-1]:.2f} s; G micro-batch rgba "
        f"gradient, banded vs gather autograd: rel err {err_g:.3e} (gate {GRAD_REL}) ({card})")
    if not err_g <= GRAD_REL:
        raise RuntimeError(f"{name}: the banded step's gradient disagrees with the gather's")
    record = {"bands": list(step.tiled_bands), "step_ms": stats1.step_ms + stats2.step_ms,
              "d_ms": spans["D ms"], "g_ms": spans["G ms"], "peak_gb_by_span": peaks,
              "row_steps": row_steps["n"], "launches": launches, "grad_vs_gather": err_g,
              "k7_exact": dict(zip(k7_shapes, k7_equal.values())),
              "save_s": stats1.save_s + stats2.save_s, "load_s": stats2.load_s}
    return record, launches, os.path.join(out, "checkpoints"), (zpath, pose_dir)


def fused_training(fr, card, dev, tmp, name):
    """Phase 14d: ``train_gmpi_torch.main`` on preset ``name`` through the
    fused default, from ``PRESET_IMAGES`` noise PNGs (a zip with ``.mat``
    poses for FFHQ512, a folder with an EG3D ``dataset.json`` for AFHQCat, a
    folder with a pose folder for MetFaces), for
    ``FUSED_LOOP_STEPS`` steps: launches as ``step_launches`` works them
    out, metrics finite, step ms, D and G ms and peak GB by span.  Returns the
    record, the launches, the checkpoint directory and the dataset's
    ``(data_root, pose_root)``."""
    import os

    import train_gmpi_torch
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.train.loop import LoopStats

    cfg = get_config(name)
    root = os.path.join(tmp, f"fused {name}")
    os.makedirs(root)
    if name == "MetFaces":
        data_root, pose_root = write_metfaces_dataset(root, PRESET_IMAGES, cfg.resolution, 13)
    elif name == "AFHQCat":
        data_root = pose_root = write_afhq_dataset(root, PRESET_IMAGES, cfg.resolution, 13)
    else:
        data_root, pose_root = write_ffhq_dataset(root, PRESET_IMAGES, cfg.resolution, 13)
    out = os.path.join(root, "run")
    spans = {}
    reset_counts(fr)
    stats = LoopStats()
    with phases_timed(spans):
        state = train_gmpi_torch.main(["--dataset", name, "--data_root", data_root,
                                       "--pose_root", pose_root, "--output_dir", out, "--seed",
                                       "6", "--total_iters", str(FUSED_LOOP_STEPS), "--device",
                                       str(dev)], stats=stats)
    launches = read_counts(fr)
    want = {**generator_only(launches), **scaled(step_launches(cfg), FUSED_LOOP_STEPS)}
    if state.step != FUSED_LOOP_STEPS or launches != want:
        raise RuntimeError(f"the {name} train CLI ended at step {state.step} with launches "
                           f"{launches}, expected {FUSED_LOOP_STEPS} steps and {want}")
    for m in stats.metrics:
        if not all(v == v and abs(v) != float("inf") for v in m.values()) or not m["r1"] > 0:
            raise RuntimeError(f"{name} loop: bad metrics {m}")
    del state
    torch.cuda.empty_cache()
    peaks = {k[:-3]: max(v) for k, v in spans.items() if k.endswith(" GB")}
    log(f"14d: train_gmpi_torch.main --dataset {name} (fused; batch {cfg.hparams.batch_size}, "
        f"batch_split {cfg.hparams.batch_split}, {cfg.planes.n_planes} planes, "
        f"{PRESET_IMAGES} PNGs of {cfg.resolution}^2): {FUSED_LOOP_STEPS} steps, step ms "
        f"{['%.1f' % x for x in stats.step_ms]}, D ms {['%.1f' % x for x in spans['D ms']]}, "
        f"G ms {['%.1f' % x for x in spans['G ms']]}; peak GB by span "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + f"; launches {launches} ({card})")
    record = {"step_ms": stats.step_ms, "d_ms": spans["D ms"], "g_ms": spans["G ms"],
              "peak_gb_by_span": peaks, "launches": launches}
    return record, launches, os.path.join(out, "checkpoints"), (data_root, pose_root)


def banded_fid_kid(name, data, fake_dir, tmp, card, dev, label="14c"):
    """The end of 14c: ``eval_gmpi_torch.main --task prepare_real`` of preset
    ``name``'s training PNGs (``data``: its ``(data_root, pose_root)``), then
    ``--task fid_kid`` between them and the banded fakes in ``fake_dir``,
    with random Inception weights (``inception.random_params``; no released
    weights here).  The three numbers must be finite.  Returns them and the
    seconds."""
    import math
    import os

    import eval_gmpi_torch
    from gmpi_tpu_torch.eval import inception

    weights = os.path.join(tmp, "inception.pth")
    if not os.path.exists(weights):
        torch.save({k: torch.from_numpy(v)
                    for k, v in inception.random_params(seed=4).items()}, weights)
    real_dir = os.path.join(tmp, f"{label} {name} real")
    t0 = time.perf_counter()
    eval_gmpi_torch.main(["--dataset", name, "--task", "prepare_real", "--data_root", data[0],
                          "--pose_root", data[1], "--n_imgs", str(PRESET_IMAGES), "--out",
                          real_dir])
    t1 = time.perf_counter()
    metrics = eval_gmpi_torch.main(["--dataset", name, "--task", "fid_kid", "--real_dir",
                                    real_dir, "--fake_dir", os.path.join(fake_dir, "rgb"),
                                    "--inception_weights", weights, "--device", str(dev),
                                    "--out", os.path.join(tmp, f"{label} {name} fid_kid")])
    t2 = time.perf_counter()
    n_real = len(os.listdir(real_dir))
    log(f"{label} {name}: eval_gmpi_torch.main --task prepare_real ({n_real} PNGs) in "
        f"{t1 - t0:.1f} s, --task fid_kid against the {PRESET_FAKES} banded fakes in "
        f"{t2 - t1:.1f} s (random Inception weights): "
        + ", ".join(f"{k} {metrics[k]:.6e}" for k in EVAL_KEYS["fid_kid"]) + f" ({card})")
    if not n_real or not all(math.isfinite(metrics[k]) for k in EVAL_KEYS["fid_kid"]):
        raise RuntimeError(f"{name}: fid_kid on the banded fakes gave {metrics} "
                           f"from {n_real} real PNGs")
    return {**{k: metrics[k] for k in EVAL_KEYS["fid_kid"]}, "n_real": n_real,
            "prepare_real_s": t1 - t0, "fid_kid_s": t2 - t1}


def banded_phase(fr, tw, pg, card, dev):
    """Phase 14: the tile-banded route at full width (14a planning on the card
    against the host for the five presets; 14b FFHQ256 and FFHQ1024 banded
    train steps through the train CLI; 14c banded ``prepare_fake`` of
    FFHQ1024 and MetFaces, and ``fid_kid`` on those fakes; 14d FFHQ512,
    AFHQCat and MetFaces trained fused through the CLI; 14e ``prepare_fake``
    of FFHQ512 and AFHQCat at 512^2, banded and fused, K7's and K8's device
    ms an image, and ``fid_kid`` on the banded fakes).  Returns ``(record,
    launches of its main paths)``."""
    import os
    import shutil
    import tempfile

    from gmpi_tpu_torch.config import get_config

    log(f"phase 14 depth (widths are the presets'): {BANDED_LOOP_STEPS} banded CLI steps, "
        f"{FUSED_LOOP_STEPS} fused CLI steps, {PRESET_IMAGES} PNGs a dataset, {PRESET_FAKES} "
        f"fakes a prepare_fake")
    laps, t0 = {}, time.perf_counter()

    def lap(name):
        laps[name] = time.perf_counter() - t0 - sum(laps.values())
        log(f"phase {name}: {laps[name]:.1f} s")

    record = {"planning": planning_checks(card, dev), "train": {}, "prepare_fake": {}}
    lap("14a")
    paths = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_banded_")
    try:
        for name in BANDED_TRAIN + FUSED_TRAIN:
            if name in BANDED_TRAIN:
                rec, launches, ckpt_dir, data = banded_training(fr, tw, pg, card, dev, tmp, name)
            else:
                rec, launches, ckpt_dir, data = fused_training(fr, card, dev, tmp, name)
            record["train"][name] = rec
            paths.append(launches)
            lap(f"14{'b' if name in BANDED_TRAIN else 'd'} {name}")
            if name in EVAL_BANDED + EVAL_512:  # eval's routes on this checkpoint
                part = "14c" if name in EVAL_BANDED else "14e"
                routes = ("banded",) if name in EVAL_BANDED else ("banded", "fused")
                rec, launches = prepare_fake_routes(fr, tw, pg, f"{part} {name}",
                                                    get_config(name), ckpt_dir, routes, tmp,
                                                    card, dev)
                rec["fid_kid"] = banded_fid_kid(name, data, rec["dirs"]["banded"], tmp, card, dev,
                                                part)
                record["prepare_fake"][name] = rec
                paths += [launches[route] for route in routes]
                lap(f"{part} {name}")
            shutil.rmtree(os.path.dirname(os.path.dirname(ckpt_dir)), ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record["seconds"] = laps
    return record, paths


def main() -> int:
    """The whole run."""
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
    from gmpi_tpu_torch.eval.harness import SAMPLER_GRAPH, FakeImageGenerator
    from gmpi_tpu_torch.models.generator import Generator
    from gmpi_tpu_torch.ops import _build
    from gmpi_tpu_torch.ops import fused_render as fr
    from gmpi_tpu_torch.ops import patch_gather as pg
    from gmpi_tpu_torch.ops import tiled_warp as tw
    from gmpi_tpu_torch.train import flat_pose_from_c2w, init_train_state, make_train_step
    from gmpi_tpu_torch.utils import roofline


    # -- 1. setup --------------------------------------------------------------
    phase_s, t_start = {}, time.perf_counter()

    def lap(name):
        """Print and keep the seconds since the last lap."""
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"phase {name}: {phase_s[name]:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    chip = roofline.chip_for(name)
    rates = card_rates(chip)
    log(f"card: {card}")
    import numpy
    import scipy

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"numpy {numpy.__version__} scipy {scipy.__version__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32: off for cuDNN convolutions and CUDA matmuls (full fp32)")
    count_k9_blocks()
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

    lap("1")

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
    # the adjoint's plan (its checks of the warp), on the host at the corners of the pose range
    t0 = time.perf_counter()
    corner_rays = bands_mod._corner_rays(c, cfg.fov_deg, res, res, device=dev)
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

    lap("2a-2b")

    # -- 2e. the forward and the adjoint at the edges of their designs ------------------
    for kname, e in check_edges(fr, cam, poses, cfg, dev).items():
        max_err[kname] = worse(max_err[kname], e)

    lap("2e")

    # -- 2c. patch gather vs plain version at the banded serving path's shapes ---------
    t0 = time.perf_counter()
    tiled_bands = bands_mod.bands_for_config(cfg, img_size=res, n_planes=n_planes, device=dev)
    log(f"tile bands for {n_planes} planes at {res}^2 (band_y, band_x, adjoint rows, cols): "
        f"{tiled_bands} in {time.perf_counter() - t0:.1f} s (planned on {dev})")
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
    k7_edges = patch_gather_edges(pg, dev, g)
    torch.cuda.empty_cache()

    lap("2c")

    # -- 2f. the MPI skip stack's update (K9) alone at the serving shapes ------------
    k9 = {label: mpi_stack_at(label, rates, card, dev) for label in K9_SHAPES}
    max_err["mpi_stack"] = max(r["max_rel_err"] for r in k9.values())

    lap("2f")

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
    serving_launches = read_counts(fr)
    if serving_launches != {**generator_only(serving_launches), "fused_fwd": len(seeds)}:
        raise RuntimeError(f"serving main path launched {serving_launches}, expected one "
                           f"fused_fwd per render call ({len(seeds)}) and no backward")
    log(f"serving main path: {len(seeds)} seeds x {n_views} views, launches {serving_launches}")
    sampler_256 = sampler_graph_turns(gen, seeds, card, "FFHQ256")
    mpix = n_views * res * res / 1e6
    log(f"generator ms per MPI: {['%.2f' % x for x in gen_ms]} (median "
        f"{statistics.median(gen_ms):.2f}; the first includes the warm-up and the graph's "
        f"capture) ({card})")
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

    lap("3")

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
    train_launches = read_counts(fr)
    n_steps = len(all_metrics)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {**generator_only(train_launches), "fused_fwd": 3 * n_steps,
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

    lap("4")

    # -- 7. adjoint route at the training shapes ---------------------------------------------
    grads_a = []
    reset_counts(fr)
    for _ in range(2):
        x = mpi.clone().requires_grad_()
        out = render_mpi_fused(x, geom_train.dhw, ray_dir, eye, z_dir, plans=adj_plans,
                               with_disp=False)
        grads_a.append(torch.autograd.grad((out.color * cot).sum(), x)[0])
    torch.cuda.synchronize()
    adjoint_launches = read_counts(fr)
    expected = {**generator_only(adjoint_launches), "fused_fwd": 2, "composite_bwd": 2,
                "adjoint": 2}
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

    lap("7")

    # -- 5. timing and bounds at the training main path's inputs ----------------------
    bwd_errs, k5 = backward_kernels_at(fr, mpi, geom_train.dhw, (ray_dir, eye, z_dir), cot,
                                       adj_bands, rates, card)
    for kname, e in bwd_errs.items():
        max_err[kname] = worse(max_err[kname], e)
    yv_w, pv_w = step.sample_views(rng, bs * n_cand)
    rays_w = fused_inputs(fr, geom_train.dhw, *rays_at(yv_w, pv_w), res)
    err, no_grad_forms = no_grad_forms_at(
        fr, mpi, fused_inputs(fr, geom_train.dhw, ray_dir, eye, z_dir, res), mpi, rays_w, rates,
        card)
    max_err["fused_fwd"] = worse(max_err["fused_fwd"], err)
    del mpi
    torch.cuda.empty_cache()

    lap("5")

    # -- 6. banded serving path ------------------------------------------------------------
    gen_b = FakeImageGenerator(cfg, gen_module, use_fused=False, device=dev)
    if gen_b.tiled_bands != tiled_bands:
        raise RuntimeError(f"the harness planned {gen_b.tiled_bands}, expected {tiled_bands}")
    # the banded sampler captures a graph of its own, which gives phase 3's MPI
    before = SAMPLER_GRAPH.copy()
    same_b = torch.equal(gen_b.sample_mpi(seeds[-1]), mpis[-1])
    graph_b = dict(SAMPLER_GRAPH - before)
    launches_b = launch_calls(lambda: gen_b.sample_mpi(seeds[-1]))
    log(f"banded sampler: SAMPLER_GRAPH {graph_b} at its first call, {launches_b} launch calls a "
        f"request after it, the last seed's MPI bitwise equal to phase 3's: {same_b}; "
        f"SAMPLER_GRAPH over the run {dict(SAMPLER_GRAPH)}")
    if not same_b or graph_b != {"capture": 1}:
        raise RuntimeError("the banded sampler's graph disagrees with phase 3's")
    calls = {"row_steps": 0, "gather_args": None, "sample_args": None}
    warp_row_tiles, gather_patches, sample_patches = (tw._warp_row_tiles, tw.gather_patches,
                                                      tw.sample_patches)

    def counted_row_step(*args, **kw):
        calls["row_steps"] += 1
        return warp_row_tiles(*args, **kw)

    def recorded_gather(texf, offs, band_x, band_yc, **kw):
        calls["gather_args"] = (texf, offs, band_x, band_yc)
        return gather_patches(texf, offs, band_x, band_yc, **kw)

    def recorded_sample(*args):
        calls["sample_args"] = args
        return sample_patches(*args)

    tw._warp_row_tiles, tw.gather_patches = counted_row_step, recorded_gather
    tw.sample_patches = recorded_sample
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
                    tiled_bands=tiled_bands))
        peak_chunked = torch.cuda.max_memory_allocated() / 1e9
        banded_launches = read_counts(fr)
    finally:
        tw._warp_row_tiles, tw.gather_patches = warp_row_tiles, gather_patches
        tw.sample_patches = sample_patches
    err_chunk = max(float((a - b).abs().max()) for a, b in zip(chunked, gather))
    per_plane = lambda x: x[:, None].expand(n_views, n_planes, *x.shape[1:]).reshape(  # noqa: E731
        n_views * n_planes, *x.shape[1:])
    grid, _ = homography_grid(geom.dhw.repeat(n_views, 1), per_plane(eye), per_plane(ray_dir),
                              per_plane(z_dir))
    covered = bool(tw.bands_cover((n_views * n_planes, 4, res, res), grid, band_y, band_x))
    del grid
    expected = {**generator_only(banded_launches), "patch_gather": calls["row_steps"],
                "patch_sample": calls["row_steps"]}
    log(f"banded serving path: {len(seeds)} seeds x {n_views} views x {n_planes} planes in one "
        f"call each (textures and tile rows in steps under "
        f"{renderer_mod.TILED_STEP_BYTES / 2 ** 30:.0f} GiB "
        f"of patches), then two renders in slabs of 24 planes; {calls['row_steps']} tile-row steps, "
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

    # the tap sampler and the patch gather at this path's inputs (the last tile-row step's)
    k8 = patch_sample_at(tw, calls["gather_args"], calls.pop("sample_args"), rates, card,
                         "the path's inputs")
    k7 = patch_gather_at(pg, *calls.pop("gather_args"), rates, card, "the path's inputs")
    max_err["patch_sample"] = k8["max_rel_err"]

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
    banded_spans["other (pad, band starts, composite)"] = banded_busy - sum(banded_spans.values())
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

    lap("6")

    # -- 8. training loop from a dataset --------------------------------------------------
    del state, step, step_with_grads
    torch.cuda.empty_cache()
    loop = training_loop_phase(fr, cfg, card, dev)

    lap("8")

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

    lap("9-10")

    # -- 11. variants and checkpoints at full FFHQ256 width ------------------------------
    torch.cuda.empty_cache()
    variants, k1_err = variants_phase(fr, cfg, card, chip, dev)
    max_err["fused_fwd"] = worse(max_err["fused_fwd"], k1_err)

    lap("11")

    # -- 12. bf16 textures in K1, and ranks on the one card --------------------------------
    torch.cuda.empty_cache()
    bf16 = bf16_phase(fr, cfg, card, chip, dev, {"ms": statistics.median(timed), "d_ms": d_ms,
                                                  "g_ms": g_ms, "peak_gb": peak_gb})
    max_err["fused_fwd"] = worse(max_err["fused_fwd"], bf16["max_abs_err"])
    torch.cuda.empty_cache()
    lap("12a")
    ranks = ranks_phase(fr, card, dev)
    lap("12b")

    # -- 13. the 1024^2 and 512^2 presets --------------------------------------------------
    torch.cuda.empty_cache()
    presets, preset_paths, preset_errs, at_1024 = presets_phase(fr, tw, pg, card, rates, dev)
    for kname, e in preset_errs.items():
        max_err[kname] = worse(max_err[kname], e)
    max_err["patch_sample"] = worse(max_err["patch_sample"],
                                    at_1024["patch_sample"]["max_rel_err"])
    phase_s["13"] = sum(presets["seconds"].values())
    log(f"phase 13: {phase_s['13']:.1f} s; the run so far {time.perf_counter() - t_start:.1f} s")

    # -- 14. the tile-banded route on the card -------------------------------------------------
    torch.cuda.empty_cache()
    banded, banded_paths = banded_phase(fr, tw, pg, card, dev)
    phase_s["14"] = sum(banded["seconds"].values())
    log(f"phase 14: {phase_s['14']:.1f} s; seconds by phase "
        f"{ {k: round(v, 1) for k, v in phase_s.items()} }; the run so far "
        f"{time.perf_counter() - t_start:.1f} s")

    main_paths = (serving_launches, train_launches, adjoint_launches, banded_launches,
                  loop["launches"], evaluation["launches"], viz["launches"],
                  *variants["launches"].values(), bf16["train_launches"], ranks["launches"],
                  *preset_paths, *banded_paths)
    # K7's launches by kernel path, read with each main path's counts: every one on the TMA path
    k7_paths = sum(main_paths, no_counts(fr)).k7_paths
    log(f"patch_gather launches of the main paths by kernel path: {k7_paths}")
    if (sum(k7_paths.values()) != sum(path["patch_gather"] for path in main_paths)
            or not k7_paths["tma"] or any(path.k7_paths["loop"] for path in main_paths)):
        raise RuntimeError(f"the main paths' patch gathers by path {k7_paths}: not all on the "
                           f"TMA path, or not the {sum(p['patch_gather'] for p in main_paths)} "
                           f"launches counted by kernel")

    # K9: one launch a synthesis block run without autograd on every main path
    k9_launches = sum(path["mpi_stack"] for path in main_paths)
    k9_blocks = sum(path.k9_blocks for path in main_paths)
    log(f"mpi_stack launches of the main paths: {k9_launches}, for {k9_blocks} synthesis blocks "
        f"run without autograd")
    if k9_launches != k9_blocks or not k9_launches:
        raise RuntimeError(f"the main paths launched K9 {k9_launches} times for {k9_blocks} "
                           f"synthesis blocks run without autograd")

    def entry(kname, line, ms, plain_ms, b, library_ms, replaces="gmpi_tpu/ops/pallas_warp.py",
              **extra):
        return {"name": kname, "route": "cuda", "source": f"gmpi_tpu_torch/csrc/{kname}.cu",
                "replaces": replaces if line is None else f"{replaces}:{line}",
                "launches": sum(path[kname] for path in main_paths),
                "max_abs_err": max_err[kname], "err_scale": "max|plain| per field", "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": library_ms, "at_1024": at_1024.get(kname), **extra}

    record = {"kernels": [
        entry("fused_fwd", 518, fwd_ms, fwd_plain_ms, fwd_bound, None,
              serving_launches=serving_launches["fused_fwd"],
              train_launches=train_launches["fused_fwd"], train_form_ms=k5["fwd_train"],
              queued_ms=fwd_queued_ms,
              train_form_plain_ms=k5["fwd_train_plain"],
              train_form_bound_ms=k5["bounds"]["fused_fwd_train"][0], **no_grad_forms,
              bf16_ms=bf16["ms"], bf16_plain_ms=bf16["plain_ms"], bf16_bound_ms=bf16["bound_ms"],
              bf16_bound_by=bf16["bound_by"], bf16_turns_ms=bf16["turns_ms"],
              bf16_max_abs_err=bf16["max_abs_err"],
              bf16_launches=bf16["train_launches"]["fused_fwd"]),
        entry("composite_bwd", 2407, k5["bwd"], k5["bwd_plain"], k5["bounds"]["composite_bwd"], None,
              also_replaces="gmpi_tpu/ops/pallas_warp.py:2295", queued_ms=k5["bwd_queued"]),
        entry("splat", 1355, k5["splat"], k5["splat_plain"], k5["bounds"]["splat"], k5["splat_lib"],
              also_replaces="gmpi_tpu/ops/pallas_warp.py:1184", form="texel boxes",
              queued_ms=k5["splat_queued"], errs_by_path=k5["splat_errs"],
              direct_path_ms=k5["splat_direct"],
              direct_path_queued_ms=k5["splat_direct_queued"]),
        entry("adjoint", 2029, k5["adj"], k5["adj_plain"], k5["bounds"]["adjoint"], k5["splat_lib"],
              splat_ms_around=[k5["splat"], k5["splat_again"]], queued_ms=k5["adj_queued"],
              splat_queued_ms=k5["splat_queued"]),
        entry("patch_gather", 33, k7["ms"], k7["plain_ms"], (k7["bound_ms"], k7["bound_by"]),
              k7["library_ms"],
              replaces="gmpi_tpu/ops/pallas_patch.py", err_scale="exact equality required",
              queued_ms=k7["queued_ms"], path=k7["path"], geometry=k7["geometry"],
              bf16=k7["bfloat16"], launches_by_path=k7_paths,
              edge_paths=k7_edges),
        entry("patch_sample", None, k8["ms"], k8["plain_ms"], (k8["bound_ms"], k8["bound_by"]),
              None, replaces="none (the hats and contractions of gmpi_tpu/ops/tiled_warp.py)",
              queued_ms=k8["queued_ms"], bytes=k8["bytes"], step_ms=k8["step_ms"],
              hats_step_ms=k8["hats_step_ms"], step_textures=k8["step_textures"]),
        entry("mpi_stack", None, k9["serve256_last"]["ms"], k9["serve256_last"]["plain_ms"],
              (k9["serve256_last"]["bound_ms"], k9["serve256_last"]["bound_by"]),
              k9["serve256_last"]["plain_ms"],
              replaces="none (the skip stack's library chain of gmpi_tpu/models/generator.py)",
              err_scale="max(1, max|plain|)", queued_ms=k9["serve256_last"]["queued_ms"],
              fir_ms=k9["serve256_last"]["fir_ms"], bytes=k9["serve256_last"]["bytes"],
              at_1024_serving=k9["serve1024_last"],
              errs={label: r["max_rel_err"] for label, r in k9.items()}),
    ], "train_steps": n_steps, "train_step_ms": statistics.median(timed),
        "banded_render_ms": t_banded, "banded_spans_ms": banded_spans,
        "banded_same_mpi_fused_ms": t_fused_same, "banded_same_mpi_gather_ms": t_gather_same,
        "banded_peak_gb": peak_banded, "banded_chunked_peak_gb": peak_chunked,
        "serving_gather_ms": serving_gather_ms, "sampler_graph": sampler_256, "loop": loop,
        "eval": {**{k: v for k, v in evaluation.items() if k != "tasks"}, "viz": viz},
        "variants": variants, "bf16": bf16, "ranks": ranks, "presets": presets,
        "banded": banded, "phase_s": phase_s}
    log(json.dumps(record))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 12b, spawned by ranks_phase
        sys.exit(_rank_job(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
