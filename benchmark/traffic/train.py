"""Traffic ``train``: a closed loop of GAN train steps over a seeded dataset.

The program's own path, as ``train_gmpi_torch.py`` takes it on a card:
``init_train_state`` / ``make_train_step`` of the configuration (the fused
renderer), fed by ``data.ShardedLoader`` over the FFHQ dataset class, which
decodes the seeded PNGs of ``_ffhq_data`` every step.  The state starts at
step ``start_step`` (lighting fully grown at 2000, as in three fifths of a
5,001-step run).

Set-up builds one state and one step, drives them through their first
``check_steps`` steps with the window's own call and feed (on rows that all
differ), and hands both to the window.  The reference follows those first
steps from the same weights, rows and draws; the check compares each
step's losses, the norm of each leaf's first gradient as Adam got it (its
first moment after one step, ``betas[0] = 0``), the norm of each leaf's
change after the last of them, and the views the step chose among each z's
candidates (see ``reference.gmpi.TrainStep``).  The first step's G phase is
also followed on the D that the program's D phase made (its parameters kept
after step 0): D's Adam update moves each element by about the learning rate
in the sign of its gradient, so a D made by the reference differs wherever
a gradient element lies within rounding of zero, and G's loss and gradient
on it would differ by more than the G phase's own rounding.

Parameters: ``n_images`` (written; one is on the fail list),
``start_step``, ``check_steps``, ``loader_workers``.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import weights as weights_mod


def _seeds(seed: int) -> Dict[str, int]:
    """The run's seeds: weights, data, the loader's order, the step's draws."""
    ss = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint32)
    return {"weights": int(ss[0]), "data": int(ss[1]), "loader": int(ss[2]),
            "step": int(ss[3])}


def leaf_norms(named) -> Dict[str, float]:
    """``{name: ||tensor||}`` of ``(name, tensor)`` pairs, one host read."""
    named = list(named)
    if not named:
        return {}
    norms = torch.stack([t.detach().float().norm() for _, t in named]).cpu().tolist()
    return {name: n for (name, _), n in zip(named, norms)}


class TrainRunner:
    def __init__(self, ctx):
        from gmpi_tpu_torch.data import ShardedLoader, get_dataset
        from gmpi_tpu_torch.train import init_train_state, make_train_step

        from benchmark.traffic._ffhq_data import write_ffhq_dataset

        self.ctx, cfg, p, dev = ctx, ctx.cfg, ctx.params, ctx.device
        self.seeds = _seeds(ctx.seed)
        res, bs = cfg.resolution, cfg.hparams.batch_size
        self.bs = bs
        self.data = write_ffhq_dataset(ctx.workdir, p["n_images"], res, self.seeds["data"])
        dataset = get_dataset(
            "FFHQ", dataset_path=self.data.zip_path, raw_img_size=res, img_size=res,
            pose_data_path=self.data.pose_dir, sphere_center=cfg.camera.sphere_center_z,
            sphere_r=cfg.camera.sphere_r, flat_pose_dim=cfg.train.d_cond_pose_dim)
        self.n_rows = len(dataset)
        loader = ShardedLoader(dataset, batch_size=bs, seed=self.seeds["loader"],
                               num_workers=p["loader_workers"])
        self.batches = iter(loader)
        self.data_wait_s: List[float] = []
        ctx.mark("dataset")

        weights = weights_mod.make(ctx.exp, self.seeds["weights"], dev)
        state = init_train_state(cfg, device=dev)
        state.G.load_state_dict(weights_mod.split(weights, "G"))
        state.D.load_state_dict(weights_mod.split(weights, "D"))
        state.ema = {k: v.detach().clone() for k, v in state.G.named_parameters()}
        state.ema2 = {k: v.detach().clone() for k, v in state.G.named_parameters()}
        state.step = p["start_step"]
        self.state = state
        self.step = make_train_step(cfg, device=dev)
        self.rng = torch.Generator().manual_seed(self.seeds["step"])
        ctx.mark("state")

        # the first steps, followed by the reference; they also warm up every shape
        self.picks: List[tuple] = []
        self.losses: List[Dict[str, float]] = []
        inner = self.step.worst_views

        def recording(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.picks.append(tuple(t.detach().clone() for t in out))
            return out

        self.step.worst_views = recording
        try:
            for k in range(p["check_steps"]):
                _, metrics = self._one()
                self.losses.append({key: float(v) for key, v in metrics.items()
                                    if key in ("d_loss", "g_loss")})
                if k == 0:
                    self.first_grads = self._first_moments()
                    self.d_after0 = {n: v.detach().to("cpu", copy=True)
                                     for n, v in state.D.named_parameters()}
                ctx.mark(f"step {k}")
        finally:
            del self.step.worst_views
        named = [(f"{tag}.{k}", v) for tag, m in (("G", state.G), ("D", state.D))
                 for k, v in m.named_parameters()]
        self.changes = leaf_norms((k, v - weights[k]) for k, v in named)
        del weights
        self.data_wait_s.clear()

    def _first_moments(self) -> Dict[str, float]:
        out = []
        for tag, module, opt in (("G", self.state.G, self.state.opt_g),
                                 ("D", self.state.D, self.state.opt_d)):
            for k, v in module.named_parameters():
                st = opt.state.get(v)
                if st and "exp_avg" in st:
                    out.append((f"{tag}.{k}", st["exp_avg"]))
        return leaf_norms(out)

    def _feed(self):
        t0 = time.perf_counter()
        with record_function("bench.data"):
            batch = next(self.batches)
            imgs = torch.from_numpy(np.ascontiguousarray(batch[0], np.float32)).to(self.ctx.device)
            pose = torch.from_numpy(np.ascontiguousarray(batch[1], np.float32)).to(self.ctx.device)
        self.data_wait_s.append(time.perf_counter() - t0)
        return imgs, pose

    def _one(self):
        imgs, pose = self._feed()
        with record_function("bench.step"):
            return self.step(self.state, imgs, pose, self.rng)

    # -- the window ------------------------------------------------------------------

    def run_one(self, i: int) -> None:
        self._one()

    def attempted(self, n: int) -> int:
        return n

    def failed(self, n: int) -> int:
        return 0

    def end_to_end(self, window_s: float, n: int) -> Dict[str, float]:
        return {"train_img_s": n * self.bs / window_s}

    def release(self) -> None:
        self.state = self.step = self.batches = None

    # -- the check -------------------------------------------------------------------

    def check(self):
        """The reference's first steps against the program's."""
        ref = reference_readings(self.ctx, self.data, self.n_rows, self.picks,
                                 d_after0=self.d_after0)
        prog = {"losses": self.losses, "grads": self.first_grads, "changes": self.changes}
        return compare(prog, ref, self.ctx.limits)


def reference_readings(ctx, data, n_rows: int, picks: Optional[list], control: bool = False,
                       fault: str = "", d_after0: Optional[dict] = None) -> dict:
    """The reference's first steps from the run's weights, rows and draws:
    losses, first-moment and change norms by leaf, the view gap, the views it
    went on with and D's parameters after step 0.  ``picks``: the views to
    judge and go on with (else its own); ``control`` and ``fault``: the
    reference in the program's place, one precision below or with that fault
    planted (``reference.gmpi.TrainStep``).  With ``d_after0`` (the judged
    run's D after step 0) also ``g0``: step 0 again, its G phase on that D
    (loss, G's first-moment norms, the view gap)."""
    out = _reference_steps(ctx, data, n_rows, picks, ctx.params["check_steps"], control, fault)
    if d_after0 is not None:
        g0 = _reference_steps(ctx, data, n_rows, picks, 1, d_after0=d_after0)
        out["g0"] = {"g_loss": g0["losses"][0]["g_loss"], "view_gap": g0["view_gap"],
                     "grads": {k: v for k, v in g0["grads"].items() if k.startswith("G.")}}
    return out


def _reference_steps(ctx, data, n_rows: int, picks: Optional[list], n_steps: int,
                     control: bool = False, fault: str = "",
                     d_after0: Optional[dict] = None) -> dict:
    from benchmark.reference import gmpi, precision

    dev, exp, p = ctx.device, ctx.exp, ctx.params
    seeds = _seeds(ctx.seed)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = weights_mod.make(exp, seeds["weights"], dev)
    G, D = gmpi.build_models(exp, weights, dev)
    step = gmpi.TrainStep(exp, G, D, dev, fault=fault)
    flat = gmpi.deep3dface_flat_poses(data.angles, data.trans, exp)
    order = gmpi.epoch_order(n_rows, seeds["loader"], 0)
    rng = torch.Generator().manual_seed(seeds["step"])
    bs = exp["hparams"]["batch_size"]
    losses, grads, d_after = [], {}, None
    with precision.mode(control=control):
        for k in range(n_steps):
            real, pose = gmpi.real_batch(data.images, flat, order[k * bs:(k + 1) * bs], dev)
            out = step(p["start_step"] + k, real, pose, rng,
                       pick=None if picks is None else picks[k],
                       d_after=d_after0 if k == 0 else None)
            losses.append({key: float(v) for key, v in out.items()})
            if k == 0:
                named = [(f"{tag}.{n}", o.state[v]["exp_avg"])
                         for tag, m, o in (("G", G, step.opt_g), ("D", D, step.opt_d))
                         for n, v in m.named_parameters() if v in o.state]
                grads = leaf_norms(named)
                d_after = {n: v.detach().to("cpu", copy=True) for n, v in D.named_parameters()}
    named = [(f"{tag}.{k}", v) for tag, m in (("G", G), ("D", D)) for k, v in m.named_parameters()]
    changes = leaf_norms((k, v - weights[k]) for k, v in named)
    view_gap = max(step.view_gaps) if step.view_gaps else 0.0
    return {"losses": losses, "grads": grads, "changes": changes, "view_gap": view_gap,
            "picks": step.chosen, "d_after0": d_after}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> List[tuple]:
    """``(gap, leaf)`` for each leaf, largest first: the gap between the
    program's and the reference's norm of the leaf, against the larger of
    that leaf's reference norm and the median leaf's (of its model)."""
    gaps = []
    for tag in ("G", "D"):
        ks = [k for k in keys if k.startswith(tag + ".")]
        if not ks:
            continue
        median = float(np.median([ref[k] for k in ks]))
        for k in ks:
            gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
            gaps.append((gap if gap == gap else float("inf"), k))
    return sorted(gaps, reverse=True)


# the numbers compared; the others are printed beside them (PERF.md says why)
COMPARED = ("d_grad_median_gap", "change_median_gap", "g_loss0_gap", "g_grad_median_gap")


def statistics(prog: dict, ref: dict) -> Dict[str, float]:
    """Every reading of the program's first steps against the reference's:

    * ``d_loss0_gap``: the first step's D loss (before any update), relative;
      ``loss0_gap``: the first step's D and G losses, the larger relative
      gap; ``loss_gap``: the same over every step;
    * ``grad_median_gap`` / ``grad_worst_gap``: the first gradients' leaf gaps
      (``leaf_gaps``), the median leaf's and the worst; ``d_grad_median_gap``
      the median of D's leaves alone (taken before any update);
    * ``change_median_gap`` / ``change_worst_gap``: the same of the changes
      after the last step, over the leaves whose reference gradient is at
      least a thousandth of the median leaf's (the others move under Adam by
      round-off alone);
    * ``view_gap``: the worst chosen view's score gap (``reference.gmpi``);
    * ``g_loss0_gap``, ``g_grad_median_gap``, ``view0_gap``: the first step's
      G loss (relative), G's median leaf's first-gradient gap and the view
      gap, against the reference's G phase on the judged run's D after its
      update (``ref["g0"]``).
    """
    out = {"d_loss0_gap": 0.0, "loss0_gap": 0.0, "loss_gap": 0.0}
    for k, (p_step, r_step) in enumerate(zip(prog["losses"], ref["losses"])):
        for key, r in r_step.items():
            gap = abs(p_step.get(key, float("nan")) - r) / max(abs(r), 1e-6)
            gap = gap if gap == gap else float("inf")
            out["loss_gap"] = max(out["loss_gap"], gap)
            if k == 0:
                out["loss0_gap"] = max(out["loss0_gap"], gap)
                if key == "d_loss":
                    out["d_loss0_gap"] = gap
            print(f"note step {k} {key}: program {p_step.get(key, float('nan')):.6g}, "
                  f"reference {r:.6g}", file=sys.stderr)
    moving = []
    for tag in ("G", "D"):
        ks = [k for k in ref["grads"] if k.startswith(tag + ".")]
        if ks:
            median = float(np.median([ref["grads"][k] for k in ks]))
            moving += [k for k in ks if ref["grads"][k] >= 1e-3 * median]
    for name, p_norms, r_norms, keys in (
            ("grad", prog["grads"], ref["grads"], list(ref["grads"])),
            ("change", prog["changes"], ref["changes"], moving)):
        gaps = leaf_gaps(p_norms, r_norms, keys)
        out[f"{name}_worst_gap"] = gaps[0][0] if gaps else 0.0
        out[f"{name}_median_gap"] = float(np.median([g for g, _ in gaps])) if gaps else 0.0
        if name == "grad":
            out["d_grad_median_gap"] = float(np.median(
                [g for g, k in gaps if k.startswith("D.")] or [0.0]))
        for gap, k in gaps[:3]:
            print(f"note {name} leaf {k}: gap {gap:.4g} (program {p_norms.get(k, 0.0):.6g}, "
                  f"reference {r_norms[k]:.6g})", file=sys.stderr)
    out["view_gap"] = ref["view_gap"]
    g0 = ref["g0"]
    p_loss = prog["losses"][0].get("g_loss", float("nan"))
    gap = abs(p_loss - g0["g_loss"]) / max(abs(g0["g_loss"]), 1e-6)
    out["g_loss0_gap"] = gap if gap == gap else float("inf")
    print(f"note step 0 g_loss on the judged D: program {p_loss:.6g}, reference "
          f"{g0['g_loss']:.6g}", file=sys.stderr)
    gaps = leaf_gaps(prog["grads"], g0["grads"], list(g0["grads"]))
    out["g_grad_median_gap"] = float(np.median([g for g, _ in gaps]))
    for gap, k in gaps[:3]:
        print(f"note G grad leaf on the judged D {k}: gap {gap:.4g} (program "
              f"{prog['grads'].get(k, 0.0):.6g}, reference {g0['grads'][k]:.6g})", file=sys.stderr)
    out["view0_gap"] = g0["view_gap"]
    return out


def compare(prog: dict, ref: dict, limits: Dict[str, float]):
    """``[(name, value, limit)]`` of the numbers compared; the other
    readings go to stderr."""
    stats = statistics(prog, ref)
    for k, v in stats.items():
        if k not in COMPARED:
            print(f"note {k}: {v!r} (not compared)", file=sys.stderr)
    return [(k, stats[k], limits.get(k)) for k in COMPARED]


def setup(ctx) -> TrainRunner:
    return TrainRunner(ctx)
