"""Traffic ``train_afhq``: the ``train`` traffic over an EG3D-posed folder
dataset.

The program's path is the train CLI's for ``--dataset AFHQCat``:
``init_train_state`` / ``make_train_step`` of the configuration, fed by
``data.ShardedLoader`` over the ``AFHQCat`` dataset class, which decodes the
seeded PNGs of ``_afhq_data`` through PIL and converts each EG3D
camera-to-world matrix on the loader's threads.  Everything else is
``train``'s, by import: the window's loop, the first ``check_steps`` steps
followed by the reference, the readings and the numbers compared.  Only
the dataset and the reference's rows differ: the reference takes the
written matrices through its own ``w2c_from_pnp_c2w`` (``reference.afhq``).

Parameters: ``n_images``, ``start_step``, ``check_steps``,
``loader_workers``.

``control.py`` sends any kind but ``train`` to the FID checks, so this
module runs the control and the half-batch faults itself:

    python3 benchmark/traffic/train_afhq.py --workload afhqcat512-train \
        --seeds 1,2,3 [--judged program|control|half_batch|d_half_batch|g_half_batch]

prints one JSON line a seed, as ``control.py`` does.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import List, Optional

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from benchmark import weights as weights_mod  # noqa: E402
from benchmark.traffic import train  # noqa: E402
from benchmark.traffic._afhq_data import write_afhq_dataset  # noqa: E402
from benchmark.traffic.train import COMPARED, compare, leaf_norms  # noqa: E402,F401


def write_data(ctx):
    return write_afhq_dataset(ctx.workdir, ctx.params["n_images"], ctx.exp["resolution"],
                              ctx.exp["camera"], train._seeds(ctx.seed)["data"])


class AfhqTrainRunner(train.TrainRunner):
    def __init__(self, ctx):
        from gmpi_tpu_torch.data import ShardedLoader, get_dataset
        from gmpi_tpu_torch.train import init_train_state, make_train_step

        self.ctx, cfg, p, dev = ctx, ctx.cfg, ctx.params, ctx.device
        self.seeds = train._seeds(ctx.seed)
        res, bs = cfg.resolution, cfg.hparams.batch_size
        self.bs = bs
        self.data = write_data(ctx)
        dataset = get_dataset(
            "AFHQCat", dataset_path=self.data.folder, raw_img_size=res, img_size=res,
            pose_data_path=self.data.folder, sphere_center=cfg.camera.sphere_center_z,
            sphere_r=cfg.camera.sphere_r, flat_pose_dim=cfg.train.d_cond_pose_dim)
        self.n_rows = len(dataset)
        loader = ShardedLoader(dataset, batch_size=bs, seed=self.seeds["loader"],
                               num_workers=p["loader_workers"])
        self.batches = iter(loader)
        self.data_wait_s: List[float] = []
        ctx.mark("dataset")

        # from here on as train.TrainRunner: the state, then the checked steps
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

        self.picks: List[tuple] = []
        self.losses = []
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

    def check(self):
        """The reference's first steps against the program's."""
        ref = reference_readings(self.ctx, self.data, self.n_rows, self.picks,
                                 d_after0=self.d_after0)
        prog = {"losses": self.losses, "grads": self.first_grads, "changes": self.changes}
        return compare(prog, ref, self.ctx.limits)


def reference_readings(ctx, data, n_rows: int, picks: Optional[list], control: bool = False,
                       fault: str = "", d_after0: Optional[dict] = None) -> dict:
    """``train.reference_readings`` on the folder dataset's rows."""
    out = _reference_steps(ctx, data, n_rows, picks, ctx.params["check_steps"], control, fault)
    if d_after0 is not None:
        g0 = _reference_steps(ctx, data, n_rows, picks, 1, d_after0=d_after0)
        out["g0"] = {"g_loss": g0["losses"][0]["g_loss"], "view_gap": g0["view_gap"],
                     "grads": {k: v for k, v in g0["grads"].items() if k.startswith("G.")}}
    return out


def _reference_steps(ctx, data, n_rows: int, picks: Optional[list], n_steps: int,
                     control: bool = False, fault: str = "",
                     d_after0: Optional[dict] = None) -> dict:
    """``train._reference_steps`` with the rows' poses from the written
    camera-to-world matrices."""
    from benchmark.reference import afhq, gmpi, precision

    dev, exp, p = ctx.device, ctx.exp, ctx.params
    seeds = train._seeds(ctx.seed)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = weights_mod.make(exp, seeds["weights"], dev)
    G, D = gmpi.build_models(exp, weights, dev)
    step = gmpi.TrainStep(exp, G, D, dev, fault=fault)
    flat = afhq.flat_poses(data.c2w, exp)
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


def control_checks(ctx, judged: str) -> list:
    """The cell's checks with the reference in the program's place
    (``control.train_checks`` on this dataset): ``control`` one precision
    below, or one of the half-batch faults in float32."""
    data = write_data(ctx)
    n_rows = len(data.images)
    fault = "" if judged == "control" else judged
    out = reference_readings(ctx, data, n_rows, None, control=judged == "control", fault=fault)
    ref = reference_readings(ctx, data, n_rows, out["picks"], d_after0=out["d_after0"])
    return compare(out, ref, ctx.limits)


def setup(ctx) -> AfhqTrainRunner:
    return AfhqTrainRunner(ctx)


def main() -> int:
    """``control.py``'s loop for this kind: program runs through
    ``control.checks_of``, the others through ``control_checks``."""
    import argparse

    from benchmark import control, harness

    ap = argparse.ArgumentParser(description="The train_afhq cell's comparison over seeds.")
    ap.add_argument("--workload", default="afhqcat512-train")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--judged", default="control", choices=control.JUDGED)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("this needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.judged == "program":
            checks = control.checks_of(cell, seed, "program", dev)
        else:
            with tempfile.TemporaryDirectory(prefix="bench-control-") as workdir:
                checks = cell.traffic.control_checks(control.context(cell, seed, dev, workdir),
                                                     args.judged)
        for name, v, lim in checks:
            print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, "judged": args.judged,
                          "correct": harness.verdict(checks),
                          "checks": {k: {"value": v, "limit": lim} for k, v, lim in checks}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
