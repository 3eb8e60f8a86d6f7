"""A cell's comparison with the reference, run over many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--judged program|control|half_batch|d_half_batch|g_half_batch]

For each seed, what is judged goes through the cell's own comparison
(``compare`` of its traffic, with the limits of its workload file) and the
verdict ``harness.run_cell`` gives (``harness.verdict``).  ``program``: a
whole run of the cell (set-up, a window of ``PROGRAM_SECONDS``, the check), as
``run.py`` makes it.  The others put the reference itself in the program's
place: ``control`` computed one precision below the configuration's
(``reference.precision``); ``half_batch`` (train cells) in float32 with D's
and G's losses over half of each batch, ``d_half_batch`` with D's alone,
``g_half_batch`` with G's alone.
The limits lie between the program's readings and these.  The benchmark's
own runs never run this.  Prints one JSON line per seed; every reading,
compared or not, goes to stderr as ``run.py`` prints it.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# unfragmented segments keep the reference's float32 steps inside the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

JUDGED = ("program", "control", "half_batch", "d_half_batch", "g_half_batch")
PROGRAM_SECONDS = 1.0  # a program run's window: the check reads its first steps
# the TF32 switches as a run's process starts with them: the reference turns
# them off, and the next seed's program run has to find them as run.py does
TF32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


def context(cell, seed: int, device, workdir: str) -> harness.Context:
    exp = cell.config["experiment"]
    return harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                           exp=exp, cfg=harness.program_config(exp),
                           params=cell.workload["traffic"],
                           limits=cell.workload.get("limits", {}), workdir=workdir)


def train_checks(ctx, judged: str) -> list:
    """The train cell's checks of the reference in the program's place."""
    from benchmark.traffic import train
    from benchmark.traffic._ffhq_data import write_ffhq_dataset

    data = write_ffhq_dataset(ctx.workdir, ctx.params["n_images"], ctx.exp["resolution"],
                              train._seeds(ctx.seed)["data"])
    n_rows = len(data.images)
    fault = "" if judged == "control" else judged
    out = train.reference_readings(ctx, data, n_rows, None, control=judged == "control",
                                   fault=fault)
    ref = train.reference_readings(ctx, data, n_rows, out["picks"], d_after0=out["d_after0"])
    return train.compare(out, ref, ctx.limits)


def fid_checks(ctx, judged: str) -> list:
    """The fid cell's checks of the control in the program's place."""
    from benchmark.traffic import fid

    sample = fid.sample_of(ctx)
    seeds = {i: fid._seeds(ctx.seed)["base"] + i for i in sample}
    out = fid.reference_outputs(ctx, list(seeds.values()), control=True)
    kept = {i: (s, *out[s]) for i, s in seeds.items()}
    return fid.compare(ctx, kept, sample, ctx.limits)


def checks_of(cell, seed: int, judged: str, device) -> list:
    with tempfile.TemporaryDirectory(prefix="bench-control-") as workdir:
        if judged == "program":
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = TF32
            result = harness.run_cell(cell, seed, PROGRAM_SECONDS, False, device,
                                      time.perf_counter(), workdir)
            return [(k, c["value"], c["limit"]) for k, c in result["checks"].items()]
        ctx = context(cell, seed, device, workdir)
        kind = cell.workload["traffic"]["kind"]
        return (train_checks if kind == "train" else fid_checks)(ctx, judged)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--judged", default="control", choices=JUDGED)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    if args.judged.endswith("half_batch") and cell.workload["traffic"]["kind"] != "train":
        print(f"the {args.judged} fault is a train cell's", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = checks_of(cell, seed, args.judged, torch.device("cuda"))
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
