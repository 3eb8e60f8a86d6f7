"""The benchmark's harness: finds a cell's files by name, runs its window and
prints one result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<kind>.py``, given the
cell's parameters).  Per-layer metrics are ``metrics/<metric>.py``, each a
``read(trace, runner) -> float | None``; ``BENCHMARK.json`` says which cells
report which.  Adding a configuration, a cell, a traffic kind or a metric
adds files and ``BENCHMARK.json`` entries and edits none.

A traffic module has ``setup(ctx) -> runner``.  The runner builds the
program and warms up every shape of the cell in ``setup``; then
``run_one(i)`` runs the window's ``i``-th whole step or request,
``end_to_end(window_s, n)`` gives the end-to-end metrics other than
``setup_s``, ``release()`` frees the program's state and ``check()``
compares what the timed path produced with the reference, returning
``[(name, value, limit)]``.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gmpi_tpu")
# a traced run's window: reading the trace takes ~15 s a traced second, and
# a run ends within 360 s
TRACE_SECONDS = 10.0


# ---- finding a cell's files -------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: object  # the traffic module
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path  # the folder the cell's files were found in


def load_module(root: Path, kind: str, name: str):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    mod_name = f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str):
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` gives ``cell``:
    an end-to-end metric without ``workloads`` is every cell's; a per-layer
    metric names its cells."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    return e2e, [m for m in bench["per_layer"] if cell in m["workloads"]]


def load_cell(name: str, root: Path = BENCH_DIR, bench: Optional[dict] = None) -> Cell:
    if bench is None:
        with open(root.parent / "BENCHMARK.json") as f:
            bench = json.load(f)
    wl = load_json(root, "workloads", name)
    e2e, layer = metrics_of(bench, name)
    return Cell(name=name, workload=wl, config=load_json(root, "configs", wl["config"]),
                traffic=load_module(root, "traffic", wl["traffic"]["kind"]),
                end_to_end=e2e, per_layer=layer, root=root)


def program_config(exp: dict):
    """The port's ``ExperimentConfig`` of a configuration file's
    ``experiment``."""
    from gmpi_tpu_torch import config as c
    from gmpi_tpu_torch.core.poses import SphereCameraConfig

    train = dict(exp["train"], betas=tuple(exp["train"]["betas"]))
    return c.ExperimentConfig(
        name=exp["name"], resolution=exp["resolution"],
        camera=SphereCameraConfig(**exp["camera"]), planes=c.PlaneConfig(**exp["planes"]),
        hparams=c.StepHparams(**exp["hparams"]), train=c.TrainHparams(**train),
        model=c.ModelPreset(**exp["model"]), fov_deg=exp["fov_deg"],
        eval_n_planes=exp["eval_n_planes"])


def experiment_dict(cfg) -> dict:
    """A port ``ExperimentConfig`` as a configuration file writes it."""
    d = dataclasses.asdict(cfg)
    d["camera"] = cfg.camera._asdict()
    return json.loads(json.dumps(d))


# ---- a run ------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    exp: dict  # the configuration's experiment
    cfg: object  # the port's ExperimentConfig
    params: dict  # the traffic's parameters
    limits: Dict[str, float]
    workdir: str  # scratch space under TMPDIR for this run
    t_start: float = 0.0  # the process's start, on time.perf_counter

    def mark(self, label: str) -> None:
        """Name a point of set-up on stderr, with the seconds since the start."""
        print(f"setup {label}: {time.perf_counter() - self.t_start:.2f} s", file=sys.stderr)


@dataclasses.dataclass
class Trace:
    """What the traced window recorded, in microseconds of the profiler's
    clock: merged device-busy intervals, device kernels and annotations,
    host spans, the window's bounds and how many units it ran."""

    busy: list
    busy_starts: list
    kernels: list  # (name, start, end)
    annotations: list  # device (name, start, end)
    host: list  # (name, start, end, thread)
    window: tuple  # (start, end)
    n: int
    peaks: dict


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import torch

    info = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        info["power_limit_w"] = out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return info


def forbidden_modules() -> List[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_window(runner, seconds: float, sync) -> tuple:
    """Whole units until ``seconds`` have passed: ``(n, window_s)``, from the
    start of the first unit to the end of the last."""
    sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        runner.run_one(n)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return n, time.perf_counter() - t0


def _traced_window(runner, seconds: float, peaks: dict, sync=None):
    """The window under ``torch.profiler`` (CPU and CUDA activities), reduced
    to a :class:`Trace` from the profiler's raw events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import yardstick

    activities = [ProfilerActivity.CPU]
    if sync is None:
        sync = torch.cuda.synchronize
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("bench.window"):
            n, window_s = run_window(runner, seconds, sync)
    events = prof.profiler.kineto_results.events()
    window_ns = next((e.start_ns(), e.end_ns()) for e in events
                     if e.name() == "bench.window" and e.device_type() == DeviceType.CPU)
    base = window_ns[0]
    kernels, annotations, host = [], [], []
    for e in events:
        s, t = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if e.device_type() == DeviceType.CUDA:
            (annotations if e.is_user_annotation() else kernels).append((e.name(), s, t))
        elif e.name() != "bench.window":
            host.append((e.name(), s, t, e.start_thread_id()))
    window = (0.0, (window_ns[1] - base) / 1e3)
    kernels = [k for k in kernels if k[2] > window[0] and k[1] < window[1]]
    busy = yardstick.merged((max(s, window[0]), min(t, window[1])) for _, s, t in kernels)
    return Trace(busy=busy, busy_starts=[s for s, _ in busy], kernels=kernels,
                 annotations=annotations, host=sorted(host, key=lambda h: h[1]), window=window,
                 n=n, peaks=peaks), window_s


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the ten host
    activities under which the device sat idle longest: each of the 200
    longest idle gaps is named by the innermost host event open at its
    middle."""
    by_op: Dict[str, float] = {}
    for name, s, t in trace.kernels:
        by_op[name] = by_op.get(name, 0.0) + (t - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    edges = [trace.window[0]] + [x for iv in trace.busy for x in iv] + [trace.window[1]]
    gaps = sorted(((lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo),
                  key=lambda g: g[0] - g[1])
    starts = [h[1] for h in trace.host]
    by_host: Dict[str, float] = {}
    for lo, hi in gaps[:200]:
        mid = (lo + hi) / 2
        name = "(no host event)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 5000), -1):
            if trace.host[j][2] >= mid:
                name = trace.host[j][0]
                break
        by_host[name] = by_host.get(name, 0.0) + (hi - lo) / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             workdir: str) -> dict:
    """Set up, run the window, read the metrics, free the program, check it.
    Returns the result (without ``device``'s card fields)."""
    import torch

    from benchmark import yardstick

    exp = cell.config["experiment"]
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, exp=exp,
                  cfg=program_config(exp), params=cell.workload["traffic"],
                  limits=cell.workload.get("limits", {}), workdir=workdir, t_start=t_start)
    ctx.mark("imports")
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    runner = cell.traffic.setup(ctx)
    sync()
    setup_s = time.perf_counter() - t_start
    peaks = yardstick.peaks_for(torch.cuda.get_device_name(0) if cuda else "")
    if trace:
        tr, window_s = _traced_window(runner, min(seconds, TRACE_SECONDS), peaks)
        n = tr.n
    else:
        n, window_s = run_window(runner, seconds, sync)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0  # before the reference
    metrics: Dict[str, dict] = {}
    if not trace:
        values = runner.end_to_end(window_s, n)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"attempted": runner.attempted(n), "failed": runner.failed(n), "metrics": metrics,
              "device": {"count": 1, "memory_peak_bytes": int(memory_peak)}}
    runner.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = runner.check()
    if trace:  # after the check: a reader may use what the reference worked out
        runner.window_s, runner.n = window_s, n
        for m in cell.per_layer:
            value = load_module(cell.root, "metrics", m["name"]).read(tr, runner)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"]["busy_s"] = yardstick.union_length(tr.busy) / 1e6
        result["device"]["window_s"] = (tr.window[1] - tr.window[0]) / 1e6
        result["breakdown"] = breakdown(tr)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    result["correct"] = verdict(checks)
    return result


def verdict(checks) -> bool:
    """``correct`` of ``[(name, value, limit)]``: every number within its
    limit (a number without a limit, or not a number, fails)."""
    return bool(checks) and all(lim is not None and v == v and v <= lim for _, v, lim in checks)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    import tempfile

    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), t_start, workdir)
    result["device"] = {"platform": "gpu", **card(), **result["device"]}
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the port and the benchmark import no JAX "
              f"and no gmpi_tpu", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    ordered = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        ordered["breakdown"] = result["breakdown"]
    ordered["checks"] = result["checks"]
    print(json.dumps(ordered))
    return 0
