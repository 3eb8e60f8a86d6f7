"""Time the patch-gather kernel (K7) at the banded route's two input sizes.

    python -m gmpi_tpu_torch.tools.time_patch_gather [--parent DIR ...] [--sweep]
        [--iters 20]

Inputs like those the banded route hands the kernel, made from a seed: at
256^2, 16 textures of 32 patches of 376 x 96 texels (4 channels), each
texture's patches 8 texels apart in x; at 1024^2, 48 textures of 8 patches
of 424 x 104 texels, 128 apart (the tile-row steps of ``chip_smoke.py``'s
phase 6 and phase 13b have these shapes; their offsets differ).  For each,
in fp32 and in bf16, with CUDA events (median of ``--iters``, one launch per
event pair and 10 queued), each held exactly against ``gather_patches_ref``
first:

- the wrapper ``gather_patches(..., validate=False)`` as the tiled warp
  calls it, and its host time a call (20 calls, no synchronization between);
- the kernel's two paths through ``_launch``: the TMA path at its default
  geometry and the loop path, the one shapes the TMA cannot take get;
- with ``--parent DIR`` (a checkout of an earlier commit, repeatable) that
  checkout's kernel and this one's, each built from its
  ``csrc/patch_gather.cu`` and called bare through ctypes, in turns: this,
  parent, parent, this;
- with ``--sweep`` the TMA path at the geometries of a sweep (stage bytes,
  stages, stores in flight) whose stages fit a block's shared memory;

beside the plain version, one advanced index with its indices made
beforehand, the byte bound (each covered texel read once, each patch
element written once, at ``utils/roofline.py``'s rate for the card), and a
fill and a copy of a tensor of the patches' size.

Prints the card's name and power limit first and a JSON line last.  Needs a
CUDA card; raises without one.
"""

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

from gmpi_tpu_torch.ops import _build
from gmpi_tpu_torch.ops import patch_gather as pg
from gmpi_tpu_torch.utils import roofline

# (textures, patches a texture, band_x, band_y, image size, x step between patches)
SIZES = {"256": (16, 32, 376, 96, 256, 8), "1024": (48, 8, 424, 104, 1024, 128)}
# TMA geometries of --sweep: (stage bytes, stages, stores in flight past the one waited for)
SWEEP = [(b * 1024, s, lag) for b in (4, 8, 16, 32) for s in (2, 4, 6, 8)
         for lag in sorted({0, 1, s // 2, s - 2}) if lag <= s - 2]
SMEM_BYTES = 227 * 1024  # shared memory a block may use on an H100
# the C signatures of gmpi_patch_gather this tool can call: the earlier kernel's
# (a block per patch, no launch geometry), and the one that takes the launch
# geometry's six numbers after the element size
SIGNATURES = {
    ("texf", "offs", "out", "N", "n_tiles", "wp", "hpc", "band_x", "band_yc", "elem_size",
     "stream"): False,
    ("texf", "offs", "out", "N", "n_tiles", "wp", "hpc", "band_x", "band_yc", "elem_size", "rows",
     "chunks", "box_cols", "boxes", "stages", "lag", "stream"): True,
}


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


def _host_us(fn, calls=20):
    """Host microseconds a call of ``fn``, ``calls`` calls with no
    synchronization between (the card's queue never fills at that count)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def synthetic_inputs(size: str, dtype, dev, seed: int = 0):
    """``(texf, offs, band_x, band_yc)`` of the banded route's shape at
    ``size``: the padded x-major texture and one tile row's patch starts."""
    n, t, band_x, band_y, res, step = SIZES[size]
    wp, hpc = res + 2 * band_x, (res + 2 * band_y) * 4
    g = torch.Generator(device=dev).manual_seed(seed)
    texf = torch.randn((n, wp, hpc), device=dev, generator=g).to(dtype)
    x0 = torch.randint(band_x // 2, band_x, (n, 1), device=dev, generator=g)
    x_lo = (x0 + step * torch.arange(t, device=dev)).clamp(max=wp - band_x)
    y_lo = torch.randint(0, res + band_y + 1, (n, 1), device=dev, generator=g).expand(n, t)
    offs = torch.stack([x_lo, y_lo * 4], dim=-1).to(torch.int32).contiguous()
    return texf, offs, band_x, band_y * 4


def _indices(texf, offs, band_x, band_yc):
    dev = texf.device
    n_idx = torch.arange(texf.shape[0], device=dev).reshape(-1, 1, 1, 1)
    rows = (offs[..., 0, None].long() + torch.arange(band_x, device=dev))[..., None]
    cols = (offs[..., 1, None].long() + torch.arange(band_yc, device=dev))[:, :, None, :]
    return n_idx, rows, cols


def needed_bytes(texf, offs, band_x, band_yc) -> int:
    """Bytes the copy must move: each covered texel read once, the offsets
    read and the patches written once."""
    covered = torch.zeros(texf.shape, dtype=torch.bool, device=texf.device)
    covered[_indices(texf, offs, band_x, band_yc)] = True
    n_out = offs.shape[0] * offs.shape[1] * band_x * band_yc
    return (int(covered.sum()) + n_out) * texf.element_size() + offs.numel() * 4


def bare_kernel(root: Path):
    """A bare launcher ``gather(texf, offs, band_x, band_yc)`` of the
    patch-gather kernel of the checkout at ``root``: its
    ``gmpi_tpu_torch/csrc/patch_gather.cu`` built with this package's flags
    into the build directory and called through ctypes, with no checks.  Its
    C signature is read from the source and must be one of ``SIGNATURES``
    (one that takes a launch geometry is handed this package's
    ``launch_geometry``); another raises."""
    src = Path(root) / "gmpi_tpu_torch" / "csrc" / "patch_gather.cu"
    text = src.read_text()
    sig = re.search(r'extern "C" int gmpi_patch_gather\(([^)]*)\)', text)
    names = tuple(re.findall(r"(\w+)\s*$", p.strip())[0] for p in sig.group(1).split(",")) \
        if sig else ()
    if names not in SIGNATURES:
        raise RuntimeError(f"{src}: gmpi_patch_gather{names} is not a signature this tool knows")
    takes_geometry = SIGNATURES[names]
    key = hashlib.sha256(text.encode() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    out = _build.BUILD_DIR / f"bare_patch_gather-{key[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, timeout=600, capture_output=True)
    fn = ctypes.CDLL(str(out)).gmpi_patch_gather
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (len(names) - 4) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def gather(texf, offs, band_x, band_yc):
        n, wp, hpc = texf.shape
        y = torch.empty((n, offs.shape[1], band_x, band_yc), dtype=texf.dtype, device=texf.device)
        geo = pg.launch_geometry(hpc, band_x, band_yc, texf.element_size(),
                                 base_aligned=texf.data_ptr() % 16 == 0)
        err = fn(texf.data_ptr(), offs.data_ptr(), y.data_ptr(), n, offs.shape[1], wp, hpc,
                 band_x, band_yc, texf.element_size(), *(tuple(geo)[1:] if takes_geometry else ()),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{src}: patch_gather failed: {err}")
        return y

    return gather


def sweep_geometries(hpc, band_x, band_yc, es):
    """The TMA geometries of ``SWEEP`` at this shape whose stages fit a
    block's shared memory (as the kernel lays it out: the mbarriers and
    alignment slack, then per stage a box one 16-byte word wider than
    stored, on 128 bytes)."""
    default = pg.launch_geometry(hpc, band_x, band_yc, es)
    geos = {}
    for b, s, lag in SWEEP:
        rows, chunks = pg._even_split(band_x, min(pg.TMA_BOX, b // (default.box_cols * es)))
        stage = -(-(default.box_cols * es + 16) * rows // 128) * 128
        if 256 + s * stage <= SMEM_BYTES:
            geos[f"tma {b // 1024} KB x {s}, lag {lag}"] = default._replace(
                rows=rows, chunks=chunks, stages=s, lag=lag)
    return geos


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_patch_gather: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    rate = roofline.chip_for(torch.cuda.get_device_name(0)).hbm_gbps * 1e9
    this = bare_kernel(Path(__file__).resolve().parents[2])
    parents = {str(p): bare_kernel(p) for p in args.parent}
    record = {"card": card, "runs": {}}
    for size in SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            name = f"{size} {str(dtype).split('.')[1]}"
            texf, offs, band_x, band_yc = synthetic_inputs(size, dtype, dev)
            ref = pg.gather_patches_ref(texf, offs, band_x, band_yc)
            hpc, es = texf.shape[2], texf.element_size()
            idx = _indices(texf, offs, band_x, band_yc)
            rec = {"shape": [list(texf.shape), list(offs.shape), band_x, band_yc],
                   "bound_ms": needed_bytes(texf, offs, band_x, band_yc) / rate * 1e3}
            wrapper = lambda: pg.gather_patches(texf, offs, band_x, band_yc,  # noqa: E731
                                                validate=False)
            fns = {"wrapper": wrapper}
            geos = {"tma": pg.launch_geometry(hpc, band_x, band_yc, es),
                    "loop": pg.launch_geometry(hpc, band_x, band_yc, es, base_aligned=False)}
            if args.sweep:
                geos.update(sweep_geometries(hpc, band_x, band_yc, es))
            for key, geo in geos.items():
                out = torch.empty_like(ref)
                fns[key] = lambda geo=geo, out=out: (pg._launch(texf, offs, out, geo), out)[1]
            fns["bare"] = lambda: this(texf, offs, band_x, band_yc)
            for key, fn in fns.items():
                if not torch.equal(fn(), ref):
                    raise RuntimeError(f"patch_gather [{name}, {key}] is not an exact copy")
                rec[key] = {"ms": _time(fn, args.iters), "queued_ms": _time(fn, args.iters, 10)}
                if key in ("wrapper", "bare"):
                    rec[key]["host_us"] = _host_us(fn)
                if key in geos:
                    rec[key]["geometry"] = tuple(geos[key])
                print(f"[{name}] {key}: {rec[key]} ({card})", flush=True)
            rec["plain_ms"] = _time(lambda: pg.gather_patches_ref(texf, offs, band_x, band_yc),
                                    args.iters)
            rec["library_ms"] = _time(lambda: texf[idx], args.iters)
            other = torch.empty_like(ref)  # streams of the patches' size: writes alone, a copy
            rec["fill_ms"] = _time(lambda: other.fill_(1), args.iters, queued=10)
            rec["copy_ms"] = _time(lambda: other.copy_(ref), args.iters, queued=10)
            del other
            for root, parent in parents.items():
                same = torch.equal(parent(texf, offs, band_x, band_yc), ref)
                turns = {"this": [], "parent": [], "parent_exact": same}
                for who in ("this", "parent", "parent", "this"):
                    fn = (lambda: this(texf, offs, band_x, band_yc)) if who == "this" else (
                        lambda: parent(texf, offs, band_x, band_yc))
                    turns[who].append([_time(fn, args.iters), _time(fn, args.iters, queued=10)])
                rec.setdefault("turns", {})[root] = turns
            print(f"[{name}] " + json.dumps({k: v for k, v in rec.items() if k not in fns})
                  + f" ({card})", flush=True)
            record["runs"][name] = rec
            del texf, offs, ref, idx, fns
            torch.cuda.empty_cache()
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
