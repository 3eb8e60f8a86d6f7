"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``gmpi_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface,
``build/gmpi_tpu_torch/<name>-<hash>.so`` under the repository root, keyed by
a hash of the sources and flags (a changed source builds anew; an unchanged
one is reused).  All sources compile in parallel, one ``nvcc`` each.  Only
repository sources are used; a missing ``nvcc`` raises.

:func:`launch` calls a built kernel's C entry point on the current stream and
counts the launch in ``LAUNCHES``, the one table of launches by kernel that
every wrapper of the port adds to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gmpi_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernel launches by kernel (the stem of its csrc/<name>.cu)
LAUNCHES = {"fused_fwd": 0, "composite_bwd": 0, "splat": 0, "adjoint": 0, "patch_gather": 0,
            "patch_sample": 0}


class Built(NamedTuple):
    path: Path
    log: str  # nvcc / ptxas output of the build ("" when reused)


_lock = threading.Lock()
_built: Dict[str, Built] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH): the CUDA kernels "
                       "of gmpi_tpu_torch are built from source at first use")


def _key(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Built]:
    """Compile every ``csrc/*.cu`` not yet built (in parallel) and return
    name -> ``Built``.  Raises with the compiler output if any build fails."""
    with _lock:
        todo = {}
        for src in sorted(CSRC.glob("*.cu")):
            if src.stem in _built:
                continue
            out = BUILD_DIR / f"{src.stem}-{_key(src)}.so"
            if out.exists():
                _built[src.stem] = Built(out, "")
            else:
                todo[src.stem] = (src, out)
        if not todo:
            return dict(_built)
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
            _built[name] = Built(out, log)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return dict(_built)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        built = build_all()
        if name not in built:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        lib = _loaded.setdefault(name, ctypes.CDLL(str(built[name].path)))
    return lib


def launch(name: str, argtypes: Sequence, dev: torch.device, *args) -> None:
    """Launch the kernel of ``csrc/<name>.cu`` (built at first use) through its
    C entry point ``gmpi_<name>(*args, stream)`` on the current stream of
    ``dev``; ``argtypes`` are the ctypes of ``args`` and the stream.  Raises if
    the launch is refused (a cudaError, or minus a CUresult), counts it in
    ``LAUNCHES`` otherwise."""
    fn = getattr(load(name), "gmpi_" + name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err > 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if err < 0:  # an entry point that encodes TMA tensor maps returns -CUresult
        raise RuntimeError(f"{name}: encoding a TMA tensor map failed: CUresult {-err}")
    LAUNCHES[name] += 1
