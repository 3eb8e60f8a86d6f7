"""ctypes binding for the native PNG decoder ``native/fastpng.cpp`` (port of
``gmpi_tpu/data/fastpng.py``).

The decoder is the reference's ``pyspng`` role (``gmpi/datasets.py:109-111``):
host-side PNG decode is what bounds the data loader at high resolution.  It
is a host library, not a device kernel.  On first use ``g++ -O3 -shared
-fPIC ... -lz`` builds it into ``build/gmpi_tpu_torch/fastpng-<hash>.so``
under the repository root, keyed by a hash of the source and the flags (as
``ops/_build.py`` keys the CUDA kernels); nothing is written next to the
source.  When the build fails (no compiler, no zlib) :func:`available` is
False, :func:`build_log` says why, and the datasets decode with PIL, as the
JAX package does; ``datasets.DECODES`` counts which decoder ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "fastpng.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gmpi_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_state = {"tried": False, "lib": None, "log": ""}


def library_path() -> Path:
    """Where the built library lives: ``build/gmpi_tpu_torch/fastpng-<hash>.so``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"fastpng-{h.hexdigest()[:16]}.so"


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        if not SRC.exists():
            _state["log"] = f"{SRC} not found"
            return None
        out = library_path()
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-lz", "-o", str(tmp)],
                                     capture_output=True, text=True, timeout=300)
                _state["log"] = res.stdout + res.stderr
                if res.returncode != 0:
                    _state["log"] = f"g++ exited {res.returncode}\n" + _state["log"]
                    return None
                os.replace(tmp, out)  # atomic: concurrent builds each write their own tmp
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            _state["log"] += f"{type(e).__name__}: {e}"
            return None
        u8p, i32, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int64
        lib.fastpng_info.argtypes = [u8p, i64, ctypes.POINTER(i32), ctypes.POINTER(i32),
                                     ctypes.POINTER(i32)]
        lib.fastpng_decode.argtypes = [u8p, i64, u8p, i32]
        lib.fastpng_box_downscale.argtypes = [u8p, i32, i32, i32, i32, u8p]
        for fn in (lib.fastpng_info, lib.fastpng_decode, lib.fastpng_box_downscale):
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        return lib


def available() -> bool:
    """True when the native decoder is built and loaded."""
    return _load() is not None


def build_log() -> str:
    """The compiler's output, or why the library is unavailable ("" when a
    built library was reused)."""
    _load()
    return _state["log"]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode(png_bytes: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> HWC uint8 array, or None if the library is unavailable or
    the file is of a kind it does not decode (the caller then uses PIL)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(png_bytes, np.uint8)
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.fastpng_info(_u8(buf), buf.size, ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.fastpng_decode(_u8(buf), buf.size, _u8(out), out.size) != 0:
        return None
    return out


def box_downscale(img: np.ndarray, factor: int) -> Optional[np.ndarray]:
    """Integer box-filter downscale (native); None on an unsupported shape or
    without the library."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if h % factor or w % factor:
        return None
    out = np.empty((h // factor, w // factor, c), np.uint8)
    rc = lib.fastpng_box_downscale(_u8(img), h, w, c, factor, _u8(out))
    return out if rc == 0 else None
