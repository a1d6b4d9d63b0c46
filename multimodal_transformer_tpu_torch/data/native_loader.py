"""ctypes binding of the native SENDv1 parser (native/fastload.cpp).

Counterpart of `multimodal_transformer_tpu/data/native_loader.py`, with the
same functions and return values: `available()`, `parse_table` (float32
with NaN for non-numeric cells, or None) and `window_assign` ((starts,
counts) of every completed window, or None).

The port builds the library itself, at first use: `g++` (or `$CXX`) with
the flags of native/Makefile compiles native/fastload.cpp into the package's
`_build/` directory (listed in .gitignore), named by a hash of the source,
the flags and the host's CPU (the flags hold -march=native).  The compiler
writes a temporary file that is then renamed into place, so processes that
race to build it all load a whole library.  Nothing is written under
native/, and a library found there is never loaded.  Where no compiler or
no source is found, or the build fails, every function returns None and
the reader keeps its Python path (data/send.py, data/windowing.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "fastload.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is missing, for the caller's log ("" once it is loaded)
build_error = ""


def _cpu_key() -> str:
    """The host's CPU model and flags, which -march=native compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_key().encode())
    return BUILD_DIR / f"libfastload_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/fastload.cpp unless the library for this source,
    these flags and this CPU exists; raises when it cannot."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".fastload_",
                               suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-shared", "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        lib.parse_table.restype = ctypes.c_int
        lib.parse_table.argtypes = [
            ctypes.c_char_p, ctypes.c_char,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_char_p)]
        lib.window_assign.restype = ctypes.c_int64
        lib.window_assign.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
        lib.fastload_free.restype = None
        lib.fastload_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_table(path: str, fmt: str) -> Optional[Tuple[np.ndarray,
                                                       List[str]]]:
    """Parse a numeric table.  Returns (data [rows, cols] float32 with NaNs
    for non-numeric cells, column labels) or None if unavailable or the
    file is malformed (a row wider than its header)."""
    lib = _load()
    if lib is None:
        return None
    delim = {"tsv": b"\t", "ssv": b" ", "csv": b",", "txt": b","}[fmt]
    data_p = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    header_p = ctypes.c_char_p()
    rc = lib.parse_table(path.encode(), ctypes.c_char(delim),
                         ctypes.byref(data_p), ctypes.byref(rows),
                         ctypes.byref(cols), ctypes.byref(header_p))
    if rc != 0:
        return None
    n, c = rows.value, cols.value
    arr = np.ctypeslib.as_array(data_p, shape=(n, c)).copy()
    header = header_p.value.decode().split("\n")
    lib.fastload_free(data_p)
    lib.fastload_free(ctypes.cast(header_p, ctypes.c_void_p))
    return arr, header


def window_assign(times: np.ndarray,
                  window_size: float) -> Optional[Tuple[np.ndarray,
                                                        np.ndarray]]:
    """Native windowing assignment; returns (starts, counts) per window, or
    None when unavailable or a time is not finite (the native loop would
    never end on it)."""
    lib = _load()
    t = np.ascontiguousarray(times, dtype=np.float64)
    if lib is None or not np.all(np.isfinite(t)):
        return None
    starts_p = ctypes.POINTER(ctypes.c_int64)()
    counts_p = ctypes.POINTER(ctypes.c_int64)()
    nw = lib.window_assign(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(t),
        float(window_size), ctypes.byref(starts_p), ctypes.byref(counts_p))
    if nw < 0:
        return None
    if nw == 0:
        lib.fastload_free(starts_p)
        lib.fastload_free(counts_p)
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.ctypeslib.as_array(starts_p, shape=(nw,)).copy()
    counts = np.ctypeslib.as_array(counts_p, shape=(nw,)).copy()
    lib.fastload_free(starts_p)
    lib.fastload_free(counts_p)
    return starts, counts
