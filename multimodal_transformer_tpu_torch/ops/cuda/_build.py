"""Build the port's CUDA kernels with nvcc at first use and load them.

`csrc/*.cu` is compiled for Hopper (`sm_90a`), one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, named by a hash of the sources and the flags and kept in the
package's `_build/` directory (listed in `.gitignore`).  The library is
loaded with ctypes; every pointer and the stream cross as `c_void_p`.
Nothing is built when the package is imported, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# name -> argument types.  The launches return c_int (cudaGetLastError());
# the *_workspace sizes return c_longlong (bytes).
_SIGNATURES = {
    "mmtx_encoder_stack": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                           _P, _I, _I, _I, _I, _I, _I, _P],
    "mmtx_mfn_scan": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _P],
    "mmtx_mfn_scan_workspace": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I],
    "mmtx_mfn_scan_packed": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                             _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mmtx_mfn_scan_aligned": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                              _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mmtx_encoder_train_workspace": [_I, _I, _I, _I, _I, _I, _I],
    "mmtx_encoder_train_fwd": [_I, _P, _P, _P, _P, _P, _I, _P, _U, _F, _I, _P,
                               _I, _I, _I, _I, _I, _P],
    "mmtx_encoder_layer_bwd": [_I, _P, _P, _P, _P, _P, _U, _F, _I, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P],
    "mmtx_encoder_stack_bwd": [_I, _P, _P, _P, _P, _I, _P, _U, _F, _I, _P, _P,
                               _P, _I, _I, _I, _I, _I, _P],
    "mmtx_encoder_bwd_path": [_I, _I, _I, _I],
    "mmtx_encoder_train_fwd_path": [_I, _I, _I, _I],
    "mmtx_mfn_train_fwd": [_I, _P, _P, _P, _I, _P, _P, _U, _U, _F, _F, _P, _P,
                           _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mmtx_mfn_train_workspace": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I],
    "mmtx_mfn_train_bwd": [_I, _P, _P, _P, _I, _P, _P, _U, _U, _F, _F, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    "mmtx_window_embed": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P],
    "mmtx_window_embed_tiled": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _P],
    "mmtx_window_embed_tiled_plan": [_I, _I, _I, _I, _P],
    "mmtx_flash_attention": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _P],
    "mmtx_threefry": [_P, _I, ctypes.c_longlong, _I, _F, _P, _P,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong],
    "mmtx_philox": [_P, _I, ctypes.c_longlong, _I, _F, _P, _P,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# nvcc's output of the verbose build of these sources (-Xptxas -v:
# registers, shared memory and spills of every kernel), kept beside the
# library; empty until build(verbose=True)
build_log = ""


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                               "PATH); the CUDA kernels cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"libmmtx_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu unless the library for these sources exists;
    verbose: also set build_log, from the log kept beside the library, or
    by compiling again where the library was built without one."""
    global build_log
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.is_file() and not verbose:
        return out
    if out.is_file() and log_path.is_file():
        build_log = log_path.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
             "-o", str(obj), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [(p.args, p.communicate()[0], p.returncode) for p in procs]
        lib = Path(tmp) / "lib.so"
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        for args, log, rc in logs:
            if rc != 0:
                raise KernelBuildError(f"nvcc failed ({rc}): {' '.join(args)}\n"
                                       f"{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            build_log = "".join(log for _, log, _ in logs)
            print(build_log, file=sys.stderr, flush=True)
            log_path.write_text(build_log)
        os.replace(lib, out)
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The built kernel library, compiling it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_longlong if name.endswith("_workspace")
                              else ctypes.c_int)
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def pointer_array(ptrs) -> ctypes.Array:
    """A host array of device pointers (keep it alive across the call)."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)
