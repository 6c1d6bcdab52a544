"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source under csrc/ exposes a plain C interface and is compiled
by `nvcc` alone into a shared library (no PyTorch headers, so a build takes
seconds), for sm_90a (Hopper).  The library lands in fspt_tpu_torch/_build/
under a name keyed by a hash of the source and flags, so an edited source
rebuilds and an unchanged one is loaded as is.  `ptxas -v` output (registers,
spills, stack frame) is kept beside it in a .log file.

Nothing here runs at import: the CPU tests import every module on a machine
without nvcc.  A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
# name -> {"path", "seconds" (0.0 when loaded from a previous build), "log"}
build_info = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    return path


def _source_text(path: str) -> bytes:
    """A source and, in turn, every file of csrc/ it includes: an edited
    include rebuilds too."""
    with open(path, "rb") as f:
        text = f.read()
    for inc in re.findall(rb'^#include "([^"]+)"', text, re.M):
        text += _source_text(os.path.join(CSRC, inc.decode()))
    return text


def _build(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    text = _source_text(src)
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libfspt_{name}_{tag}.so")
    log = out + ".log"
    if os.path.exists(out):
        if build_info.get(name, {}).get("path") != out:
            with open(log) as f:
                build_info[name] = {"path": out, "seconds": 0.0,
                                    "log": f.read()}
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    build_info[name] = {"path": out, "seconds": seconds,
                        "log": proc.stdout + proc.stderr}
    return out


def build_all(names) -> None:
    """Build the named sources concurrently (one nvcc each), so that later
    `load` calls find them built."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(_build, name) for name in names]:
            fut.result()


def load(name: str, argtypes) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, built on first call.
    argtypes: {function name: ctypes argtypes}; every function returns an
    int (a cudaError_t), and every library also exports
    `fspt_cuda_error_string`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            lib.fspt_cuda_error_string.restype = ctypes.c_char_p
            lib.fspt_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        # (a later caller may name functions an earlier one did not)
        for fn, types in argtypes.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = list(types)
        return lib
