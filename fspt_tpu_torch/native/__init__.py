"""Native (C++) runtime components, loaded through ctypes.

The reference has no native tier at all (everything is browser JS + GLSL,
SURVEY.md §2); this package holds the host-side pieces that deserve native
speed in a production framework.  Currently: the binned-SAH BVH builder
(bvh_builder.cpp), replacing the reference's per-node full-sweep JS build
(reference bvh.js:19-31) on large scenes.

Compilation model: no pip-installable extension machinery is assumed — the
shared object is compiled on first use with g++ into a cache directory keyed
by a source hash, then dlopened with ctypes.  If no compiler is available the
callers fall back to the NumPy builders (scene/bvh.py, scene/fastbvh.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "bvh_builder.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _cache_dir() -> str:
    base = os.environ.get("FSPT_NATIVE_CACHE") or os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"),
        "fspt_tpu")
    os.makedirs(base, exist_ok=True)
    return base


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"libfspt_native_{tag}.so")
    if os.path.exists(out):
        return out
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", "", _SRC]
    # build to a temp name then atomically rename (concurrent processes)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_cache_dir())
    os.close(fd)
    cmd[-2] = tmp
    cmd.insert(1, "-march=native")
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        try:  # retry without -march=native (unsupported on some toolchains)
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            os.unlink(tmp)
            return None
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The compiled native library, or None when unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _build()
        if path is None:
            _load_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.fspt_build_bvh.restype = ctypes.c_int
        lib.fspt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # tri_min
            ctypes.POINTER(ctypes.c_float),   # tri_max
            ctypes.c_int64,                   # n
            ctypes.c_int32,                   # leaf_size
            ctypes.POINTER(ctypes.c_int32),   # left
            ctypes.POINTER(ctypes.c_int32),   # right
            ctypes.POINTER(ctypes.c_int32),   # tri_offset
            ctypes.POINTER(ctypes.c_float),   # node_min
            ctypes.POINTER(ctypes.c_float),   # node_max
            ctypes.POINTER(ctypes.c_int64),   # slot_tri
            ctypes.POINTER(ctypes.c_int64),   # out_counts
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
