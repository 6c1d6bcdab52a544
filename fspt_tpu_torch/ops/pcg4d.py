"""PCG4D uniforms on the card: the launch of csrc/pcg4d.cu.

`pcg4d_uniforms` takes the arguments of core/rng.py `stream_uniforms` and
returns what its plain version, `stream_uniforms_reference`, returns, bit for
bit, in one launch: the plain version is a chain of about 106 int64
elementwise ops, the kernel runs PCG4D on u32 registers (see the source's
note).  `stream_uniforms` dispatches on the lanes' device: the plain version
for CPU tensors, this wrapper for CUDA tensors.

Lane ids: an int offset (ids offset + arange(n), mod 2^32) or a 1-D int32 or
int64 tensor, read through its stride as it is (the main path's gid is a
column of the state's int row gather), so no conversion or copy runs before
the launch.  Key: host key data (two scalars), a (2,) int64 device row, or a
(K, 2) int64 `key_rows` table with `lanes_per_key` (core/rng.py).  Under CUDA
graph capture only the device forms read a key the host rewrites before each
replay.
"""

from __future__ import annotations

import ctypes

import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.traverse import count_launch

_M32 = 0xFFFFFFFF
_ID_OFFSET, _ID_INT32, _ID_INT64 = 0, 1, 2
_KEY_HOST, _KEY_ROW, _KEY_TABLE = 0, 1, 2
_ID_KINDS = {torch.int32: _ID_INT32, torch.int64: _ID_INT64}

_P, _I, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_longlong)
PCG4D_ARGTYPES = (
    [_P, _I, _L, _U]           # ids, id kind, id stride, offset
    + [_I, _P, _U, _U, _L, _U]  # key kind, key row/table, key0, key1, K,
    #                             lanes_per_key
    + [_U, _I, _I, _P, _P])     # stream << 8, rows, n, out, stream


def load_pcg4d() -> ctypes.CDLL:
    """The PCG4D library (csrc/pcg4d.cu), built on first call."""
    return _build.load("pcg4d", {"fspt_pcg4d_uniforms": PCG4D_ARGTYPES})


def _check_key_tensor(what, t, dev, table: bool):
    """A (2,) key row, or with `table` a (K, 2) key table."""
    if t.dtype != torch.int64:
        raise ValueError(f"pcg4d_uniforms: {what} must be int64, got "
                         f"{t.dtype}")
    if t.device != dev:
        raise ValueError(f"pcg4d_uniforms: {what} lies on {t.device}, the "
                         f"lanes on {dev}")
    shaped = (t.dim() == 2 and t.shape[1] == 2) if table else t.shape == (2,)
    if not (shaped and t.is_contiguous()):
        want = "(K, 2)" if table else "(2,)"
        raise ValueError(f"pcg4d_uniforms: {what} must be a contiguous "
                         f"{want} tensor, got {tuple(t.shape)}")


def pcg4d_uniforms(key, stream: int, shape, lane_offset=0, key_rows=None,
                   lanes_per_key: int = 0, device=None) -> torch.Tensor:
    """(rows, n) float32 uniforms of `stream`: core/rng.py
    `stream_uniforms` on a CUDA device, in one launch on the current stream.
    Raises on arguments the kernel does not take, and on a device that is
    not CUDA; every launch adds one to `pcg4d_uniforms.launches` (while a
    graph is captured, to `.captured`: ops/traverse.py `count_launch`)."""
    rows, n = (int(x) for x in shape)
    if rows < 0 or n < 0:
        raise ValueError(f"pcg4d_uniforms: shape {tuple(shape)} is negative")
    if torch.is_tensor(lane_offset):
        ids = lane_offset
        if ids.dtype not in _ID_KINDS:
            raise ValueError("pcg4d_uniforms: lane ids must be int32 or "
                             f"int64, got {ids.dtype}")
        if ids.shape != (n,):
            raise ValueError(f"pcg4d_uniforms: lane ids must be ({n},), got "
                             f"{tuple(ids.shape)}")
        dev = ids.device
        id_kind, offset = _ID_KINDS[ids.dtype], 0
    else:
        ids, id_kind = None, _ID_OFFSET
        offset = int(lane_offset) & _M32
        dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key0 = key1 = key_count = 0
    table = None
    if key_rows is not None:
        if not 0 < int(lanes_per_key) <= _M32:
            raise ValueError("pcg4d_uniforms: key_rows needs lanes_per_key "
                             f"in [1, 2^32), got {lanes_per_key}")
        _check_key_tensor("key_rows", key_rows, dev, table=True)
        key_kind, table, key_count = _KEY_TABLE, key_rows, key_rows.shape[0]
    elif torch.is_tensor(key):
        _check_key_tensor("key", key, dev, table=False)
        key_kind, table = _KEY_ROW, key
    else:
        key_kind = _KEY_HOST
        key0, key1 = int(key[0]) & _M32, int(key[1]) & _M32
    if dev.type != "cuda":
        raise ValueError(f"pcg4d_uniforms launches on a CUDA device, not "
                         f"{dev}; core/rng.py stream_uniforms takes the plain "
                         "version there")
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if rows == 0 or n == 0:
        return out
    lib = load_pcg4d()
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fspt_pcg4d_uniforms(
            None if ids is None else ids.data_ptr(), id_kind,
            0 if ids is None else ids.stride(0), offset, key_kind,
            None if table is None else table.data_ptr(), key0, key1,
            key_count, int(lanes_per_key) & _M32,
            (int(stream) << 8) & _M32, rows, n, out.data_ptr(),
            ctypes.c_void_p(cuda_stream))
    if err != 0:
        msg = lib.fspt_cuda_error_string(err).decode()
        raise RuntimeError(f"pcg4d kernel launch failed: {msg}")
    count_launch(pcg4d_uniforms, dev)
    return out


pcg4d_uniforms.launches = 0
pcg4d_uniforms.captured = 0
