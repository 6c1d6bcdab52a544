"""Counter-based random numbers for the integrator (port of fspt_tpu.core.rng).

The design is the JAX package's, value for value: a per-sample key from
threefry-2x32 (what `jax.random.key` / `fold_in` compute), and per-lane,
per-stream uniforms from PCG4D over the counter (lane, k0, k1,
stream<<8|row).  The value at (row, lane) is a pure function of
(key, stream, row, global lane id), so shards and cross-sample batches draw
their exact slice of the single-device streams.

Keys live on the host: a key is a (2,) uint32 numpy array (the key data
`jax.random.key_data` would return).  Threefry runs in numpy on a handful of
values per sample step; only PCG4D runs on the device.  A sample step
replayed from a CUDA graph (runtime/renderer.py) reads the same key data
from a device table that the host rewrites before each replay.

On a CUDA device PCG4D is one launch of a hand-written kernel on native u32
(csrc/pcg4d.cu behind ops/pcg4d.py `pcg4d_uniforms`).  On the CPU it runs
as plain PyTorch (`stream_uniforms_reference`), which is also the kernel's
oracle: torch has no complete uint32 arithmetic, so there PCG4D runs in
int64 holding values in [0, 2^32), every product and sum masked back to 32
bits and a 32x32-bit product split into 16-bit halves so it never leaves
int64.  The u32 registers wrap where the masks cut, so the two agree bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from fspt_tpu_torch.ops.pcg4d import pcg4d_uniforms

_M32 = 0xFFFFFFFF


# ---- threefry-2x32 on the host (jax.random's default PRNG) ----------------

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry_2x32(k0: int, k1: int, x0: int, x1: int):
    """One threefry-2x32 block (20 rounds) of the counter (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> np.ndarray:
    """Key data of `jax.random.key(seed)` under JAX's default 32-bit mode:
    the seed taken mod 2^32 as (0, seed)."""
    return np.array([0, int(seed) & _M32], np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """Key data of `jax.random.fold_in(k, data)`: the counter (0, data)
    hashed under k."""
    return np.array(threefry_2x32(int(k[0]), int(k[1]), 0,
                                  int(data) & _M32), np.uint32)


def sample_key(base_key, sample_index):
    return fold_in(base_key, sample_index)


def key_rows_for(batch_key, k: int) -> np.ndarray:
    """(K, 2) uint32 key data of fold_in(batch_key, 0..K-1) — the per-sample
    keys a cross-sample wavefront batch carries (trace_paths_batched)."""
    return np.stack([fold_in(batch_key, i) for i in range(k)])


# ---- PCG4D on the device: plain int64 version -----------------------------

def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding u32 values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _pcg4d(a, b, c, d):
    """PCG4D: four u32 (as int64) tensors in, four decorrelated ones out."""
    mul = 1664525
    add = 1013904223
    a = (a * mul + add) & _M32
    b = (b * mul + add) & _M32
    c = (c * mul + add) & _M32
    d = (d * mul + add) & _M32
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    return a, b, c, d


def stream_uniforms(key, stream: int, shape, lane_offset=0, key_rows=None,
                    lanes_per_key: int = 0, device=None):
    """Uniforms in [0, 1) for a numbered stream within one sample step.

    key: host key data, or its (2,) int64 row on the lanes' device (a
    captured sample step reads its keys from a device table, which the host
    rewrites before each replay; the numbers are the same either way).
    shape: (rows, n).  lane_offset: an int (lane ids = offset + arange(n))
    or an (n,) integer tensor of explicit global lane ids, whose device the
    result takes.  key_rows + lanes_per_key (cross-sample wavefront
    batching): lane id g hashes as (key_rows[g // lanes_per_key], stream,
    row, g % lanes_per_key); `key` is ignored then.  key_rows is a (K, 2)
    int64 tensor on the lanes' device (see `key_rows_tensor`).

    CPU lanes take the plain version (`stream_uniforms_reference`); CUDA
    lanes one launch of the kernel (ops/pcg4d.py), the same numbers bit for
    bit.
    """
    lanes = (lane_offset.device if torch.is_tensor(lane_offset)
             else torch.device(device if device is not None else "cpu"))
    draw = (pcg4d_uniforms if lanes.type == "cuda"
            else stream_uniforms_reference)
    return draw(key, stream, shape, lane_offset=lane_offset,
                key_rows=key_rows, lanes_per_key=lanes_per_key,
                device=device)


def stream_uniforms_reference(key, stream: int, shape, lane_offset=0,
                              key_rows=None, lanes_per_key: int = 0,
                              device=None):
    """`stream_uniforms` as a chain of int64 PyTorch ops, on any device:
    the CPU path and the CUDA kernel's oracle."""
    rows, n = shape
    if torch.is_tensor(lane_offset):
        ids = lane_offset.to(torch.int64) & _M32
        device = ids.device
    else:
        ids = (int(lane_offset) + torch.arange(n, dtype=torch.int64,
                                               device=device)) & _M32
    row = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    ctr = ((int(stream) << 8) & _M32) | row                # (rows, 1)
    if key_rows is None:
        if torch.is_tensor(key):
            b = key[0].expand(rows, n)
            c = key[1].expand(rows, n)
        else:
            b = torch.full((rows, n), int(key[0]), dtype=torch.int64,
                           device=device)
            c = torch.full((rows, n), int(key[1]), dtype=torch.int64,
                           device=device)
        a = ids[None, :].expand(rows, n)
    else:
        s = ids // lanes_per_key
        local = ids % lanes_per_key
        b = key_rows[s, 0][None, :].expand(rows, n)
        c = key_rows[s, 1][None, :].expand(rows, n)
        a = local[None, :].expand(rows, n)
    d = ctr.expand(rows, n)
    _, _, _, out = _pcg4d(a, b, c, d)
    # top 24 bits -> [0, 1) exactly representable in f32
    return (out >> 8).to(torch.float32) * (1.0 / (1 << 24))


def key_rows_tensor(key_rows: np.ndarray, device) -> torch.Tensor:
    """(K, 2) uint32 key data -> the int64 device tensor stream_uniforms
    takes."""
    return torch.from_numpy(key_rows.astype(np.int64)).to(device)
