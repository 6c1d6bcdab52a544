"""Counter-based random numbers of the renderer's estimator, written out
plainly: a per-sample key from threefry-2x32 (the values `jax.random.key`
and `fold_in` give), and per-lane uniforms from PCG4D over the counter
(lane, k0, k1, stream << 8 | row).  A frozen statement of the streams the
program's estimator draws from: the uniform at (stream, row, lane) of a
sample is a pure function of the sample's key and the lane's id within the
sample.

PCG4D runs in int64 tensors holding values in [0, 2^32).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry_2x32(k0: int, k1: int, x0: int, x1: int):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int):
    """The key of a seed: (0, seed mod 2^32)."""
    return (0, int(seed) & M32)


def fold_in(k, data: int):
    return threefry_2x32(int(k[0]), int(k[1]), 0, int(data) & M32)


def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _pcg4d(a, b, c, d):
    a = (a * 1664525 + 1013904223) & M32
    b = (b * 1664525 + 1013904223) & M32
    c = (c * 1664525 + 1013904223) & M32
    d = (d * 1664525 + 1013904223) & M32
    a = (a + _mul32(b, d)) & M32
    b = (b + _mul32(c, a)) & M32
    c = (c + _mul32(a, b)) & M32
    d = (d + _mul32(b, c)) & M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & M32
    b = (b + _mul32(c, a)) & M32
    c = (c + _mul32(a, b)) & M32
    d = (d + _mul32(b, c)) & M32
    return d


def uniforms(k0, k1, lane, stream: int, rows: int):
    """(rows, L) float32 uniforms in [0, 1) of `stream` for lanes whose
    sample keys are (k0, k1) and whose ids within their sample are `lane`
    (three (L,) int64 tensors)."""
    row = torch.arange(rows, dtype=torch.int64, device=lane.device)[:, None]
    ctr = ((int(stream) << 8) & M32) | row
    shape = (rows, lane.shape[0])
    out = _pcg4d(lane[None, :].expand(shape), k0[None, :].expand(shape),
                 k1[None, :].expand(shape), ctr.expand(shape))
    return (out >> 8).to(torch.float32) * (1.0 / (1 << 24))


def key_planes(keys, lanes_per_key: int, device):
    """(k0, k1) int64 planes of K keys, each repeated over its lanes."""
    arr = torch.tensor(np.asarray(keys, np.int64).reshape(-1, 2),
                       device=device)
    return (arr[:, 0].repeat_interleave(lanes_per_key),
            arr[:, 1].repeat_interleave(lanes_per_key))
