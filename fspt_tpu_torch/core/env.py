"""Environment-map lookup and HDRi importance sampling over the packed env
row table (port of fspt_tpu.core.env).

Every clip/mod before a gather sits where the JAX version has it: JAX clamps
an out-of-range gather, torch raises (CPU) or asserts (CUDA), so the index
arithmetic must already be in range.  `mod` of a possibly negative int is
a floor-mod (torch.remainder); float->int casts truncate; rounding is half
to even (torch.round), as in jnp.
"""

from __future__ import annotations

import torch

from fspt_tpu_torch.core.vec import V3

M_PI = 3.14159265
M_TAU = 2.0 * M_PI
INV_PI = 1.0 / M_PI


def env_uv(direction: V3, theta):
    """Equirect direction -> uv (tracer.fs:416-418):
    u = theta + atan2(z, x) / tau  (wraps),  v = asin(-y)/pi + 0.5."""
    u = theta + torch.atan2(direction.z, direction.x) / M_TAU
    v = torch.asin(torch.clamp(-direction.y, -1.0, 1.0)) * INV_PI + 0.5
    return u, v


def bilinear_wrap_x(env_rgb: V3, hw, u, v) -> V3:
    """Sample flat channel planes at continuous uv in [0,1]: REPEAT in u,
    CLAMP_TO_EDGE in v (reference main.js:174-177), texel centers at
    (i + 0.5) / N, GL LINEAR filtering.  env_rgb: V3 of (H*W,).  One (N, 3)
    row gather per corner."""
    h, w = hw
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = torch.remainder(x0f.to(torch.int32), w)
    x1 = torch.remainder(x0 + 1, w)
    y0 = torch.clamp(y0f.to(torch.int32), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    i00 = y0 * w + x0
    i10 = y0 * w + x1
    i01 = y1 * w + x0
    i11 = y1 * w + x1
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    rows = torch.stack([env_rgb.x, env_rgb.y, env_rgb.z], dim=-1)
    out = (rows[i00] * w00[:, None] + rows[i10] * w10[:, None]
           + rows[i01] * w01[:, None] + rows[i11] * w11[:, None])
    return V3(out[:, 0], out[:, 1], out[:, 2])


def env_radiance(env_rgb: V3, hw, direction: V3, theta) -> V3:
    """V3 of (N,) radiance for V3 (N,) directions, from the flat planes
    (the integrator's fallback when no packed env table was built)."""
    u, v = env_uv(direction, theta)
    return bilinear_wrap_x(env_rgb, hw, u, v)


def pack_env_rows(env_rgb: V3, hw):
    """(H*W, 6) x-neighbor-packed env table: row (y, x) holds
    [rgb(x), rgb(x+1 mod W)], so a bilinear lookup is two row gathers."""
    h, w = hw
    rgb = torch.stack([env_rgb.x, env_rgb.y, env_rgb.z],
                      dim=-1).reshape(h, w, 3)
    nxt = torch.roll(rgb, -1, dims=1)
    return torch.cat([rgb, nxt], dim=-1).reshape(h * w, 6)


def env_radiance_rows(env6, hw, direction: V3, theta) -> V3:
    """Bilinear env radiance from the pack_env_rows table: REPEAT in u,
    CLAMP_TO_EDGE in v, GL LINEAR."""
    h, w = hw
    u, v = env_uv(direction, theta)
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = torch.remainder(x0f.to(torch.int32), w)
    y0 = torch.clamp(y0f.to(torch.int32), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    r0 = env6[y0 * w + x0]
    r1 = env6[y1 * w + x0]
    top = r0[:, 0:3] * (1 - fx) + r0[:, 3:6] * fx
    bot = r1[:, 0:3] * (1 - fx) + r1[:, 3:6] * fx
    out = top * (1 - fy) + bot * fy
    return V3(out[:, 0], out[:, 1], out[:, 2])


def env_radiance_rows_nearest(env6, hw, direction: V3, theta) -> V3:
    """Nearest-texel radiance from the pack_env_rows table: one row gather
    (the production escape lookup, cfg.escape_env_nearest)."""
    h, w = hw
    u, v = env_uv(direction, theta)
    x = torch.remainder(torch.round(u * w - 0.5).to(torch.int32), w)
    y = torch.clamp(torch.round(v * h - 0.5).to(torch.int32), 0, h - 1)
    r = env6[y * w + x]
    return V3(r[:, 0], r[:, 1], r[:, 2])


def _bin_point(bins, n_bins, u1, u2, u3):
    nb = n_bins.to(torch.float32)
    idx = torch.minimum(torch.clamp((nb * u1).to(torch.int32), min=0),
                        n_bins - 1)
    b = bins[idx]
    x0 = b[:, 0]
    y0 = b[:, 1]
    bw = b[:, 2] - x0
    bh = b[:, 3] - y0
    return nb, x0, y0, bw, bh


def _bin_direction(nb, bw, bh, px, py, env_hw, theta):
    h, w = env_hw
    u = (-theta) + px / w
    v = py / h
    th = u * M_TAU
    phi = v * M_PI
    sin_phi = torch.sin(phi)
    direction = V3(torch.cos(th) * sin_phi, torch.cos(phi),
                   torch.sin(th) * sin_phi)
    nominal = (w * h) / nb
    pdf = nominal / torch.clamp(bw * bh * M_TAU * M_PI * sin_phi, min=1e-12)
    return direction, pdf


def sample_env_bins(bins, n_bins, env_hw, theta, u1, u2, u3):
    """Draw env directions from the radiance bins (tracer.fs:421-434).
    bins: (B, 4) row table [x0, y0, x1, y1] in pixels; n_bins: 0-d int32.
    Returns (dir V3 (N,), pdf (N,))."""
    nb, x0, y0, bw, bh = _bin_point(bins, n_bins, u1, u2, u3)
    return _bin_direction(nb, bw, bh, bw * u2 + x0, bh * u3 + y0, env_hw,
                          theta)


def sample_env_bins_radiance(bins, env6, n_bins, env_hw, theta, u1, u2, u3):
    """sample_env_bins fused with the sampled texel's radiance: one nearest
    row gather at the image point the bin draw sampled.
    Returns (dir V3, pdf, radiance V3)."""
    h, w = env_hw
    nb, x0, y0, bw, bh = _bin_point(bins, n_bins, u1, u2, u3)
    px = bw * u2 + x0
    py = bh * u3 + y0
    direction, pdf = _bin_direction(nb, bw, bh, px, py, env_hw, theta)
    xi = torch.remainder(px.to(torch.int32), w)
    yi = torch.clamp(py.to(torch.int32), 0, h - 1)
    r = env6[yi * w + xi]
    return direction, pdf, V3(r[:, 0], r[:, 1], r[:, 2])
