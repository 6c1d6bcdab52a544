"""Frozen statement of the estimator's per-lane mathematics: the camera's
primary rays, the environment lookups and importance bins, and the UE4
microfacet BSDF with Lambert and MIS, over structure-of-arrays 3-vectors.

These are the formulas of upstream FSPT's camera.fs and tracer.fs as the
renderer defines them, operation for operation, so that the reference and
the renderer round alike lane by lane.  They are kept here as a copy: a
later change to the renderer's shading does not move the yardstick.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

M_PI = 3.14159265
M_TAU = 2.0 * M_PI
INV_PI = 1.0 / M_PI


class V3(NamedTuple):
    x: Any
    y: Any
    z: Any

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def stack(self):
        return torch.stack([self.x, self.y, self.z], dim=-1)

    @staticmethod
    def of(a):
        return V3(a[..., 0], a[..., 1], a[..., 2])


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def normalize(v: V3, eps: float = 1.0e-20) -> V3:
    return v * torch.reciprocal(torch.clamp(torch.sqrt(dot(v, v)), min=eps))


def where(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


# ---- camera (camera.fs) ----------------------------------------------------

def primary_rays(cam: dict, resolution, u, pixel):
    """Primary rays of pixels `pixel` (row-major ids) with uniforms u
    (4, L): anti-alias jitter and thin-lens depth of field."""
    width, height = resolution
    dev = u.device
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    p = f(cam["position"])
    d = f(cam["direction"])
    pos = V3(p[0], p[1], p[2])
    i = V3(d[0], d[1], d[2])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bx = normalize(cross(i, V3(zero, zero + 1.0, zero)))
    by = normalize(cross(bx, i))
    fov, focal, aperture = (f(cam["fov_scale"]), f(cam["focal_depth"]),
                            f(cam["aperture"]))
    px = torch.remainder(pixel, width).to(torch.float32)
    py = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    uvx = (px + 0.5) / width * 2.0 - 1.0
    uvy = 1.0 - (py + 0.5) / height * 2.0
    screen = (bx * (uvx * fov * (width / height)) + by * (uvy * fov)
              + i + pos)
    theta_aa = u[0] * M_TAU
    r_aa = torch.sqrt(u[1]) * 1.414
    aa = (bx * (r_aa * torch.cos(theta_aa) / width)
          + by * (r_aa * torch.sin(theta_aa) / height)) * fov
    theta_dof = u[2] * M_TAU
    r_dof = torch.sqrt(u[3]) * aperture
    dof = (bx * (torch.cos(theta_dof) * r_dof)
           + by * (torch.sin(theta_dof) * r_dof))
    origin = pos + dof
    return origin, normalize(screen + aa + dof * (1.0 - 1.0 / focal)
                             - origin)


# ---- environment (tracer.fs:410-434) ----------------------------------------

def env_uv(d: V3, theta):
    u = theta + torch.atan2(d.z, d.x) / M_TAU
    v = torch.asin(torch.clamp(-d.y, -1.0, 1.0)) * INV_PI + 0.5
    return u, v


def env_bilinear(env, d: V3, theta) -> V3:
    """GL LINEAR lookup, REPEAT in u and CLAMP_TO_EDGE in v; env is the
    (H, W, 3) radiance image."""
    h, w = env.shape[:2]
    rows = env.reshape(h * w, 3)
    u, v = env_uv(d, theta)
    x = u * w - 0.5
    y = v * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = torch.remainder(x0f.to(torch.int32), w)
    x1 = torch.remainder(x0 + 1, w)
    y0 = torch.clamp(y0f.to(torch.int32), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    top = rows[y0 * w + x0] * (1 - fx) + rows[y0 * w + x1] * fx
    bot = rows[y1 * w + x0] * (1 - fx) + rows[y1 * w + x1] * fx
    return V3.of(top * (1 - fy) + bot * fy)


def env_nearest(env, d: V3, theta) -> V3:
    h, w = env.shape[:2]
    u, v = env_uv(d, theta)
    x = torch.remainder(torch.round(u * w - 0.5).to(torch.int32), w)
    y = torch.clamp(torch.round(v * h - 0.5).to(torch.int32), 0, h - 1)
    return V3.of(env.reshape(h * w, 3)[y * w + x])


def sample_env(bins, env, theta, u1, u2, u3):
    """A direction drawn from the radiance bins: (direction, pdf, the
    radiance of the texel drawn)."""
    h, w = env.shape[:2]
    n_bins = bins.shape[0]
    nb = torch.tensor(float(n_bins), dtype=torch.float32, device=u1.device)
    idx = torch.clamp(torch.clamp((nb * u1).to(torch.int32), min=0),
                      max=n_bins - 1)
    b = bins[idx]
    x0, y0 = b[:, 0], b[:, 1]
    bw, bh = b[:, 2] - x0, b[:, 3] - y0
    px = bw * u2 + x0
    py = bh * u3 + y0
    th = ((-theta) + px / w) * M_TAU
    phi = (py / h) * M_PI
    sin_phi = torch.sin(phi)
    direction = V3(torch.cos(th) * sin_phi, torch.cos(phi),
                   torch.sin(th) * sin_phi)
    pdf = ((w * h) / nb) / torch.clamp(bw * bh * M_TAU * M_PI * sin_phi,
                                       min=1e-12)
    xi = torch.remainder(px.to(torch.int32), w)
    yi = torch.clamp(py.to(torch.int32), 0, h - 1)
    return direction, pdf, V3.of(env.reshape(h * w, 3)[yi * w + xi])


# ---- BSDF (tracer.fs:255-337) ------------------------------------------------

def _onb(n: V3):
    nz_ok = torch.abs(n.z) < 0.999
    zero, one = torch.zeros_like(n.x), torch.ones_like(n.x)
    up = V3(torch.where(nz_ok, zero, one), zero, torch.where(nz_ok, one, zero))
    t = normalize(cross(up, n))
    return t, cross(n, t)


def gtr2(ndh, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return a2 / (M_PI * t * t)


def smith_g(ndv, alpha_g):
    a = alpha_g * alpha_g
    b = ndv * ndv
    denom = ndv + torch.sqrt(torch.clamp(a + b - a * b, min=0.0))
    return torch.where(denom > 1e-7, 1.0 / torch.clamp(denom, min=1e-7),
                       torch.zeros_like(denom))


def gtr2_pdf(incident: V3, n: V3, roughness, wo: V3):
    alpha = torch.clamp(roughness, min=0.001)
    half = normalize(wo + incident)
    c = torch.abs(dot(half, n))
    return gtr2(c, alpha) * c / torch.clamp(4.0 * torch.abs(dot(wo, half)),
                                            min=1e-12)


def lambert_pdf(n: V3, wo: V3):
    return torch.abs(dot(wo, n)) * INV_PI


def schlick(incident: V3, n: V3, n1, n2):
    r = (n1 - n2) / (n1 + n2)
    r0 = r * r
    cos_theta = dot(n, incident)
    eta = n1 / n2
    sin2 = eta * eta * (1.0 - cos_theta * cos_theta)
    tir = (n1 > n2) & (sin2 > 1.0)
    cos_theta = torch.where(n1 > n2, torch.sqrt(torch.clamp(1.0 - sin2,
                                                            min=0.0)),
                            cos_theta)
    x = 1.0 - cos_theta
    x2 = x * x
    f = r0 + (1.0 - r0) * (x * (x2 * x2))
    return torch.where(tir, torch.ones_like(f), f)


def sample_ggx(n: V3, roughness, u1, u2) -> V3:
    t, b = _onb(n)
    a = torch.clamp(roughness, min=0.001)
    phi = u1 * M_TAU
    cos_theta = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return (t * (sin_theta * torch.cos(phi)) + b * (sin_theta * torch.sin(phi))
            + n * cos_theta)


def sample_cosine(n: V3, u1, u2) -> V3:
    t, b = _onb(n)
    r = torch.sqrt(u1)
    phi = M_TAU * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return t * x + b * y + n * z


def eval_specular(incident: V3, n: V3, diffuse: V3, metallic, roughness,
                  wo: V3) -> V3:
    ndl = dot(n, wo)
    ndv = dot(n, incident)
    ndh = dot(n, normalize(wo + incident))
    ds = gtr2(ndh, torch.clamp(roughness, min=0.001))
    fs = diffuse * metallic + (1.0 - metallic)
    rg = roughness * 0.5 + 0.5
    rg = rg * rg
    return fs * (smith_g(ndl, rg) * smith_g(ndv, rg) * ds)


def mis_weights(a, b, eps: float = 1e-6):
    a2, b2 = a * a, b * b
    ok = (a > eps) & (b > eps)
    safe = torch.where(ok, a2 + b2, torch.ones_like(a2))
    return (torch.where(ok, a2 / safe, torch.ones_like(a2)),
            torch.where(ok, b2 / safe, torch.zeros_like(b2)))


def reflect(i: V3, n: V3) -> V3:
    return i - n * (2.0 * dot(n, i))


def refract(i: V3, n: V3, eta) -> V3:
    ndi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    out = i * eta - n * (eta * ndi + torch.sqrt(torch.clamp(k, min=0.0)))
    zero = torch.zeros_like(out.x)
    return where(k < 0.0, V3(zero, zero, zero), out)
