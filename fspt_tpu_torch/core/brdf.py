"""UE4-style microfacet BRDF: GGX/GTR2 + Smith G + Schlick Fresnel, metallic
workflow, plus cosine-weighted Lambert — sampling, eval, and pdfs (port of
fspt_tpu.core.brdf).  SoA, elementwise over flat (N,) planes.

Integer powers are written as the products JAX's integer_pow lowers to
(x**2 = x*x, x**5 = x * (x*x)*(x*x)), not torch.pow, so float32 rounding
matches the reference.
"""

from __future__ import annotations

import torch

from fspt_tpu_torch.core.vec import V3, cross, dot, normalize, where

M_PI = 3.14159265
M_TAU = 2.0 * M_PI
INV_PI = 1.0 / M_PI


def _sq(x):
    return x * x


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def onb(normal: V3):
    """Orthonormal basis about `normal`: up = |n.z| < 0.999 ? z : x."""
    nz_ok = torch.abs(normal.z) < 0.999
    zero = torch.zeros_like(normal.x)
    one = torch.ones_like(normal.x)
    up = V3(torch.where(nz_ok, zero, one), zero, torch.where(nz_ok, one, zero))
    tangent = normalize(cross(up, normal))
    bitangent = cross(normal, tangent)
    return tangent, bitangent


def gtr2(ndh, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return a2 / (M_PI * t * t)


def smith_g(ndv, alpha_g):
    """Smith geometric shadowing; 0 for a fully shadowed direction (the
    JAX version's deviation from the reference's 1/~0)."""
    a = alpha_g * alpha_g
    b = ndv * ndv
    denom = ndv + torch.sqrt(torch.clamp(a + b - a * b, min=0.0))
    return torch.where(denom > 1e-7, 1.0 / torch.clamp(denom, min=1e-7),
                       torch.zeros_like(denom))


def gtr2_pdf(incident: V3, normal: V3, roughness, bsdf_dir: V3):
    """pdf of the reflected direction under GGX half-vector sampling."""
    alpha = torch.clamp(roughness, min=0.001)
    half = normalize(bsdf_dir + incident)
    cos_theta = torch.abs(dot(half, normal))
    pdf_h = gtr2(cos_theta, alpha) * cos_theta
    return pdf_h / torch.clamp(4.0 * torch.abs(dot(bsdf_dir, half)),
                               min=1e-12)


def lambert_pdf(normal: V3, bsdf_dir: V3):
    return torch.abs(dot(bsdf_dir, normal)) * INV_PI


def schlick(incident: V3, normal: V3, n1, n2):
    """Fresnel with total internal reflection.
    n1 = medium of incident ray, n2 = other side."""
    r0 = _sq((n1 - n2) / (n1 + n2))
    cos_theta = dot(normal, incident)
    n = n1 / n2
    sin_theta2 = n * n * (1.0 - cos_theta * cos_theta)
    tir = (n1 > n2) & (sin_theta2 > 1.0)
    cos_theta = torch.where(n1 > n2,
                            torch.sqrt(torch.clamp(1.0 - sin_theta2,
                                                   min=0.0)),
                            cos_theta)
    x = 1.0 - cos_theta
    f = r0 + (1.0 - r0) * _pow5(x)
    return torch.where(tir, torch.ones_like(f), f)


def sample_microfacet(normal: V3, roughness, u1, u2) -> V3:
    """GGX half-vector sample about `normal`."""
    tangent, bitangent = onb(normal)
    a = torch.clamp(roughness, min=0.001)
    phi = u1 * M_TAU
    cos_theta = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_theta = torch.sqrt(torch.clamp(1.0 - _sq(cos_theta), min=0.0))
    return (tangent * (sin_theta * torch.cos(phi))
            + bitangent * (sin_theta * torch.sin(phi))
            + normal * cos_theta)


def sample_lambert(normal: V3, u1, u2) -> V3:
    """Cosine-weighted hemisphere about `normal`."""
    tangent, bitangent = onb(normal)
    r = torch.sqrt(u1)
    phi = M_TAU * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return tangent * x + bitangent * y + normal * z


def eval_specular(incident: V3, normal: V3, diffuse: V3, metallic,
                  roughness, bsdf_dir: V3) -> V3:
    """Gs * Fs * Ds (tracer.fs:282-294)."""
    ndl = dot(normal, bsdf_dir)
    ndv = dot(normal, incident)
    h = normalize(bsdf_dir + incident)
    ndh = dot(normal, h)
    a = torch.clamp(roughness, min=0.001)
    ds = gtr2(ndh, a)
    fs = diffuse * metallic + (1.0 - metallic)
    roughg = _sq(roughness * 0.5 + 0.5)
    gs = smith_g(ndl, roughg) * smith_g(ndv, roughg)
    return fs * (gs * ds)


def eval_lambert(diffuse: V3) -> V3:
    return diffuse * INV_PI


def mis_weights(a, b, eps: float = 1e-6):
    """Power heuristic a^2/(a^2+b^2). Returns (wa, wb); degenerate pdfs give
    (1, 0)."""
    a2 = a * a
    b2 = b * b
    denom = a2 + b2
    ok = (a > eps) & (b > eps)
    safe = torch.where(ok, denom, torch.ones_like(denom))
    wa = torch.where(ok, a2 / safe, torch.ones_like(a2))
    wb = torch.where(ok, b2 / safe, torch.zeros_like(b2))
    return wa, wb


def reflect(incident_neg: V3, n: V3) -> V3:
    """GLSL reflect(I, N) = I - 2 dot(N, I) N."""
    return incident_neg - n * (2.0 * dot(n, incident_neg))


def refract(incident_neg: V3, n: V3, eta) -> V3:
    """GLSL refract(I, N, eta); returns the 0-vector on TIR."""
    ndi = dot(n, incident_neg)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    tir = k < 0.0
    out = incident_neg * eta - n * (eta * ndi
                                    + torch.sqrt(torch.clamp(k, min=0.0)))
    zero = torch.zeros_like(out.x)
    return where(tir, V3(zero, zero, zero), out)
