"""Primary-ray generation: pinhole basis + anti-alias jitter + thin-lens DOF
(port of fspt_tpu.core.camera).

Each expression keeps the JAX version's operand order and grouping, so the
float32 rounding is the same up to transcendental ulps (sin, cos, sqrt of
the jitter).  Scalars (fov_scale, focal_depth, aperture) may be python
floats or 0-d float32 tensors, as in the JAX version.

Image convention: row 0 = top of image.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fspt_tpu_torch.core.vec import V3, cross, normalize

M_PI = 3.14159265
M_TAU = 2.0 * M_PI


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def camera_basis(direction, device=None):
    """basisX/basisY from view dir and world-up (camera.fs:39-41).
    direction: (3,). Returns (i, bx, by) as V3 of 0-d tensors."""
    d = _f32(direction, device)
    i = V3(d[0], d[1], d[2])
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    up = V3(zero, zero + 1.0, zero)
    bx = normalize(cross(i, up))
    by = normalize(cross(bx, i))
    return i, bx, by


def generate_rays(position, direction, fov_scale, focal_depth, aperture,
                  resolution: Tuple[int, int], uniforms, pixel_idx=None):
    """Primary rays for every pixel, SoA.

    position/direction: (3,).  resolution: (width, height).
    uniforms: (4, N) float32 tensor in [0,1) — AA angle, AA radius, DOF
    angle, DOF radius; its device is the rays' device.
    pixel_idx: optional (N,) int tensor of row-major pixel ids.
    Returns (origin V3, dir V3) of (N,) planes.
    """
    width, height = resolution
    device = uniforms.device
    p = _f32(position, device)
    pos = V3(p[0], p[1], p[2])
    i, bx, by = camera_basis(direction, device)
    fov_scale = _f32(fov_scale, device)
    focal_depth = _f32(focal_depth, device)
    aperture = _f32(aperture, device)

    if pixel_idx is None:
        pixel_idx = torch.arange(width * height, dtype=torch.int32,
                                 device=device)
    px = torch.remainder(pixel_idx, width).to(torch.float32)
    py = torch.div(pixel_idx, width, rounding_mode="floor").to(torch.float32)
    uvx = (px + 0.5) / width * 2.0 - 1.0
    uvy = 1.0 - (py + 0.5) / height * 2.0

    aspect = width / height
    screen = (bx * (uvx * fov_scale * aspect) + by * (uvy * fov_scale)
              + i + pos)

    theta_aa = uniforms[0] * M_TAU
    r_aa = torch.sqrt(uniforms[1]) * 1.414
    aa = (bx * (r_aa * torch.cos(theta_aa) / width)
          + by * (r_aa * torch.sin(theta_aa) / height)) * fov_scale

    theta_dof = uniforms[2] * M_TAU
    r_dof = torch.sqrt(uniforms[3]) * aperture
    dof = (bx * (torch.cos(theta_dof) * r_dof)
           + by * (torch.sin(theta_dof) * r_dof))

    lens_x = 1.0 - 1.0 / focal_depth
    origin = pos + dof
    d = normalize(screen + aa + dof * lens_x - origin)
    return origin, d
