"""Structure-of-arrays 3-vectors over torch tensors.

The port keeps the JAX package's layout: a `V3` of three flat (N,) planes
rather than an (N, 3) array, so every public function takes and returns the
same shapes as its counterpart in fspt_tpu and the tests compare like with
like.  `V3` itself is a plain NamedTuple (the host scene compiler stores
numpy planes in it); the helpers below work on tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class V3(NamedTuple):
    x: Any
    y: Any
    z: Any

    # NamedTuple would define tuple-concat +; override with elementwise ops.
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

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def splat(c, like):
    """V3 of three planes filled with `c`, shaped like `like`."""
    p = torch.full_like(like, c)
    return V3(p, p, p)


def to_array(v: V3):
    return torch.stack([v.x, v.y, v.z], dim=-1)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(v: V3):
    return torch.sqrt(dot(v, v))


def normalize(v: V3, eps: float = 1.0e-20) -> V3:
    inv = torch.reciprocal(torch.clamp(length(v), min=eps))
    return v * inv


def where(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x),
              torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def gather(tab: V3, idx) -> V3:
    """Component-wise flat gather: tab of (S,) planes, idx (N,) -> V3."""
    return V3(tab.x[idx], tab.y[idx], tab.z[idx])


def cat(vs) -> V3:
    """Concatenate a sequence of V3 plane-wise."""
    return V3(torch.cat([v.x for v in vs]), torch.cat([v.y for v in vs]),
              torch.cat([v.z for v in vs]))
