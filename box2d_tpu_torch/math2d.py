"""2D vector / rotation / transform algebra on torch tensors.

Torch counterpart of box2d_tpu/math2d.py (ref: include/MathFunctions.cs).
Same conventions: a vector or rotation is a tensor whose trailing dimension
is 2 (rotations hold (cos, sin)), every function broadcasts over leading
dimensions, and all math is float32.
"""

from __future__ import annotations

import math

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def cross_sv(s, v):
    """s x v = (-s*v.y, s*v.x)."""
    return torch.stack([-s * v[..., 1], s * v[..., 0]], dim=-1)


def left_perp(v):
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def right_perp(v):
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    """Safe normalize: 0 for zero-length input."""
    return v * _safe_inv(length(v))[..., None]


def get_length_and_normalize(v):
    ln = length(v)
    return v * _safe_inv(ln)[..., None], ln


def _per_lane(s, a):
    if isinstance(s, torch.Tensor) and s.dim() == a.dim() - 1:
        return s[..., None]
    return s


def lerp(a, b, t):
    return a + (b - a) * _per_lane(t, a)


def mul_add(a, s, b):
    """a + s * b; a per-lane s broadcasts over the vector dim."""
    return a + _per_lane(s, a) * b


def mul_sub(a, s, b):
    return a - _per_lane(s, a) * b


def _safe_inv(x):
    pos = x > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def rot_identity(shape=(), device=None):
    q = torch.zeros(tuple(shape) + (2,), dtype=torch.float32, device=device)
    q[..., 0] = 1.0
    return q


def rot_normalize(q):
    mag = torch.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1])
    return q * _safe_inv(mag)[..., None]


def rot_nlerp(q1, q2, t):
    """Normalized lerp between rotations; a per-element t broadcasts over
    the component dim (ref: Rotation.NLerp)."""
    if isinstance(t, torch.Tensor) and t.dim() == q1.dim() - 1:
        t = t[..., None]
    return rot_normalize(q1 + (q2 - q1) * t)


def rot_mul(q, r):
    qc, qs = q[..., 0], q[..., 1]
    rc, rs = r[..., 0], r[..., 1]
    return torch.stack([qc * rc - qs * rs, qs * rc + qc * rs], dim=-1)


def rot_vec(q, v):
    c, s = q[..., 0], q[..., 1]
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], dim=-1)


def inv_rot_vec(q, v):
    c, s = q[..., 0], q[..., 1]
    return torch.stack([c * v[..., 0] + s * v[..., 1],
                        -s * v[..., 0] + c * v[..., 1]], dim=-1)


def rot_inv_mul(a, b):
    """inv(a) * b."""
    ac, as_ = a[..., 0], a[..., 1]
    bc, bs = b[..., 0], b[..., 1]
    return torch.stack([ac * bc + as_ * bs, ac * bs - as_ * bc], dim=-1)


def transform_point(p, q, v):
    return rot_vec(q, v) + p


def inv_mul_transforms(pa, qa, pb, qb):
    """inv(A)*B: frame-B-local points into frame-A-local points."""
    return inv_rot_vec(qa, pb - pa), rot_inv_mul(qa, qb)


def softness(hertz, zeta, h):
    """(bias_rate, mass_scale, impulse_scale) of the TGS-soft solver; zero
    hertz disables the bias (ref: src/Solver.cs:10-26)."""
    omega = 2.0 * math.pi * hertz
    a1 = 2.0 * zeta + h * omega
    a2 = h * omega * a1
    a3 = 1.0 / (1.0 + a2)
    safe = hertz != 0.0
    zero = torch.zeros_like(a1)
    a1_safe = torch.where(a1 != 0.0, a1, torch.ones_like(a1))
    return (torch.where(safe, omega / a1_safe, zero),
            torch.where(safe, a2 * a3, zero),
            torch.where(safe, a3, zero))
