"""Batched short-Weierstrass (a = 0) Jacobian point arithmetic.

Port of the SW half of ``zkmpc_tpu/ops/curve.py``: BLS12-377 G1 (over Fq)
and G2 (over Fq2), generic over the coordinate field.  ``add_unsafe``
assumes the two finite inputs are neither equal nor negatives; ladders use
it below the top bit and ``sw_add_complete`` (kernels K2/K3 on the card)
everywhere a collision is possible.
"""

from __future__ import annotations

import numpy as np
import torch

from .fp2 import Fp2Array
from .limbs import FQ, FpArray


def _field_select(cond, a, b):
    return type(a).select(cond, a, b)


def _coord_leaves(f):
    if isinstance(f, FpArray):
        return [f.limbs]
    return _coord_leaves(f.c0) + _coord_leaves(f.c1)


def _map_coord(f, fn):
    if isinstance(f, FpArray):
        return FpArray(fn(f.limbs), f.spec, f.bound)
    return Fp2Array(_map_coord(f.c0, fn), _map_coord(f.c1, fn))


class SWPoint:
    """Batch of Jacobian points (X, Y, Z) with an explicit infinity mask.

    Infinity has inf=True (coords arbitrary).  The curve has a=0.
    """

    __slots__ = ("x", "y", "z", "inf")

    def __init__(self, x, y, z, inf):
        self.x = x
        self.y = y
        self.z = z
        self.inf = inf

    @property
    def shape(self):
        return self.x.shape

    @property
    def device(self):
        return self.inf.device

    def map(self, limb_fn, inf_fn=None):
        """Apply ``limb_fn`` to every coordinate limb tensor (batch axes
        first, limb axis last) and ``inf_fn`` (default: the same) to the
        infinity mask."""
        inf_fn = inf_fn or limb_fn
        return SWPoint(_map_coord(self.x, limb_fn), _map_coord(self.y, limb_fn),
                       _map_coord(self.z, limb_fn), inf_fn(self.inf))

    def leaves(self):
        """Coordinate limb tensors, then the infinity mask."""
        return (_coord_leaves(self.x) + _coord_leaves(self.y) +
                _coord_leaves(self.z) + [self.inf])

    def __getitem__(self, idx):
        return SWPoint(self.x[idx], self.y[idx], self.z[idx], self.inf[idx])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return SWPoint(self.x.reshape(*shape), self.y.reshape(*shape),
                       self.z.reshape(*shape), self.inf.reshape(shape))

    def tighten(self):
        return SWPoint(self.x.tighten(), self.y.tighten(), self.z.tighten(),
                       self.inf)

    @staticmethod
    def select(cond, a: "SWPoint", b: "SWPoint"):
        return SWPoint(_field_select(cond, a.x, b.x),
                       _field_select(cond, a.y, b.y),
                       _field_select(cond, a.z, b.z),
                       torch.where(cond, a.inf, b.inf))

    @staticmethod
    def concat(points, axis=0):
        cls0 = type(points[0].x)
        # coord limb arrays have a trailing limb axis: shift negative axes
        caxis = axis - 1 if axis < 0 else axis
        return SWPoint(cls0.concat([p.x for p in points], caxis),
                       cls0.concat([p.y for p in points], caxis),
                       cls0.concat([p.z for p in points], caxis),
                       torch.cat([p.inf for p in points], dim=axis))

    # ------------------------------------------------------------ constructors

    @classmethod
    def g1_from_affine_ints(cls, xy_list, device="cuda"):
        """[(x, y) or None, ...] -> batched G1 points."""
        xs = np.asarray([0 if t is None else t[0] for t in xy_list], dtype=object)
        ys = np.asarray([1 if t is None else t[1] for t in xy_list], dtype=object)
        inf = torch.as_tensor([t is None for t in xy_list], dtype=torch.bool,
                              device=device)
        x = FpArray.from_int(FQ, xs, device=device)
        y = FpArray.from_int(FQ, ys, device=device)
        z = FpArray.ones(FQ, (len(xy_list),), device)
        return cls(x, y, z, inf)

    @classmethod
    def g2_from_affine_ints(cls, xy_list, device="cuda"):
        """[((x0,x1),(y0,y1)) or None, ...] -> batched G2 points."""
        def comp(i, j, default):
            return np.asarray(
                [default if t is None else t[i][j] for t in xy_list], dtype=object)
        inf = torch.as_tensor([t is None for t in xy_list], dtype=torch.bool,
                              device=device)
        x = Fp2Array(FpArray.from_int(FQ, comp(0, 0, 0), device=device),
                     FpArray.from_int(FQ, comp(0, 1, 0), device=device))
        y = Fp2Array(FpArray.from_int(FQ, comp(1, 0, 1), device=device),
                     FpArray.from_int(FQ, comp(1, 1, 0), device=device))
        n = len(xy_list)
        z = Fp2Array(FpArray.ones(FQ, (n,), device), FpArray.zeros(FQ, (n,), device))
        return cls(x, y, z, inf)

    @classmethod
    def infinity_like(cls, other: "SWPoint"):
        dev = other.device
        if isinstance(other.x, FpArray):
            one = FpArray.ones(other.x.spec, other.shape, dev)
        else:
            one = Fp2Array.ones(other.shape, dev)
        return cls(one, one, one, torch.ones(other.shape, dtype=torch.bool,
                                             device=dev))

    # ---------------------------------------------------------------- to host

    def to_affine_ints(self):
        """Host-side: canonical affine coordinates (None for infinity)."""
        zinv = self.z.inv()
        zinv2 = zinv.square()
        ax = self.x * zinv2
        ay = self.y * zinv2 * zinv
        xs, ys = ax.to_ints().reshape(-1), ay.to_ints().reshape(-1)
        inf = self.inf.detach().cpu().numpy().reshape(-1)
        return [None if inf[i] else (xs[i], ys[i]) for i in range(xs.size)]


def sw_double(p: SWPoint) -> SWPoint:
    """dbl-2009-l (a=0).  Correctly keeps infinity at infinity."""
    a = p.x.square()
    b = p.y.square()
    c = b.square()
    d = ((p.x + b).square() - a - c).double()
    e = a.smul(3)
    f = e.square()
    x3 = f - d.double()
    y3 = e * (d - x3) - c.smul(8)
    z3 = (p.y * p.z).double()
    return SWPoint(x3.tighten(), y3.tighten(), z3.tighten(), p.inf)


def _sw_add_core(p: SWPoint, q: SWPoint):
    """add-2007-bl for two finite points; returns result + (h, r) for case tests."""
    z1z1 = p.z.square()
    z2z2 = q.z.square()
    u1 = p.x * z2z2
    u2 = q.x * z1z1
    s1 = p.y * q.z * z2z2
    s2 = q.y * p.z * z1z1
    h = u2 - u1
    i = h.double().square()
    j = h * i
    r = (s2 - s1).double()
    v = u1 * i
    x3 = r.square() - j - v.double()
    y3 = r * (v - x3) - (s1 * j).double()
    z3 = ((p.z + q.z).square() - z1z1 - z2z2) * h
    return SWPoint(x3.tighten(), y3.tighten(), z3.tighten(),
                   p.inf & q.inf), h, r


def sw_add_unsafe(p: SWPoint, q: SWPoint) -> SWPoint:
    """Addition assuming finite inputs are neither equal nor negations."""
    out, _, _ = _sw_add_core(p, q)
    out = SWPoint.select(q.inf, p, out)
    out = SWPoint.select(p.inf, q, out)
    return out


def sw_add_complete(p: SWPoint, q: SWPoint) -> SWPoint:
    """Addition handling all cases (doubling, negation, infinity): kernel
    K2 (G1) / K3 (G2) for CUDA points, the plain formula for CPU points."""
    from .cuda_point import point_add
    return point_add(p, q)


def sw_neg(p: SWPoint) -> SWPoint:
    return SWPoint(p.x, -p.y, p.z, p.inf)


def scalar_bits(scalars: FpArray, nbits: int):
    """Canonical little-endian bits [..., nbits] (int64 0/1) of field scalars."""
    limbs = scalars.int_limbs()      # integer value, not the Montgomery form
    shifts = torch.arange(15, device=limbs.device, dtype=limbs.dtype)
    bits = (limbs[..., :, None] >> shifts) & 1
    bits = bits.reshape(bits.shape[:-2] + (-1,))
    return bits[..., :nbits]


def _coord_bound2(f):
    """Force bound metadata to 2 (sound for any value < 2p): loop carries
    keep one bound, as the reference's scan carries must."""
    if isinstance(f, FpArray):
        assert f.bound <= 2
        return FpArray(f.limbs, f.spec, 2)
    return Fp2Array(_coord_bound2(f.c0), _coord_bound2(f.c1))


def _point_bound2(p: SWPoint) -> SWPoint:
    return SWPoint(_coord_bound2(p.x), _coord_bound2(p.y), _coord_bound2(p.z),
                   p.inf)


def sw_scalar_mul(points: SWPoint, scalars: FpArray, nbits: int | None = None
                  ) -> SWPoint:
    """Batched double-and-add: out_i = scalars_i * points_i.

    All ladder steps below the top bit avoid SW exceptional cases
    (acc = (s mod 2^b)*P and base = 2^b*P collide only at b = nbits-1); the
    top step uses `sw_add_complete`."""
    nbits = nbits or scalars.spec.p.bit_length()
    bits = scalar_bits(scalars, nbits) > 0          # [..., nbits]
    acc = _point_bound2(SWPoint.infinity_like(points))
    base = _point_bound2(points.tighten())
    for b in range(nbits - 1):
        added = sw_add_unsafe(acc, base)
        acc = SWPoint.select(bits[..., b], added, acc)
        base = sw_double(base)
    added = sw_add_complete(acc, base)
    return SWPoint.select(bits[..., nbits - 1], added, acc)
