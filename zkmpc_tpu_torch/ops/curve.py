"""Batched elliptic-curve point arithmetic.

Port of ``zkmpc_tpu/ops/curve.py``.  Short Weierstrass (a = 0) Jacobian
points: BLS12-377 G1 (over Fq) and G2 (over Fq2), generic over the
coordinate field.  ``add_unsafe`` assumes the two finite inputs are
neither equal nor negatives; ladders use it below the top bit and
``sw_add_complete`` (kernels K2/K3 on the card) everywhere a collision is
possible.  Twisted Edwards (a = -1) points in extended coordinates over
BLS12-377 Fr: Ed-on-BLS12-377, the curve of the Pedersen commitments,
whose unified addition is complete; every product is K1 on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import params
from .fp2 import Fp2Array
from .limbs import EDFR, FQ, FR, FpArray, mul_many


def _field_select(cond, a, b):
    return type(a).select(cond, a, b)


def _fp_parts(f):
    """A coordinate's `FpArray` parts: itself, or an Fq2 element's c0, c1."""
    return [f] if isinstance(f, FpArray) else _fp_parts(f.c0) + _fp_parts(f.c1)


def _coord_leaves(f):
    return [x.limbs for x in _fp_parts(f)]


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


def _tighten_coords(*coords):
    """`tighten` of several coordinates, their Montgomery multiplies by one
    in one stacked call (`limbs.mul_many`)."""
    loose = [f for c in coords for f in _fp_parts(c) if f.bound > 2]
    if not loose:
        return coords
    spec, dev = loose[0].spec, loose[0].device
    one = FpArray(spec.const("one_limbs", dev), spec, 1)
    tight = iter(mul_many([(f, one) for f in loose]))

    def rebuild(f):
        if isinstance(f, Fp2Array):
            return Fp2Array(rebuild(f.c0), rebuild(f.c1))
        return next(tight) if f.bound > 2 else f
    return tuple(rebuild(c) for c in coords)


def sw_double(p: SWPoint) -> SWPoint:
    """dbl-2009-l (a=0).  Correctly keeps infinity at infinity.  The
    products of one dependency level go through one stacked Montgomery
    multiply (`limbs.mul_many`), each with the limbs of its own ``*``."""
    a, b, yz = mul_many([(p.x, None), (p.y, None), (p.y, p.z)])
    e = a.smul(3)
    c, xb2, f = mul_many([(b, None), (p.x + b, None), (e, None)])
    d = (xb2 - a - c).double()
    x3 = f - d.double()
    y3 = e * (d - x3) - c.smul(8)
    z3 = yz.double()
    x3, y3, z3 = _tighten_coords(x3, y3, z3)
    return SWPoint(x3, y3, z3, p.inf)


def _sw_add_core(p: SWPoint, q: SWPoint):
    """add-2007-bl for two finite points; returns result + (h, r) for case
    tests.  The products of one dependency level go through one stacked
    Montgomery multiply (`limbs.mul_many`), each with the limbs of its own
    ``*``."""
    z1z1, z2z2, y1z2, y2z1, zz = mul_many([(p.z, None), (q.z, None), (p.y, q.z),
                                           (q.y, p.z), (p.z + q.z, None)])
    u1, u2, s1, s2 = mul_many([(p.x, z2z2), (q.x, z1z1), (y1z2, z2z2), (y2z1, z1z1)])
    h = u2 - u1
    r = (s2 - s1).double()
    i, rr, z3 = mul_many([(h.double(), None), (r, None), (zz - z1z1 - z2z2, h)])
    j, v = mul_many([(h, i), (u1, i)])
    x3 = rr - j - v.double()
    ry, s1j = mul_many([(r, v - x3), (s1, j)])
    y3 = ry - s1j.double()
    x3, y3, z3 = _tighten_coords(x3, y3, z3)
    return SWPoint(x3, y3, z3, p.inf & q.inf), h, r


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


def _bcast_sw(points: SWPoint, shape) -> SWPoint:
    shape = tuple(shape)
    return SWPoint(points.x.broadcast_to(shape), points.y.broadcast_to(shape),
                   points.z.broadcast_to(shape), points.inf.expand(shape))


def scalar_digits(scalars: FpArray, nbits: int, w: int):
    """The scalars' canonical w-bit digits [..., ceil(nbits / w)], low
    digit first."""
    ndig = -(-nbits // w)
    bits = scalar_bits(scalars, nbits)                  # [..., nbits]
    bits = torch.nn.functional.pad(bits, (0, ndig * w - nbits))
    weights = 1 << torch.arange(w, device=bits.device, dtype=bits.dtype)
    return (bits.reshape(tuple(bits.shape[:-1]) + (ndig, w)) * weights).sum(dim=-1)


def window_table(base: SWPoint, w: int) -> SWPoint:
    """T[d] = d * base for d < 2^w, [2^w, *base.shape]: a double, then
    adds of base to T[d - 1] (which is neither base nor -base for
    2 < d < 2^w)."""
    base = _point_bound2(base.tighten())
    table = [SWPoint.infinity_like(base), base, sw_double(base)]
    while len(table) < 1 << w:
        table.append(sw_add_unsafe(table[-1], base))
    return _stack_points([_point_bound2(t) for t in table])


def sw_scalar_mul(points: SWPoint, scalars: FpArray, nbits: int | None = None
                  ) -> SWPoint:
    """Batched fixed-window ladder: out_i = scalars_i * points_i, the points
    broadcasting against the scalars' batch shape (the table of a point
    that several lanes share, such as an MSM base under every party's
    shares, is built once).

    Windows of w = 4 bits from the top (Horner): acc = 2^w acc + T[digit],
    T[d] = d*P (a table of 16 points, then 4 doublings and one add a
    window).  The scalar bits are those of a canonical value below the
    group order, so every partial acc = m*P has m below the order and
    2^w m + d never wraps: acc and T[digit] are never equal or negatives
    unless one is infinity, which `sw_add_unsafe` takes.  The last add
    still goes through `sw_add_complete`."""
    nbits = nbits or scalars.spec.p.bit_length()
    w = 4
    digits = scalar_digits(scalars, nbits, w)
    table = window_table(points, w)                             # [2^w, *pshape]
    shape = tuple(torch.broadcast_shapes(tuple(points.shape), tuple(scalars.shape)))
    acc = None
    for j in range(digits.shape[-1] - 1, -1, -1):
        term = _gather_points(table, digits[..., j].expand(shape), shape)
        if acc is None:
            acc = term
            continue
        for _ in range(w):
            acc = sw_double(acc)
        acc = sw_add_unsafe(acc, term) if j else sw_add_complete(acc, term)
    return acc


def sw_fixed_base_mul(window_bases: SWPoint, scalars: FpArray, w: int) -> SWPoint:
    """A fixed-base comb: out_i = scalars_i * G for scalars [k], from the
    window bases B_j = 2^(w j) G, [ceil(nbits / w)] with nbits the scalar
    field's.  Each product is the sum over the windows of d_j * B_j, read
    from one table of every window (`window_table`): ceil(nbits / w) - 1
    adds on the batch, where a ladder takes nbits doublings as well.  The
    partial sum m*G and the next term t*G have m < 2^(w j) <= t or one is
    infinity, and m + t is at most the canonical scalar, below the order,
    so the adds never meet equal or opposite points."""
    nbits = scalars.spec.p.bit_length()
    digits = scalar_digits(scalars, nbits, w)                   # [k, ndig]
    assert digits.shape[-1] == window_bases.shape[0], (digits.shape, window_bases.shape)
    table = window_table(window_bases, w)                       # [2^w, ndig]
    shape = tuple(scalars.shape)
    acc = None
    for j in range(digits.shape[-1]):
        term = _gather_points(table[:, j], digits[..., j], shape)
        acc = term if acc is None else sw_add_unsafe(acc, term)
    return acc


def _stack_points(points) -> SWPoint:
    """Stack same-shaped point batches along a new leading axis."""
    def coord(name):
        fs = [getattr(p, name) for p in points]
        return type(fs[0]).stack(fs, axis=0)
    return SWPoint(coord("x"), coord("y"), coord("z"),
                   torch.stack([p.inf for p in points], dim=0))


def _gather_points(table: SWPoint, idx, shape) -> SWPoint:
    """table [k, *pshape] -> the entries idx [*shape] picks (pshape
    broadcasting against shape)."""
    pad = len(shape) - (len(table.shape) - 1)

    def pick(leaf, limbs):
        tail = tuple(leaf.shape[-1:]) if limbs else ()
        core = tuple(leaf.shape[1:len(leaf.shape) - len(tail)])
        src = leaf.reshape((leaf.shape[0],) + (1,) * pad + core + tail)
        src = src.expand((leaf.shape[0],) + tuple(shape) + tail)
        ix = idx.reshape((1,) + tuple(shape) + (1,) * len(tail)).expand((1,) + tuple(shape) + tail)
        return torch.gather(src, 0, ix)[0]
    return table.map(lambda leaf: pick(leaf, True), lambda leaf: pick(leaf, False))


def sw_tree_reduce(points: SWPoint) -> SWPoint:
    """Sum a batch of points along axis 0 with complete additions (K2/K3
    on the card): padded with infinities to a power of two, then halved
    level by level."""
    n = points.shape[0]
    pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
    if pow2 != n:
        pad = SWPoint.infinity_like(_bcast_sw(points[0:1], (pow2 - n,) + points.shape[1:]))
        points = SWPoint.concat([points.tighten(), pad], axis=0)
    while points.shape[0] > 1:
        half = points.shape[0] // 2
        points = sw_add_complete(points[:half], points[half:])
    return points[0]


# ---------------------------------------------------------------------------
# Twisted Edwards (a = -1): Ed-on-BLS12-377, base field BLS12-377 Fr
# ---------------------------------------------------------------------------


class TEPoint:
    """Extended twisted Edwards coordinates (X:Y:T:Z), T = XY/Z, over FR."""

    __slots__ = ("x", "y", "t", "z")

    def __init__(self, x, y, t, z):
        self.x = x
        self.y = y
        self.t = t
        self.z = z

    @property
    def shape(self):
        return self.x.shape

    @property
    def device(self):
        return self.x.device

    def coords(self):
        return (self.x, self.y, self.t, self.z)

    def map(self, fn) -> "TEPoint":
        """Apply ``fn`` (FpArray -> FpArray) to every coordinate."""
        return TEPoint(*(fn(c) for c in self.coords()))

    def __getitem__(self, idx):
        return self.map(lambda c: c[idx])

    def reshape(self, *shape):
        return self.map(lambda c: c.reshape(*shape))

    @classmethod
    def neutral(cls, shape=(), device="cuda"):
        zero, one = FpArray.zeros(FR, shape, device), FpArray.ones(FR, shape, device)
        return cls(zero, one, zero, one)

    @classmethod
    def from_affine_ints(cls, xy_list, device="cuda"):
        """[(x, y), ...] -> a batch of points with Z = 1."""
        xs = np.asarray([t[0] for t in xy_list], dtype=object)
        ys = np.asarray([t[1] for t in xy_list], dtype=object)
        ts = np.asarray([t[0] * t[1] % FR.p for t in xy_list], dtype=object)
        return cls(FpArray.from_int(FR, xs, device=device),
                   FpArray.from_int(FR, ys, device=device),
                   FpArray.from_int(FR, ts, device=device),
                   FpArray.ones(FR, (len(xy_list),), device))

    def to_affine_ints(self):
        """Host-side: canonical affine coordinates [(x, y), ...]."""
        zinv = self.z.inv()
        ax = (self.x * zinv).to_ints()
        ay = (self.y * zinv).to_ints()
        return [(int(x), int(y)) for x, y in zip(ax.reshape(-1), ay.reshape(-1))]

    def tighten(self):
        return self.map(FpArray.tighten)

    @staticmethod
    def select(cond, a: "TEPoint", b: "TEPoint"):
        return TEPoint(*(FpArray.select(cond, ca, cb)
                         for ca, cb in zip(a.coords(), b.coords())))

    @staticmethod
    def concat(points, axis=0):
        """Concatenate along batch axis ``axis`` (negative counts from the
        last batch axis)."""
        caxis = axis - 1 if axis < 0 else axis
        return TEPoint(*(FpArray.concat(list(cs), caxis)
                         for cs in zip(*(p.coords() for p in points))))


def _te_two_d(device) -> FpArray:
    """2d in Montgomery form (bound 1)."""
    return FpArray.from_int(FR, 2 * params.ED_D, device=device)


def te_add(p: TEPoint, q: TEPoint) -> TEPoint:
    """Unified complete addition, add-2008-hwcd-3 (a = -1)."""
    a = (p.y - p.x) * (q.y - q.x)
    b = (p.y + p.x) * (q.y + q.x)
    c = p.t * q.t * _te_two_d(p.device)
    d = (p.z * q.z).double()
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return TEPoint((e * f).tighten(), (g * h).tighten(), (e * h).tighten(),
                   (f * g).tighten())


def te_double(p: TEPoint) -> TEPoint:
    return te_add(p, p)


def te_neg(p: TEPoint) -> TEPoint:
    return TEPoint(-p.x, p.y, -p.t, p.z)


def _te_bound2(p: TEPoint) -> TEPoint:
    return p.map(_coord_bound2)


def te_scalar_mul(points: TEPoint, scalars: FpArray, nbits: int | None = None) -> TEPoint:
    """Batched complete double-and-add, least significant bit first: for
    each bit, acc + base is taken where the bit is set and base doubles.
    Both additions of a bit run as one `te_add` over acc||base and
    base||base (one K1 launch a product for both), each lane as the
    reference's scanned form computes it.  The points broadcast against
    the scalars' batch shape."""
    nbits = nbits or EDFR.p.bit_length()
    shape = tuple(torch.broadcast_shapes(tuple(points.shape), tuple(scalars.shape)))
    flat = shape or (1,)
    bits = scalar_bits(scalars, nbits).expand(shape + (nbits,)).reshape(flat + (nbits,))
    acc = _te_bound2(TEPoint.neutral(flat, points.device))
    base = _te_bound2(points.tighten().map(lambda c: c.broadcast_to(shape).reshape(flat)))
    n = flat[0]
    for i in range(nbits):
        both = te_add(TEPoint.concat([acc, base]), TEPoint.concat([base, base]))
        acc = TEPoint.select(bits[..., i] > 0, both[:n], acc)
        base = both[n:]
    return acc if shape else acc[0]


def te_tree_reduce(points: TEPoint) -> TEPoint:
    """Sum a batch of points along axis 0: padded with the neutral point to
    a power of two, then halved level by level."""
    n = points.shape[0]
    pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
    if pow2 != n:
        pad = TEPoint.neutral((pow2 - n,) + points.shape[1:], points.device)
        points = TEPoint.concat([points, pad], axis=0)
    while points.shape[0] > 1:
        half = points.shape[0] // 2
        points = te_add(points[:half], points[half:])
    return points[0]
