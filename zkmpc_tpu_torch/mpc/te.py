"""Twisted-Edwards points with secret-shared coordinates.

Port of ``zkmpc_tpu/mpc/te.py``.  ed-on-bls12-377 lives over Fr, the same
field that is secret-shared, so complete extended TE addition is MPC field
arithmetic (Beaver products on coordinate shares):

- ``select_base(bit, P)``: bit * P for a shared {0,1} bit and a public
  point is local (affine in the bit).
- ``add``: one batched round of Beaver products (HWCD08 a = -1 complete
  formulas).
- ``scalar_mul_bits``: sum_j bits_j * (2^j * base) via select and a
  log-depth tree.
"""

from __future__ import annotations

import numpy as np

from .. import params
from ..ops.limbs import FR, FpArray
from ..spec import curves as SC
from . import bits as B
from .share import MpcFp

_2D = params.ED_D * 2 % params.FR_MODULUS


class MpcTEPoint:
    """Batch of TE points in extended coordinates with MpcFp coordinates."""

    __slots__ = ("x", "y", "t", "z")

    def __init__(self, x: MpcFp, y: MpcFp, t: MpcFp, z: MpcFp):
        self.x = x
        self.y = y
        self.t = t
        self.z = z

    @property
    def shape(self):
        return self.x.shape

    @classmethod
    def neutral(cls, shape=()):
        zero = _bcast(MpcFp.const(FR, 0), shape)
        one = _bcast(MpcFp.const(FR, 1), shape)
        return cls(zero, one, zero, one)

    @classmethod
    def from_public_affine(cls, xy_list):
        xs = [int(t[0]) for t in xy_list]
        ys = [int(t[1]) for t in xy_list]
        return cls(MpcFp.const(FR, xs), MpcFp.const(FR, ys),
                   MpcFp.const(FR, [x * y % FR.p for x, y in zip(xs, ys)]),
                   MpcFp.const(FR, [1] * len(xs)))

    def add(self, other: "MpcTEPoint") -> "MpcTEPoint":
        """Complete unified addition; 8 Beaver products in 4 rounds."""
        a = (self.y - self.x) * (other.y - other.x)
        b = (self.y + self.x) * (other.y + other.x)
        c = self.t * other.t * MpcFp.const(FR, _2D)
        d = (self.z * other.z).double()
        e = b - a
        f = d - c
        g = d + c
        h = b + a
        return MpcTEPoint(e * f, g * h, e * h, f * g)

    def neg(self):
        return MpcTEPoint(-self.x, self.y, -self.t, self.z)

    def reveal_affine_ints(self):
        """Open and normalize to affine ints; one entry per batch element
        (the first row's replicated copy: party 0's on the stacked
        transport, the party's own on a socket)."""
        zi = self.z.reveal().inv()
        ax = np.asarray((self.x.reveal() * zi).to_ints()[0]).reshape(-1)
        ay = np.asarray((self.y.reveal() * zi).to_ints()[0]).reshape(-1)
        return [(int(a), int(b)) for a, b in zip(ax, ay)]


def _bcast(w: MpcFp, shape):
    if not shape:
        return w

    def f(fp: FpArray) -> FpArray:
        limbs = fp.limbs
        src = limbs.reshape(tuple(limbs.shape[:-1]) + (1,) * len(shape) + (limbs.shape[-1],))
        tgt = tuple(limbs.shape[:-1]) + tuple(shape) + (limbs.shape[-1],)
        return FpArray(src.expand(tgt), fp.spec, fp.bound)
    return w.map(f)


def select_base(bit: MpcFp, base_xy) -> MpcTEPoint:
    """bit * P for a shared bit and public affine point(s): affine in the bit.

    base_xy: an (x, y) int pair, or arrays matching bit's batch shape.
    Coordinates: (bit*x, 1 + bit*(y-1), bit*t, 1).
    """
    p = FR.p
    bx = np.asarray(base_xy[0], dtype=object)
    by = np.asarray(base_xy[1], dtype=object)
    bt = np.vectorize(lambda a, b: int(a) * int(b) % p, otypes=[object])(bx, by)
    gym1 = np.vectorize(lambda v: (int(v) - 1) % p, otypes=[object])(by)
    one = MpcFp.const(FR, 1)
    return MpcTEPoint(bit * MpcFp.const(FR, bx), bit * MpcFp.const(FR, gym1) + one,
                      bit * MpcFp.const(FR, bt), _bcast(one, bit.shape))


def tree_sum(points: MpcTEPoint) -> MpcTEPoint:
    """Sum over the last batch axis with log-depth complete adds."""
    p = points
    while p.shape[-1] > 1:
        n = p.shape[-1]
        half = n // 2
        s = _slice(p, 0, half).add(_slice(p, half, 2 * half))
        if n % 2:
            s = _concat(s, _slice(p, 2 * half, n))
        p = s
    return _index(p, 0)


def _apply(pt: MpcTEPoint, f) -> MpcTEPoint:
    return MpcTEPoint(f(pt.x), f(pt.y), f(pt.t), f(pt.z))


def _slice(pt, a, b):
    return _apply(pt, lambda w: B._slice_last(w, a, b))


def _concat(p1, p2):
    return MpcTEPoint(B._concat_last(p1.x, p2.x), B._concat_last(p1.y, p2.y),
                      B._concat_last(p1.t, p2.t), B._concat_last(p1.z, p2.z))


def _index(pt, i):
    return _apply(pt, lambda w: B._index_last(w, i))


def scalar_mul_bits(base_xy, bits: MpcFp) -> MpcTEPoint:
    """sum_j bits_j * (2^j * base) for shared bits [.., nbits], public base."""
    pows = []
    cur = base_xy
    for _ in range(bits.shape[-1]):
        pows.append(cur)
        cur = SC.te_add(cur, cur)
    xs = np.asarray([t[0] for t in pows], dtype=object)
    ys = np.asarray([t[1] for t in pows], dtype=object)
    return tree_sum(select_base(bits, (xs, ys)))
