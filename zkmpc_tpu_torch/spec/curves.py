"""Pure-Python elliptic curve arithmetic (specification/oracle backend).

The port's copy of the short-Weierstrass half of
``zkmpc_tpu/spec/curves.py``: affine a = 0 curves over Fq and Fq2 for
BLS12-377 G1/G2.  Points at infinity are ``None``.  Fq2 elements are
``(c0, c1)`` tuples meaning c0 + c1*u with u^2 = -5.
"""

from __future__ import annotations

from .. import params
from .field import inv

P = params.FQ_MODULUS
R = params.FR_MODULUS

# ---------------------------------------------------------------- Fq2 tower

NR = params.FQ2_NONRESIDUE


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_mul(a, b):
    v0 = a[0] * b[0] % P
    v1 = a[1] * b[1] % P
    c0 = (v0 + NR * v1) % P
    c1 = ((a[0] + a[1]) * (b[0] + b[1]) - v0 - v1) % P
    return (c0, c1)


def fq2_smul(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_inv(a):
    # (c0 - c1 u)/(c0^2 - NR*c1^2)
    norm = (a[0] * a[0] - NR * a[1] * a[1]) % P
    ninv = inv(norm, P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


class _FqOps:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def smul(a, k):
        return a * k % P

    @staticmethod
    def neg(a):
        return (-a) % P

    @staticmethod
    def inv(a):
        return inv(a, P)

    @staticmethod
    def is_zero(a):
        return a % P == 0


class _Fq2Ops:
    zero, one = FQ2_ZERO, FQ2_ONE
    add = staticmethod(fq2_add)
    sub = staticmethod(fq2_sub)
    mul = staticmethod(fq2_mul)
    smul = staticmethod(fq2_smul)
    neg = staticmethod(fq2_neg)
    inv = staticmethod(fq2_inv)

    @staticmethod
    def is_zero(a):
        return a[0] % P == 0 and a[1] % P == 0


# --------------------------------------------------- short Weierstrass, a=0


def sw_add(pt1, pt2, F):
    """Affine addition on y^2 = x^3 + b (any b; a=0). None = infinity."""
    if pt1 is None:
        return pt2
    if pt2 is None:
        return pt1
    x1, y1 = pt1
    x2, y2 = pt2
    if F.is_zero(F.sub(x1, x2)):
        if F.is_zero(F.add(y1, y2)):
            return None
        # doubling: lambda = 3 x^2 / 2 y
        lam = F.mul(F.smul(F.mul(x1, x1), 3), F.inv(F.smul(y1, 2)))
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def sw_neg(pt, F):
    if pt is None:
        return None
    return (pt[0], F.neg(pt[1]))


def sw_scalar_mul(pt, k: int, F):
    k %= R
    acc, base = None, pt
    while k:
        if k & 1:
            acc = sw_add(acc, base, F)
        base = sw_add(base, base, F)
        k >>= 1
    return acc


def g1_add(p1, p2):
    return sw_add(p1, p2, _FqOps)


def g1_mul(pt, k):
    return sw_scalar_mul(pt, k, _FqOps)


def g1_neg(pt):
    return sw_neg(pt, _FqOps)


def g2_add(p1, p2):
    return sw_add(p1, p2, _Fq2Ops)


def g2_mul(pt, k):
    return sw_scalar_mul(pt, k, _Fq2Ops)


def g2_neg(pt):
    return sw_neg(pt, _Fq2Ops)


G1_GEN = (params.G1_GENERATOR_X, params.G1_GENERATOR_Y)
G2_GEN = (
    (params.G2_GENERATOR_X_C0, params.G2_GENERATOR_X_C1),
    (params.G2_GENERATOR_Y_C0, params.G2_GENERATOR_Y_C1),
)
