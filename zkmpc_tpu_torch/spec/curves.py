"""Pure-Python elliptic curve arithmetic (specification/oracle backend).

The port's copy of ``zkmpc_tpu/spec/curves.py``: affine a = 0 curves over
Fq and Fq2 for BLS12-377 G1/G2, and the twisted Edwards curve
ed-on-bls12-377 over Fr.  Short-Weierstrass points at infinity are
``None``.  Fq2 elements are ``(c0, c1)`` tuples meaning c0 + c1*u with
u^2 = -5.
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


# ------------------------------------------------------- twisted Edwards

EP = params.FR_MODULUS  # TE base field = BLS12-377 Fr
ED_A = params.ED_A
ED_D = params.ED_D

TE_NEUTRAL = (0, 1)


def te_add(p1, p2):
    """Complete twisted Edwards addition (a = -1, d = 3021)."""
    x1, y1 = p1
    x2, y2 = p2
    x1x2, y1y2 = x1 * x2 % EP, y1 * y2 % EP
    dxy = ED_D * x1x2 % EP * y1y2 % EP
    x3 = (x1 * y2 + y1 * x2) * inv(1 + dxy, EP) % EP
    y3 = (y1y2 - ED_A * x1x2) * inv(1 - dxy, EP) % EP
    return (x3, y3)


def te_neg(p1):
    return ((-p1[0]) % EP, p1[1])


def _te_add_ext(p1, p2):
    """Unified addition in extended coordinates (X:Y:T:Z), x = X/Z, y = Y/Z,
    T = XY/Z (add-2008-hwcd): no inversion."""
    X1, Y1, T1, Z1 = p1
    X2, Y2, T2, Z2 = p2
    A, B = X1 * X2 % EP, Y1 * Y2 % EP
    C, D = ED_D * T1 % EP * T2 % EP, Z1 * Z2 % EP
    E = ((X1 + Y1) * (X2 + Y2) - A - B) % EP
    F, G, H = (D - C) % EP, (D + C) % EP, (B - ED_A * A) % EP
    return (E * F % EP, G * H % EP, E * H % EP, F * G % EP)


def te_scalar_mul(pt, k: int):
    """k * pt by double-and-add in extended coordinates and one inversion
    at the end: the affine point of the affine double-and-add, without its
    two inversions an addition."""
    k %= params.ED_FR_MODULUS
    x, y = int(pt[0]) % EP, int(pt[1]) % EP
    acc, base = (0, 1, 0, 1), (x, y, x * y % EP, 1)
    while k:
        if k & 1:
            acc = _te_add_ext(acc, base)
        base = _te_add_ext(base, base)
        k >>= 1
    zi = inv(acc[3], EP)
    return (acc[0] * zi % EP, acc[1] * zi % EP)


TE_GEN = (params.ED_GENERATOR_X, params.ED_GENERATOR_Y)


def te_is_on_curve(pt):
    x, y = pt
    return (ED_A * x * x + y * y - 1 - ED_D * x * x % EP * y % EP * y) % EP == 0
