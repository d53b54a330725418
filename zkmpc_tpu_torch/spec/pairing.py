"""BLS12-377 pairing (specification backend, pure Python ints).

Used for proof *verification* only — the reference likewise never computes
pairings on shares (`wire/pairing.rs:119-143` is `todo!()`; proofs are
revealed first and verified with the vanilla engine), so this cold path stays
host-side.

Tower (matching `arkworks/curves/bls12_377/src/fields/`):
  Fq2  = Fq [u] / (u^2 + 5)          (nonresidue -5)
  Fq6  = Fq2[v] / (v^3 - u)
  Fq12 = Fq6[w] / (w^2 - v)
G2 is on the D-twist y^2 = x^3 + b/u; untwist (x,y) -> (x w^2, y w^3).
Ate pairing: Miller loop over the BLS parameter x = 0x8508c00000000001,
then final exponentiation (q^12 - 1)/r by plain square-and-multiply.
"""

from __future__ import annotations

from .. import params

Q = params.FQ_MODULUS
R = params.FR_MODULUS
BLS_X = params.BLS_X


# ---------------------------------------------------------------- Fq2 -------

def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    v0 = a[0] * b[0] % Q
    v1 = a[1] * b[1] % Q
    return ((v0 - 5 * v1) % Q, ((a[0] + a[1]) * (b[0] + b[1]) - v0 - v1) % Q)


def f2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def f2_inv(a):
    norm = (a[0] * a[0] + 5 * a[1] * a[1]) % Q
    ni = pow(norm, -1, Q)
    return (a[0] * ni % Q, (-a[1]) * ni % Q)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def f2_mul_by_u(a):
    # u * (a0 + a1 u) = -5 a1 + a0 u
    return ((-5 * a[1]) % Q, a[0])


# ---------------------------------------------------------------- Fq6 -------
# element: (c0, c1, c2) of Fq2, meaning c0 + c1 v + c2 v^2, v^3 = u


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    v0 = f2_mul(a0, b0)
    v1 = f2_mul(a1, b1)
    v2 = f2_mul(a2, b2)
    c0 = f2_add(v0, f2_mul_by_u(
        f2_sub(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), v1), v2)))
    c1 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), v0), v1),
                f2_mul_by_u(v2))
    c2 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), v0), v2), v1)
    return (c0, c1, c2)


def f6_mul_by_v(a):
    return (f2_mul_by_u(a[2]), a[0], a[1])


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_mul(a0, a0), f2_mul_by_u(f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul_by_u(f2_mul(a2, a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    d = f2_add(f2_mul(a0, t0),
               f2_mul_by_u(f2_add(f2_mul(a2, t1), f2_mul(a1, t2))))
    di = f2_inv(d)
    return (f2_mul(t0, di), f2_mul(t1, di), f2_mul(t2, di))


# ---------------------------------------------------------------- Fq12 ------
# element: (c0, c1) of Fq6, meaning c0 + c1 w, w^2 = v


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


def f12_mul(a, b):
    v0 = f6_mul(a[0], b[0])
    v1 = f6_mul(a[1], b[1])
    c0 = f6_add(v0, f6_mul_by_v(v1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), v0), v1)
    return (c0, c1)


def f12_square(a):
    return f12_mul(a, a)


def f12_inv(a):
    d = f6_sub(f6_mul(a[0], a[0]), f6_mul_by_v(f6_mul(a[1], a[1])))
    di = f6_inv(d)
    return (f6_mul(a[0], di), f6_neg(f6_mul(a[1], di)))


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_pow(a, e: int):
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_square(base)
        e >>= 1
    return result


def f12_from_fq(x: int):
    return (((x % Q, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def f12_is_one(a):
    return a == F12_ONE


# --------------------------------------------------- curve over Fq12 --------


def _e12_add(p1, p2):
    """Affine chord-tangent addition on y^2 = x^3 + b over Fq12."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f12_add(y1, y2) == F12_ZERO:
            return None
        num = f12_mul(f12_from_fq(3), f12_square(x1))
        den = f12_mul(f12_from_fq(2), y1)
    else:
        num = f12_sub(y2, y1)
        den = f12_sub(x2, x1)
    lam = f12_mul(num, f12_inv(den))
    x3 = f12_sub(f12_sub(f12_square(lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    return (x3, y3)


def _line(t, q2, p):
    """Evaluate the line through T and Q (or tangent at T if equal) at P."""
    xt, yt = t
    xq, yq = q2
    xp, yp = p
    if xt == xq and yt == yq:
        num = f12_mul(f12_from_fq(3), f12_square(xt))
        den = f12_mul(f12_from_fq(2), yt)
    elif xt == xq:
        # vertical line
        return f12_sub(xp, xt)
    else:
        num = f12_sub(yq, yt)
        den = f12_sub(xq, xt)
    lam = f12_mul(num, f12_inv(den))
    return f12_sub(f12_sub(yp, yt), f12_mul(lam, f12_sub(xp, xt)))


def untwist(q2pt):
    """G2 point over Fq2 -> point on E(Fq12): (x w^2, y w^3)."""
    (x, y) = q2pt
    xe = ((F2_ZERO, x, F2_ZERO), F6_ZERO)       # x * v  ... lives in c0? no:
    # w^2 = v, so x*w^2 = (x*v, 0) as Fq6 pair:
    x12 = ((F2_ZERO, x, F2_ZERO), F6_ZERO)
    # w^3 = v*w, so y*w^3 = (0, y*v):
    y12 = (F6_ZERO, (F2_ZERO, y, F2_ZERO))
    return (x12, y12)


def g1_to_e12(p):
    return (f12_from_fq(p[0]), f12_from_fq(p[1]))


def miller_loop(p1, q2):
    """Ate Miller loop f_{x,Q}(P) for G1 point p1 (ints) and G2 point q2 (Fq2)."""
    if p1 is None or q2 is None:
        return F12_ONE
    P = g1_to_e12(p1)
    Qp = untwist(q2)
    f = F12_ONE
    T = Qp
    bits = bin(BLS_X)[3:]  # skip MSB
    for b in bits:
        f = f12_mul(f12_square(f), _line(T, T, P))
        T = _e12_add(T, T)
        if b == "1":
            f = f12_mul(f, _line(T, Qp, P))
            T = _e12_add(T, Qp)
    return f


_FINAL_EXP = (Q ** 12 - 1) // R


def final_exponentiation(f):
    return f12_pow(f, _FINAL_EXP)


def pairing(p1, q2):
    """Full pairing e(P, Q); None inputs give the identity."""
    return final_exponentiation(miller_loop(p1, q2))


def product_pairing_is_one(pairs) -> bool:
    """Check prod e(Pi, Qi) == 1 with a single final exponentiation."""
    f = F12_ONE
    for p1, q2 in pairs:
        if p1 is None or q2 is None:
            continue
        f = f12_mul(f, miller_loop(p1, q2))
    return f12_is_one(final_exponentiation(f))
