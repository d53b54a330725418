"""In-circuit short-Weierstrass curve gadget.

Port of ``zkmpc_tpu/circuits/sw_gadget.py`` (the reference's
`mpc-algebra/src/r1cs_helper/groups/curves/short_weierstrass/
{mod,non_zero_affine}.rs`): ark-style `NonZeroAffineVar` lambda-formula
arithmetic over circuit wires, for any short-Weierstrass curve
y^2 = x^3 + a x + b whose base field is the circuit field, with shared
witness allocation like the TE gadget (`circuits/pedersen_gadget.py`).

The formulas are incomplete, as ark's are: callers keep points nonzero and
distinct-or-equal as each formula requires; the scalar ladder uses ark's
offset trick (accumulate from a public offset point, subtract it at the
end), so the accumulator never passes through infinity.
"""

from __future__ import annotations

from ..snark.gadgets import Boolean, FpVar
from ..snark.r1cs import ConstraintSystem
from .pedersen_gadget import _inv_wire


class SWCurveParams:
    """y^2 = x^3 + a x + b over the circuit field (coefficients as ints)."""

    __slots__ = ("a", "b", "p")

    def __init__(self, a: int, b: int, p: int):
        self.a = a % p
        self.b = b % p
        self.p = p

    def is_on_curve(self, xy) -> bool:
        x, y = int(xy[0]) % self.p, int(xy[1]) % self.p
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    # -- plain affine operations on host ints, for offsets and tests --
    def add(self, P1, P2):
        p = self.p
        x1, y1 = int(P1[0]) % p, int(P1[1]) % p
        x2, y2 = int(P2[0]) % p, int(P2[1]) % p
        if (x1, y1) == (x2, y2):
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    def neg(self, P1):
        return (int(P1[0]) % self.p, (-int(P1[1])) % self.p)

    def mul(self, P1, k: int):
        acc = None
        cur = P1
        while k:
            if k & 1:
                acc = cur if acc is None else self.add(acc, cur)
            cur = self.add(cur, cur)
            k >>= 1
        return acc


class SWNonZeroAffineVar:
    """A nonzero SW affine point as circuit wires (ark `NonZeroAffineVar`)."""

    __slots__ = ("x", "y", "params")

    def __init__(self, x: FpVar, y: FpVar, params: SWCurveParams):
        self.x = x
        self.y = y
        self.params = params

    @classmethod
    def constant(cls, cs: ConstraintSystem, xy, params: SWCurveParams):
        return cls(FpVar.constant(cs, int(xy[0])), FpVar.constant(cs, int(xy[1])), params)

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, x_val, y_val, params: SWCurveParams):
        """Allocate a (possibly shared) point and enforce the curve equation
        y^2 = x^3 + a x + b (ark's on-curve check of witness points)."""
        x = FpVar.new_witness(cs, x_val)
        y = FpVar.new_witness(cs, y_val)
        x3 = (x * x) * x
        rhs = x3 + x.scale(params.a) + FpVar.constant(cs, 1).scale(params.b)
        y.mul_equals(y, rhs)
        return cls(x, y, params)

    def negate(self) -> "SWNonZeroAffineVar":
        return SWNonZeroAffineVar(self.x, -self.y, self.params)

    def _from_lambda(self, lam_num: FpVar, lam_den: FpVar, x2: FpVar) -> "SWNonZeroAffineVar":
        """The point of slope lam = num / den through self and x2:
        lam den = num; x3 = lam^2 - x1 - x2; lam (x1 - x3) = y3 + y1."""
        cs = self.x.cs
        x1, y1 = self.x, self.y
        lam = FpVar.new_witness(cs, lam_num.value * _inv_wire(lam_den))
        cs.enforce(lam.lc, lam_den.lc, lam_num.lc)
        x3 = lam * lam - x1 - x2
        y3 = FpVar.new_witness(cs, lam.value * (x1.value - x3.value) - y1.value)
        cs.enforce(lam.lc, x1.lc - x3.lc, y3.lc + y1.lc)
        return SWNonZeroAffineVar(x3, y3, self.params)

    def add_unchecked(self, other: "SWNonZeroAffineVar") -> "SWNonZeroAffineVar":
        """Chord addition (x1 != x2 required; `non_zero_affine.rs`
        add_unchecked)."""
        return self._from_lambda(other.y - self.y, other.x - self.x, other.x)

    def double(self) -> "SWNonZeroAffineVar":
        """Tangent doubling (y != 0 required): lam 2y = 3 x^2 + a."""
        cs = self.x.cs
        num = (self.x * self.x).scale(3) + FpVar.constant(cs, 1).scale(self.params.a)
        return self._from_lambda(num, self.y.scale(2), self.x)

    def double_and_add(self, other: "SWNonZeroAffineVar") -> "SWNonZeroAffineVar":
        """2*self + other as (self + other) + self (ark's `double_and_add`)."""
        return self.add_unchecked(other).add_unchecked(self)

    @staticmethod
    def conditionally_select(bit: Boolean, a: "SWNonZeroAffineVar",
                             b: "SWNonZeroAffineVar") -> "SWNonZeroAffineVar":
        return SWNonZeroAffineVar(FpVar.conditionally_select(bit, a.x, b.x),
                                  FpVar.conditionally_select(bit, a.y, b.y), a.params)

    def enforce_equal(self, other: "SWNonZeroAffineVar"):
        self.x.enforce_equal(other.x)
        self.y.enforce_equal(other.y)

    def scalar_mul_le(self, bits: list, offset_xy) -> "SWNonZeroAffineVar":
        """self * sum(bits_i 2^i) by double-and-add over Boolean bits (LSB
        first) with ark's offset trick: the accumulator starts at the public
        ``offset_xy`` point and the offset is subtracted at the end.  The
        caller keeps the scalar nonzero and the offset generic (no
        x-collision with an intermediate point), as a random offset is with
        overwhelming probability."""
        cs = self.x.cs
        acc = SWNonZeroAffineVar.constant(cs, offset_xy, self.params)
        cur = self
        for i, bit in enumerate(bits):
            acc = SWNonZeroAffineVar.conditionally_select(bit, acc.add_unchecked(cur), acc)
            if i + 1 < len(bits):
                cur = cur.double()
        return acc.add_unchecked(
            SWNonZeroAffineVar.constant(cs, self.params.neg(offset_xy), self.params))
