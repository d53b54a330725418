"""UInt8 R1CS gadget: a constrained byte, eight Boolean wires (LSB first).

Port of ``zkmpc_tpu/snark/uint8_gadget.py`` (the reference's `MpcUInt8`,
`mpc-algebra/src/r1cs_helper/mpc_uint8.rs`): allocation bit-decomposes the
MPC byte values inside the witness (one batched protocol for a whole byte
vector), the bitwise ops lower to the Boolean gadget algebra with the
eight products of a byte in one batched Beaver round, and `to_fp` is the
linear recomposition.  The semantics are ark r1cs-std's `UInt8`
(new_witness, constant, from_bits_le, to_bits_le, xor, and, or, not,
is_eq, alloc_vec).
"""

from __future__ import annotations

from ..mpc import bits as B
from ..mpc.share import MpcFp
from .gadgets import Boolean, FpVar, mul_many
from .r1cs import LC, ConstraintSystem


class UInt8:
    """A byte in the circuit: 8 Booleans, LSB first."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        assert len(bits) == 8
        self.bits = list(bits)

    @property
    def cs(self) -> ConstraintSystem:
        return self.bits[0].var.cs

    # ------------------------------------------------------------ allocation

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, value: MpcFp, generator) -> "UInt8":
        """A byte from a shared field value in [0, 256): the MPC bit
        decomposition, 8 boolean constraints and the recomposition over 8
        bits, which restricts the range (`mpc_uint8.rs` new_witness)."""
        return cls.new_witness_vec(cs, _as_vec(value), generator)[0]

    @classmethod
    def new_witness_vec(cls, cs: ConstraintSystem, values: MpcFp, generator) -> list:
        """n bytes from a [n] field tensor with one batched bit
        decomposition (the reference runs one protocol a byte)."""
        bits_val = B.bit_decomposition(values, generator)        # [n, full]
        (n,) = values.shape
        out = []
        for i in range(n):
            bools = Boolean.new_witness_vec(cs, B._slice_last(bits_val[i], 0, 8))
            # the recomposition over 8 bits forces the value below 256
            lc = LC({})
            for j, bv in enumerate(bools):
                lc = lc + bv.var.lc.scale(1 << j)
            v = FpVar.new_witness(cs, values[i])
            cs.enforce(lc, LC.constant(1), v.lc)
            out.append(cls(bools))
        return out

    @classmethod
    def constant(cls, cs: ConstraintSystem, v: int) -> "UInt8":
        assert 0 <= v < 256
        return cls([Boolean.constant(cs, bool((v >> i) & 1)) for i in range(8)])

    @classmethod
    def from_bits_le(cls, bits) -> "UInt8":
        return cls(bits)

    def to_bits_le(self) -> list:
        return list(self.bits)

    # ------------------------------------------------------------- bit algebra

    def xor(self, other: "UInt8") -> "UInt8":
        return self._zip(other, Boolean.xor)

    def and_(self, other: "UInt8") -> "UInt8":
        return self._zip(other, Boolean.and_)

    def or_(self, other: "UInt8") -> "UInt8":
        return self._zip(other, Boolean.or_)

    def not_(self) -> "UInt8":
        return UInt8([b.not_() for b in self.bits])

    def _zip(self, other: "UInt8", op) -> "UInt8":
        # the products of all 8 bit pairs in one batched Beaver round
        prods = mul_many(list(zip([b.var for b in self.bits], [b.var for b in other.bits])))
        out = []
        for a, b, ab in zip(self.bits, other.bits, prods):
            if op is Boolean.and_:
                out.append(Boolean(ab))
            elif op is Boolean.or_:
                out.append(Boolean(a.var + b.var - ab))
            else:                                               # xor
                out.append(Boolean(a.var + b.var - ab.scale(2)))
        return UInt8(out)

    def rotr(self, k: int) -> "UInt8":
        """Rotate right by k (free: a relabelling of the bits)."""
        k %= 8
        return UInt8([self.bits[(i + k) % 8] for i in range(8)])

    def shl(self, k: int, cs=None) -> "UInt8":
        """Logical shift left by k, the high bits dropped."""
        zero = Boolean.constant(cs or self.cs, False)
        return UInt8([zero] * k + self.bits[:8 - k])

    # -------------------------------------------------------------- conversion

    def to_fp(self) -> FpVar:
        """The linear recomposition sum 2^i b_i as an FpVar (no constraint)."""
        lc = LC({})
        val = None
        for i, b in enumerate(self.bits):
            lc = lc + b.var.lc.scale(1 << i)
            term = b.var.value * MpcFp.const(self.cs.spec, 1 << i)
            val = term if val is None else val + term
        return FpVar(self.cs, lc, val)

    # -------------------------------------------------------------- predicates

    def is_eq(self, other: "UInt8", generator) -> Boolean:
        return self.to_fp().is_eq(other.to_fp(), generator)

    def enforce_equal(self, other: "UInt8"):
        self.to_fp().enforce_equal(other.to_fp())


def _as_vec(value: MpcFp) -> MpcFp:
    return value.reshape(1) if value.shape == () else value
