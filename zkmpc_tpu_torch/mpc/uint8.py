"""Shared bytes: eight shared bits a value.

Port of ``zkmpc_tpu/mpc/uint8.py`` (the reference's `MpcU8Field`,
`wire/uint8.rs:18-40`).  A batch of bytes is one bit tensor [..., 8],
least significant bit first; xor, and, or and not are the bit ops of
`mpc/bits.py` (and, or and xor one batched Beaver round), and `to_field`
recombines the bits locally.
"""

from __future__ import annotations

import numpy as np

from ..ops.limbs import FR
from . import bits as B
from .share import MpcFp


class MpcU8:
    """A batch of shared bytes as a [..., 8] bit tensor."""

    __slots__ = ("bits",)

    def __init__(self, bits: MpcFp):
        assert bits.shape[-1] == 8
        self.bits = bits

    @classmethod
    def from_public_ints(cls, vals) -> "MpcU8":
        arr = np.asarray(vals, dtype=object)
        out = np.zeros(arr.shape + (8,), dtype=object)
        for i in range(8):
            out[..., i] = (arr >> i) & 1
        return cls(MpcFp.const(FR, out))

    @property
    def shape(self):
        return self.bits.shape[:-1]

    def xor(self, other: "MpcU8") -> "MpcU8":
        return MpcU8(B.b_xor(self.bits, other.bits))

    def and_(self, other: "MpcU8") -> "MpcU8":
        return MpcU8(B.b_and(self.bits, other.bits))

    def or_(self, other: "MpcU8") -> "MpcU8":
        return MpcU8(B.b_or(self.bits, other.bits))

    def not_(self) -> "MpcU8":
        return MpcU8(B.b_not(self.bits))

    def to_field(self) -> MpcFp:
        """The field values sum 2^i b_i (local)."""
        return B._bits_to_field(self.bits)

    def reveal_ints(self) -> list:
        """Open the bytes: a flat list of ints (one opening)."""
        return [int(v) for v in self.to_field().reveal()[0].to_ints().reshape(-1)]


def bytes_to_u8(data: bytes) -> MpcU8:
    return MpcU8.from_public_ints(np.asarray(list(data), dtype=object))
