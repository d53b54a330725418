"""Multiplicative secret sharing: ``MpcMulFp``.

Port of ``zkmpc_tpu/mpc/mul_share.py`` (the reference's ``MulFieldShare``,
`mpc-algebra/src/share/additive.rs:258-347`): the secret is the product of
the parties' factors, so

- ``reveal`` is one all-gather of the factors and a log-depth product;
- ``*``, ``square``, ``inv`` and ``pow_const`` are local (no Beaver
  triples: the point of the representation);
- ``scale`` by a public constant multiplies the leader's factor only
  (`additive.rs:301-306`);
- ``+`` and ``shift`` are not supported, as in the reference
  (`additive.rs:296-299,308-310`).

The reference uses it for pairing-target values inside
``AdditivePairingShare`` (`additive.rs:567-589`); pairings are never
evaluated on shares, so it is an algebra building block.

Factors keep the party axis of every share tensor, ``transport.rows`` rows
(every party on the stacked transport, the party's own on a socket), so
one code path serves both transports.  ``from_public`` puts the value on
the leader and 1 elsewhere (`additive.rs:270-275`).
"""

from __future__ import annotations

from ..ops.limbs import FieldSpec, FpArray
from ..parallel import transport as T
from .share import PUBLIC, SHARED, _rebroadcast


def _prod_axis0(x: FpArray) -> FpArray:
    """Product over axis 0 by pairwise folds (log depth)."""
    while x.shape and x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        folded = x[:half] * x[half:2 * half]
        if n % 2:
            folded = FpArray.concat([folded, x[2 * half:]], axis=0)
        x = folded
    return x[0]


class MpcMulFp:
    """A multiplicatively shared (or public) field tensor, [rows, batch...]."""

    __slots__ = ("value", "visibility")

    def __init__(self, value: FpArray, visibility: str):
        self.value = value
        self.visibility = visibility

    @property
    def spec(self) -> FieldSpec:
        return self.value.spec

    @property
    def shape(self):
        """Batch shape (the party axis excluded)."""
        return self.value.shape[1:]

    def is_shared(self):
        return self.visibility == SHARED

    def __repr__(self):
        return f"MpcMulFp({self.visibility}, {self.value!r})"

    def _leader_mask(self):
        t = T.current()
        return t.leader_mask(self.value.ndim - 1).expand(self.value.shape)

    # --------------------------------------------------------------- creation

    @classmethod
    def from_public(cls, value: FpArray) -> "MpcMulFp":
        """The leader holds the value, every other party 1, marked shared
        (`additive.rs:270-275`)."""
        pub = cls.public(value)
        ones = FpArray.ones(value.spec, pub.value.shape, pub.value.device)
        return cls(FpArray.select(pub._leader_mask(), pub.value, ones), SHARED)

    @classmethod
    def from_shares(cls, factors: FpArray) -> "MpcMulFp":
        """Wrap the parties' own factors [rows, ...] (`additive.rs:276-278`)."""
        return cls(factors, SHARED)

    @classmethod
    def public(cls, value: FpArray) -> "MpcMulFp":
        """A replicated public wire."""
        t = T.current()
        limbs = value.limbs.to(t.device)
        return cls(FpArray(_rebroadcast(t, limbs), value.spec, value.bound), PUBLIC)

    # --------------------------------------------------------------- openings

    def reveal(self) -> FpArray:
        """Open: the product of every party's factors (`additive.rs:268-295`),
        one all-gather round; replicated [rows, ...]."""
        if self.visibility == PUBLIC:
            return self.value
        t = T.current()
        x = self.value.tighten()
        # every row sees the same P factors: one product, replicated
        gathered = t.all_gather(x.limbs)[0]                 # [P, batch..., n]
        prod = _prod_axis0(FpArray(gathered, self.spec, x.bound))
        return FpArray(_rebroadcast(t, prod.limbs), prod.spec, prod.bound)

    def open(self) -> "MpcMulFp":
        return MpcMulFp(self.reveal(), PUBLIC)

    def unwrap_as_public(self) -> FpArray:
        """The raw local factor (`additive.rs:279-281`)."""
        return self.value

    # ------------------------------------------------------------- arithmetic

    def __mul__(self, other: "MpcMulFp") -> "MpcMulFp":
        """Local multiply: shared by shared needs no communication
        (`additive.rs:312-331`)."""
        assert isinstance(other, MpcMulFp)
        vis = SHARED if (self.is_shared() or other.is_shared()) else PUBLIC
        return MpcMulFp(self.value * other.value, vis)

    def square(self) -> "MpcMulFp":
        return MpcMulFp(self.value.square(), self.visibility)

    def inv(self) -> "MpcMulFp":
        """Local per-factor inverse (`additive.rs:333-338`)."""
        return MpcMulFp(self.value.inv(), self.visibility)

    def pow_const(self, e: int) -> "MpcMulFp":
        return MpcMulFp(self.value.pow_const(e), self.visibility)

    def scale(self, k: FpArray) -> "MpcMulFp":
        """Multiply by a public constant (batch-shaped): the leader's factor
        only (`additive.rs:301-306`)."""
        k = k.to(self.value.device).broadcast_to(self.value.shape)
        scaled = self.value * k
        if self.visibility == PUBLIC:
            return MpcMulFp(scaled, PUBLIC)
        return MpcMulFp(FpArray.select(self._leader_mask(), scaled, self.value), SHARED)

    def __add__(self, other):
        raise NotImplementedError(
            "add on multiplicative shares (reference additive.rs:296-299)")

    __radd__ = __add__

    def shift(self, other):
        raise NotImplementedError(
            "shift on multiplicative shares (reference additive.rs:308-310)")
