"""Secret-shared field tensors: the MPC wire layer (semi-honest backend).

Port of the semi-honest half of ``zkmpc_tpu/mpc/share.py``.  A whole tensor
is either public (replicated across parties) or shared (each party holds an
additive share); visibility is static metadata.  Communication goes through
the ambient `parallel.transport` (psum = share opening).  Semantics kept
from the reference: public constants are added by the leader only; a
shared-by-shared product is a batched Beaver multiplication.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from ..ops.limbs import FieldSpec, FpArray, _resolve2
from ..parallel import transport as T
from ..spec import curves as SC
from . import rand as R

PUBLIC = "public"
SHARED = "shared"


class MpcContext:
    """Ambient MPC execution state: transport, backend and triple source."""

    def __init__(self, transport: T.Transport, backend: str = "semi",
                 triple_source=None):
        if backend != "semi":
            raise NotImplementedError("only the semi-honest backend is ported")
        self.transport = transport
        self.backend = backend
        self.triple_source = triple_source or DummyTripleSource()


_CTX: contextvars.ContextVar = contextvars.ContextVar("zkmpc_torch_mpc_ctx",
                                                      default=None)


def ctx() -> MpcContext:
    c = _CTX.get()
    if c is None:
        raise RuntimeError("no MPC context; use `with mpc_scope(ctx):`")
    return c


@contextlib.contextmanager
def mpc_scope(c: MpcContext):
    tok = _CTX.set(c)
    with T.scope(c.transport):
        try:
            yield c
        finally:
            _CTX.reset(tok)


def _sum_last_axis(x: FpArray) -> FpArray:
    """Sum an FpArray over its last batch axis via pairwise folds."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        a = FpArray(x.limbs[..., :half, :], x.spec, x.bound)
        b = FpArray(x.limbs[..., half:2 * half, :], x.spec, x.bound)
        folded = a + b
        if n % 2:
            rest = FpArray(x.limbs[..., 2 * half:, :], x.spec, x.bound)
            folded = FpArray(torch.cat([folded.limbs, rest.limbs], dim=-2),
                             x.spec, max(folded.bound, rest.bound))
        x = folded
    return FpArray(x.limbs[..., 0, :], x.spec, x.bound)


def party_shape(t: T.Transport, batch_shape):
    return (t.n_parties,) + tuple(batch_shape)


class MpcFp:
    """Field tensor with visibility; value layout [P, batch...]."""

    __slots__ = ("value", "visibility")

    def __init__(self, value: FpArray, visibility: str):
        self.value = value
        self.visibility = visibility

    @property
    def spec(self):
        return self.value.spec

    @property
    def shape(self):
        """Batch shape (excluding the stacked party axis)."""
        return self.value.shape[1:]

    def is_shared(self):
        return self.visibility == SHARED

    def __repr__(self):
        return f"MpcFp({self.visibility}, {self.value!r})"

    # --------------------------------------------------------------- creation

    @classmethod
    def from_public(cls, value: FpArray):
        """Replicate a plain FpArray across the parties as a public wire."""
        t = T.current()
        limbs = value.limbs.to(t.device)
        limbs = limbs[None].expand((t.n_parties,) + tuple(limbs.shape))
        return cls(FpArray(limbs, value.spec, value.bound), PUBLIC)

    @classmethod
    def const(cls, spec: FieldSpec, ints):
        return cls.from_public(FpArray.from_int(
            spec, np.asarray(ints, dtype=object), device=T.current().device))

    # --------------------------------------------------------------- openings

    def reveal(self) -> FpArray:
        """Open to a public plain FpArray (party-shaped, replicated)."""
        t = ctx().transport
        if self.visibility == PUBLIC:
            return self.value
        x = self.value.tighten()
        opened = t.psum(x.limbs)
        return FpArray(_resolve2(opened)[..., :x.spec.nlimbs], x.spec,
                       2 * t.n_parties).tighten()

    def open(self) -> "MpcFp":
        return MpcFp(self.reveal(), PUBLIC)

    # ------------------------------------------------------------- arithmetic

    def _leader_mask(self):
        return T.current().party_index(self.value.ndim - 1) == 0

    def _aligned(self, other):
        """Insert singleton batch axes after the party axis so wires of
        different batch rank broadcast (e.g. scalar const + vector share)."""
        ra = self.value.ndim - 1
        rb = other.value.ndim - 1
        rank = max(ra, rb)

        def fix(w: MpcFp, r):
            if r >= rank:
                return w
            shp = w.value.limbs.shape
            new = shp[:1] + (1,) * (rank - r) + shp[1:]
            return MpcFp(FpArray(w.value.limbs.reshape(new), w.spec,
                                 w.value.bound), w.visibility)
        return fix(self, ra), fix(other, rb)

    def __add__(self, other):
        other = _coerce(other, self.spec)
        a, b = self._aligned(other)
        if a.visibility == b.visibility == PUBLIC:
            return MpcFp(a.value + b.value, PUBLIC)
        if a.visibility == PUBLIC:
            a, b = b, a
        if b.visibility == PUBLIC:
            # the leader adds the public constant to its share
            mask = a._leader_mask()
            summed = a.value + b.value
            shifted = FpArray.select(mask.expand(summed.shape), summed, a.value)
            return MpcFp(shifted, SHARED)
        return MpcFp(a.value + b.value, SHARED)

    def __neg__(self):
        return MpcFp(-self.value, self.visibility)

    def __sub__(self, other):
        other = _coerce(other, self.spec)
        return self + (-other)

    def __mul__(self, other):
        other = _coerce(other, self.spec)
        a, b = self._aligned(other)
        if a.visibility == b.visibility == PUBLIC:
            return MpcFp(a.value * b.value, PUBLIC)
        if a.visibility == PUBLIC:
            a, b = b, a
        if b.visibility == PUBLIC:      # scale: local
            return MpcFp(a.value * b.value, SHARED)
        return beaver_mul(a, b)

    def square(self):
        return self * self

    def smul(self, k: int):
        return MpcFp(self.value.smul(k), self.visibility)

    def double(self):
        return self.smul(2)

    # ----------------------------------------------------------------- shape

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return MpcFp(self.value.reshape((self.value.shape[0],) + shape),
                     self.visibility)

    def __getitem__(self, idx):
        """Index into the batch (party axis is preserved)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return MpcFp(self.value[(slice(None),) + idx], self.visibility)

    @staticmethod
    def concat(xs, axis=0):
        vis = SHARED if any(x.is_shared() for x in xs) else PUBLIC
        xs = [x if x.visibility == vis else _promote_to_shared(x) for x in xs]
        return MpcFp(FpArray.concat([x.value for x in xs], axis + 1), vis)


def _coerce(x, spec):
    if isinstance(x, MpcFp):
        return x
    if isinstance(x, FpArray):
        return MpcFp.from_public(x)
    if isinstance(x, int):
        return MpcFp.const(spec, x)
    raise TypeError(type(x))


def _promote_to_shared(x: MpcFp) -> MpcFp:
    """Public -> trivial sharing (leader holds the value, others hold 0)."""
    assert x.visibility == PUBLIC
    mask = x._leader_mask().expand(x.value.shape)
    zeros = FpArray.zeros(x.spec, x.value.shape, x.value.device)
    return MpcFp(FpArray.select(mask, x.value, zeros), SHARED)


# ---------------------------------------------------------------------------
# Beaver multiplication + triple sources
# ---------------------------------------------------------------------------


class DummyTripleSource:
    """INSECURE constant (1,1,1) triples, mirroring the reference's
    ``DummyFieldTripleSource``: correct results, no privacy."""

    def field_triples(self, spec, shape):
        one = _promote_to_shared(MpcFp.const(spec, 1))
        t = T.current()
        full = party_shape(t, shape)
        limbs = one.value.limbs.reshape((t.n_parties,) + (1,) * len(shape) +
                                        (spec.nlimbs,))
        a = MpcFp(FpArray(limbs.expand(full + (spec.nlimbs,)), spec,
                          one.value.bound), SHARED)
        return a, a, a

    def group_triples(self, P, scalar_spec):
        """Group triple (a, B, C = a*B) with a = 1 and B = the group
        generator held by the leader; batch shape matches P."""
        from ..ops.curve import SWPoint
        from ..ops.fp2 import Fp2Array
        from ..ops.msm import _bcast_sw
        from .group import MpcSWPoint

        t = T.current()
        a, _, _ = self.field_triples(scalar_spec, P.shape)
        if isinstance(P.point.x, Fp2Array):
            gen = SWPoint.g2_from_affine_ints([SC.G2_GEN], t.device)
        else:
            gen = SWPoint.g1_from_affine_ints([SC.G1_GEN], t.device)
        gen = _bcast_sw(gen[0], P.point.shape)
        mask = (t.party_index(len(P.shape)) == 0).expand(P.point.shape)
        Bp = MpcSWPoint(SWPoint.select(mask, gen, SWPoint.infinity_like(gen)),
                        SHARED)
        return a, Bp, Bp

    def inv_pairs(self, spec, shape):
        """Inverse pairs (r, r^-1) with r = 1, the constant triple's a."""
        a, _, _ = self.field_triples(spec, shape)
        return a, a


def beaver_mul(x: MpcFp, y: MpcFp) -> MpcFp:
    """Batched Beaver multiplication: open d = x-a and e = y-b, then
    z = c + d*b + e*a + d*e."""
    c = ctx()
    a, b, cc = c.triple_source.field_triples(x.spec, x.shape)
    d = (x - a).reveal()
    e = (y - b).reveal()
    de = MpcFp(d * e, PUBLIC)
    return cc + b * MpcFp(d, PUBLIC) + a * MpcFp(e, PUBLIC) + de


def beaver_inv(x: MpcFp) -> MpcFp:
    """Shared inverse via an inverse pair: open x*r, return
    r * (x*r)^-1 (the public inverse is ``FpArray.inv``, x^(p-2))."""
    r, _ = ctx().triple_source.inv_pairs(x.spec, x.shape)
    xr = (x * r).reveal()
    return r * MpcFp(xr.inv(), PUBLIC)


def beaver_div(x: MpcFp, y: MpcFp) -> MpcFp:
    """Shared division x/y: mask the divisor with an inverse pair r, open
    y*r, then x/y = (x*r) * (y*r)^-1."""
    r, _ = ctx().triple_source.inv_pairs(y.spec, y.shape)
    yr = (y * r).reveal()
    return (x * r) * MpcFp(yr.inv(), PUBLIC)


def rand_shared(generator, spec: FieldSpec, shape=(), shares=None) -> MpcFp:
    """Fresh random shared value: each party holds an independent uniform
    share.  ``shares``: optional injected share tensor (FpArray [P, *shape])
    in place of the draw."""
    t = ctx().transport
    if shares is not None:
        assert shares.shape == party_shape(t, shape), shares.shape
        return MpcFp(shares.to(t.device), SHARED)
    sh = R.uniform_fp(generator, spec, party_shape(t, shape), device=t.device)
    return MpcFp(sh, SHARED)


def king_share(value: FpArray, generator, shares=None) -> MpcFp:
    """The leader (party 0) deals additive shares of ``value``: parties
    1..P-1 hold uniform draws, the leader value minus their sum.  As in the
    reference, one draw of [P, *shape] is made and row 0 is not used (the
    draws stand for a replicated key's outputs, so this is a test-net
    dealer, not private input sharing).  ``shares``: optional injected
    draws (FpArray [P, *shape]) in place of the generator's."""
    t = ctx().transport
    spec = value.spec
    batch = tuple(value.shape)
    if shares is None:
        shares = R.uniform_fp(generator, spec, party_shape(t, batch), device=t.device)
    assert shares.shape == party_shape(t, batch), shares.shape
    shares = shares.to(t.device)
    leader = value.to(t.device) - _sum_axis0(shares[1:])
    sh = FpArray.concat([leader.reshape((1,) + batch), shares[1:]], axis=0)
    return MpcFp(sh, SHARED)


def _sum_axis0(x: FpArray) -> FpArray:
    if x.shape[0] == 0:
        return FpArray.zeros(x.spec, x.shape[1:], x.device)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc
