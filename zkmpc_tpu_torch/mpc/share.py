"""Secret-shared field tensors: the MPC wire layer.

Port of ``zkmpc_tpu/mpc/share.py``.  A whole tensor is either public
(replicated across parties) or shared (each party holds an additive share);
visibility is static metadata.  Communication goes through the ambient
`parallel.transport` (psum = share opening).  Semantics kept from the
reference: public constants are added by the leader only; a shared-by-shared
product is a batched Beaver multiplication; under the SPDZ backend every
shared wire carries a MAC share (sum_i mac_i = alpha * value) that linear
ops maintain, and every opening queues its residue mac_i - alpha_i * opened
for a batched check that must be drained and verified.

Every tensor has a leading party axis of ``transport.rows`` rows: all
parties on the stacked transport, the party's own row on a socket or a
mesh rank.  A
private draw takes `rand.PartyGenerators`: party i's row comes from party
i's own generator, and a dealer (the leader in `king_share`) draws its
masks from its own generator and deals each party its row
(`Transport.deal`), so under the same private seeds a socket party holds
exactly its row of the stacked run, and no process can recompute another
party's draws.  A replicated ``torch.Generator`` (a key every party
knows) is still taken where one process plays every party.
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

#: queued field-MAC residue elements (per party) at which one coin toss
#: weighs and folds the queue
FIELD_QUEUE_ELEMS = 1 << 18


class MpcContext:
    """Ambient MPC execution state: transport, backend, triple source and,
    under ``backend="spdz"``, the MAC key share and the MAC-check queues.

    ``alpha_share``: FpArray [P], each party's share of the MAC key.  Both
    MAC checks weigh what they check by public random rhos that the parties
    draw only after the openings, from a commit-then-open coin toss
    (`rand.coin_toss`), so no party can predict them.  ``rho_bits``:
    optional injected raw draws of the field check, one (hi, lo) pair per
    opening in order (see `rand.uniform_fp`), in place of the toss.
    ``chips``: the party's `parallel.sharded.ChipsGroup` where a party runs
    on several chips (the JAX package's ``chips_axis``/``n_chips``): the
    MSMs of public bases then split their point range across it
    (`group.mpc_msm_many`)."""

    def __init__(self, transport: T.Transport, backend: str = "semi",
                 triple_source=None, alpha_share: FpArray | None = None, rho_bits=None,
                 chips=None):
        if backend not in ("semi", "spdz"):
            raise ValueError(f"unknown MPC backend {backend!r}")
        if backend == "spdz" and alpha_share is None:
            raise ValueError("the spdz backend needs the MAC key shares")
        if backend == "spdz" and not transport.holds_all_rows:
            raise NotImplementedError(f"the spdz backend on a {transport.kind} transport, one "
                                      f"party a process, is not ported (the JAX package runs "
                                      f"it on no such transport): ROADMAP.md, Queue 1")
        self.transport = transport
        self.backend = backend
        self.triple_source = triple_source or DummyTripleSource()
        self.alpha_share = alpha_share
        self.rho_bits = rho_bits
        self.chips = chips
        self._mac_accum = None       # random linear combination of residues
        self._mac_count = 0
        # field residues awaiting their rhos, and their elements
        self._field_queue = []
        self._field_queued = 0
        # group residues, one queue per group (G1 and G2 do not add): each
        # opening's MAC shares and opened points, weighed and folded at the
        # check
        self._group_queue = {}
        self._group_count = 0

    def check_generator(self) -> torch.Generator:
        """The rhos' generator of one check, seeded by a coin toss among the
        parties (one round of commitments and one of openings)."""
        return torch.Generator(self.transport.device).manual_seed(
            R.coin_toss(self.transport))

    def alpha_for(self, batch_ndim: int) -> FpArray:
        """The alpha share [P] reshaped to broadcast against party-shaped
        tensors with ``batch_ndim`` batch axes."""
        a = self.alpha_share
        limbs = a.limbs.reshape(a.limbs.shape[:1] + (1,) * batch_ndim + a.limbs.shape[-1:])
        return FpArray(limbs, a.spec, a.bound)

    # -- field MAC check (SPDZ batched check) --

    def accumulate_mac_residue(self, residue: FpArray):
        """residue: party-shaped [P, batch...] shares that must open to 0.
        It waits unweighted in the queue until a check draws its rhos; past
        FIELD_QUEUE_ELEMS queued elements one coin toss weighs and folds
        the queue, which bounds its memory (the rhos still come after the
        openings they weigh)."""
        batch = residue.shape[1:]
        flat = residue.reshape(residue.shape[:1] + ((-1,) if batch else (1,)))
        if self.rho_bits is not None:
            rho = R.uniform_fp(None, flat.spec, flat.shape[1:], device=flat.device,
                               bits=self.rho_bits[self._mac_count])
            self._fold_field(flat * rho)
        else:
            self._field_queue.append(flat)
            self._field_queued += flat.shape[1]
            if self._field_queued >= FIELD_QUEUE_ELEMS:
                self._weigh_field_queue()
        self._mac_count += 1

    def _fold_field(self, weighted: FpArray):
        s = _sum_last_axis(weighted)
        self._mac_accum = s if self._mac_accum is None else self._mac_accum + s

    def _weigh_field_queue(self):
        """Weigh every queued residue by public rhos from one coin toss and
        fold it into the accumulator."""
        if not self._field_queue:
            return
        gen = self.check_generator()
        for flat in self._field_queue:
            self._fold_field(flat * R.uniform_fp(gen, flat.spec, flat.shape[1:],
                                                 device=flat.device))
        self._field_queue = []
        self._field_queued = 0

    @property
    def mac_residue_count(self) -> int:
        """How many field openings contributed MAC residues."""
        return self._mac_count

    def drain_mac_check(self):
        """The accumulated field residue share (must open to zero), the
        queue weighed first."""
        self._weigh_field_queue()
        acc = self._mac_accum
        self._mac_accum = None
        return acc

    def assert_field_macs(self, require_nonempty: bool = False):
        """Open the accumulated field residue; it must be zero.  With
        ``require_nonempty`` the check also fails if no authenticated share
        was ever opened."""
        if require_nonempty and self._mac_count == 0:
            raise AssertionError("SPDZ field MAC queue is empty")
        acc = self.drain_mac_check()
        if acc is None:
            return True
        if not bool(_open(self.transport, acc).is_zero().all()):
            raise AssertionError("SPDZ field MAC check failed")
        return True

    # -- group MAC check (SPDZ over curve points) --

    def accumulate_group_mac_residue(self, mac, opened):
        """mac: a party-shaped SWPoint of MAC shares; opened: the opened
        point, party-shaped (replicated).  Both are queued by group, one
        entry per point, for the weighted check."""
        key = "G1" if isinstance(opened.x, FpArray) else "G2"
        flat = tuple(p.reshape((p.shape[0], -1)) for p in (mac, opened))
        self._group_queue.setdefault(key, []).append(flat)
        self._group_count += 1

    @property
    def group_mac_residue_count(self) -> int:
        """How many opened group shares contributed MAC residues (a check
        that must not be vacuous asserts this is nonzero)."""
        return self._group_count

    @property
    def group_mac_residue_counts(self) -> dict:
        """The openings queued since the last check, by group ("G1", "G2")."""
        return {k: len(v) for k, v in self._group_queue.items()}

    def drain_group_mac_check(self) -> list:
        """The group residue shares, one party-shaped point per group:
        sum_j rho_j * (mac_ij - alpha_i * P_j) over every queued point j,
        with one public rho_j per point (the same for every party) from a
        coin toss made after the openings, so tampered shares cannot cancel
        across points.  Each group is one MSM of its queued MAC shares
        (scalars rho_j) and opened points (scalars -alpha_i * rho_j); each
        residue must open to infinity."""
        from ..ops.curve import SWPoint
        from ..ops.msm import sw_msm
        out = []
        gen = self.check_generator() if self._group_queue else None
        for entries in self._group_queue.values():
            macs = SWPoint.concat([m for m, _ in entries], axis=-1)         # [P, M]
            opened = SWPoint.concat([o for _, o in entries], axis=-1)
            spec = self.alpha_share.spec
            rho = R.uniform_fp(gen, spec, macs.shape[1:], device=macs.device)   # [M]
            rho_p = rho.broadcast_to(macs.shape)
            scal = FpArray.concat([rho_p, -(rho_p * self.alpha_for(1))], axis=-2)
            out.append(sw_msm(SWPoint.concat([macs, opened], axis=-1), scal))
        self._group_queue = {}
        self._group_count = 0
        return out

    def assert_group_macs(self, require_nonempty: bool = False):
        """Open the accumulated group residues; each must be the point at
        infinity.  With ``require_nonempty`` the check fails if no
        authenticated group share was ever opened."""
        from .group import MpcSWPoint
        if require_nonempty and self._group_count == 0:
            raise AssertionError("SPDZ group MAC queue is empty: no authenticated "
                                 "group share was ever opened")
        for acc in self.drain_group_mac_check():
            if not bool(MpcSWPoint(acc, SHARED).reveal().inf.all()):
                raise AssertionError("SPDZ group MAC check failed")
        return True


def _open(t: T.Transport, x: FpArray) -> FpArray:
    """Sum party shares [rows, ...] to the opened value, replicated
    [rows, ...]."""
    x = x.tighten()
    opened = t.psum(x.limbs)
    return FpArray(_resolve2(opened)[..., :x.spec.nlimbs], x.spec,
                   2 * t.n_parties).tighten()


_CTX: contextvars.ContextVar = contextvars.ContextVar("zkmpc_torch_mpc_ctx",
                                                      default=None)


def ctx() -> MpcContext:
    c = _CTX.get()
    if c is None:
        raise RuntimeError("no MPC context; use `with mpc_scope(ctx):`")
    return c


def spdz_in_scope() -> bool:
    """Whether an MPC context on the SPDZ backend is in scope."""
    c = _CTX.get()
    return c is not None and c.backend == "spdz"


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


def check_eq(x) -> bool:
    """Debug check that every party holds the same bits of a supposedly
    public value (a public MpcFp, or an FpArray in party layout); returns
    True or raises."""
    arr = x
    if isinstance(x, MpcFp):
        assert x.visibility == PUBLIC, "check_eq is for public values"
        arr = x.value
    if not bool((arr.limbs == arr.limbs[:1]).all()):
        raise AssertionError("check_eq: parties disagree on a public value")
    return True


def _rebroadcast(t: T.Transport, limbs):
    """A [...]-shaped public tensor -> the party-shaped layout [rows, ...]."""
    return limbs[None].expand((t.rows,) + tuple(limbs.shape))


def party_shape(t: T.Transport, batch_shape):
    return (t.rows,) + tuple(batch_shape)


def stacked_shape(t: T.Transport, batch_shape):
    """The shape of a draw for every party, [P, ...]."""
    return (t.n_parties,) + tuple(batch_shape)


class MpcFp:
    """Field tensor with visibility; value layout [rows, batch...].  Under the
    SPDZ backend a shared wire also carries ``mac``, its MAC shares in the
    same layout."""

    __slots__ = ("value", "visibility", "mac")

    def __init__(self, value: FpArray, visibility: str, mac: FpArray | None = None):
        self.value = value
        self.visibility = visibility
        self.mac = mac

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

    def map(self, fn) -> "MpcFp":
        """Apply ``fn`` (FpArray -> FpArray, a layout change) to the value
        and, if present, the MAC shares."""
        return MpcFp(fn(self.value), self.visibility,
                     None if self.mac is None else fn(self.mac))

    # --------------------------------------------------------------- creation

    @classmethod
    def from_public(cls, value: FpArray):
        """Replicate a plain FpArray across the parties as a public wire."""
        t = T.current()
        limbs = value.limbs.to(t.device)
        return cls(FpArray(_rebroadcast(t, limbs), value.spec, value.bound), PUBLIC)

    @classmethod
    def const(cls, spec: FieldSpec, ints):
        return cls.from_public(FpArray.from_int(
            spec, np.asarray(ints, dtype=object), device=T.current().device))

    @classmethod
    def from_shares(cls, share_value: FpArray, mac: FpArray | None = None):
        """Wrap raw additive shares (party-shaped), with their MAC shares
        under the SPDZ backend."""
        if ctx().backend == "spdz" and mac is None:
            raise ValueError("a spdz wire requires its MAC shares")
        return cls(share_value, SHARED, mac)

    # --------------------------------------------------------------- openings

    def reveal(self) -> FpArray:
        """Open to a public plain FpArray (party-shaped, replicated).  Under
        SPDZ the residue mac_i - alpha_i * opened joins the field check."""
        c = ctx()
        if self.visibility == PUBLIC:
            return self.value
        opened = _open(c.transport, self.value)
        if c.backend == "spdz":
            c.accumulate_mac_residue(self.mac - opened * c.alpha_for(opened.ndim - 1))
        return opened

    def open(self) -> "MpcFp":
        return MpcFp(self.reveal(), PUBLIC)

    # ------------------------------------------------------------- arithmetic

    def _leader_mask(self):
        return T.current().leader_mask(self.value.ndim - 1)

    def _aligned(self, other):
        """Insert singleton batch axes after the party axis so wires of
        different batch rank broadcast (e.g. scalar const + vector share)."""
        ra = self.value.ndim - 1
        rb = other.value.ndim - 1
        rank = max(ra, rb)

        def fix(w: MpcFp, r):
            if r >= rank:
                return w

            def rs(f: FpArray):
                shp = f.limbs.shape
                return FpArray(f.limbs.reshape(shp[:1] + (1,) * (rank - r) + shp[1:]),
                               f.spec, f.bound)
            return w.map(rs)
        return fix(self, ra), fix(other, rb)

    def __add__(self, other):
        other = _coerce(other, self.spec)
        a, b = self._aligned(other)
        if a.visibility == b.visibility == PUBLIC:
            return MpcFp(a.value + b.value, PUBLIC)
        if a.visibility == PUBLIC:
            a, b = b, a
        if b.visibility == PUBLIC:
            # the leader adds the public constant to its share; every party
            # adds alpha_i * constant to its MAC share
            mask = a._leader_mask()
            summed = a.value + b.value
            shifted = FpArray.select(mask.expand(summed.shape), summed, a.value)
            mac = None
            if a.mac is not None:
                mac = a.mac + b.value * ctx().alpha_for(b.value.ndim - 1)
            return MpcFp(shifted, SHARED, mac)
        mac = None if a.mac is None else a.mac + b.mac
        return MpcFp(a.value + b.value, SHARED, mac)

    def __neg__(self):
        return MpcFp(-self.value, self.visibility,
                     None if self.mac is None else -self.mac)

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
            mac = None if a.mac is None else a.mac * b.value
            return MpcFp(a.value * b.value, SHARED, mac)
        return beaver_mul(a, b)

    def square(self):
        return self * self

    def smul(self, k: int):
        return MpcFp(self.value.smul(k), self.visibility,
                     None if self.mac is None else self.mac.smul(k))

    def double(self):
        return self.smul(2)

    # ----------------------------------------------------------------- shape

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        full = (self.value.shape[0],) + shape
        return self.map(lambda f: f.reshape(full))

    def __getitem__(self, idx):
        """Index into the batch (party axis is preserved)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return self.map(lambda f: f[(slice(None),) + idx])

    @staticmethod
    def concat(xs, axis=0):
        vis = SHARED if any(x.is_shared() for x in xs) else PUBLIC
        xs = [x if x.visibility == vis else _promote_to_shared(x) for x in xs]
        mac = None
        if xs[0].mac is not None:
            mac = FpArray.concat([x.mac for x in xs], axis + 1)
        return MpcFp(FpArray.concat([x.value for x in xs], axis + 1), vis, mac)


def _coerce(x, spec):
    if isinstance(x, MpcFp):
        return x
    if isinstance(x, FpArray):
        return MpcFp.from_public(x)
    if isinstance(x, int):
        return MpcFp.const(spec, x)
    raise TypeError(type(x))


def _promote_to_shared(x: MpcFp) -> MpcFp:
    """Public -> trivial sharing (leader holds the value, others hold 0);
    under SPDZ each party's MAC share is alpha_i * value."""
    assert x.visibility == PUBLIC
    c = ctx()
    mask = x._leader_mask().expand(x.value.shape)
    zeros = FpArray.zeros(x.spec, x.value.shape, x.value.device)
    mac = None
    if c.backend == "spdz":
        mac = x.value * c.alpha_for(x.value.ndim - 1)
    return MpcFp(FpArray.select(mask, x.value, zeros), SHARED, mac)


# ---------------------------------------------------------------------------
# Beaver multiplication + triple sources
# ---------------------------------------------------------------------------


class TripleSource:
    """Provider of multiplication triples, inverse pairs and random shares
    (reference `mpc-algebra/src/share.rs:17-42`)."""

    def field_triples(self, spec: FieldSpec, shape):
        raise NotImplementedError

    def inv_pairs(self, spec: FieldSpec, shape):
        raise NotImplementedError

    def rand_shares(self, spec: FieldSpec, shape):
        """Authenticated random shared values (SPDZ <r> pairs,
        `preprocessing.rs:823-878`)."""
        raise NotImplementedError


class DummyTripleSource(TripleSource):
    """INSECURE constant (1,1,1) triples, mirroring the reference's
    ``DummyFieldTripleSource``: correct results, no privacy.  ``generator``:
    the torch.Generator of `rand_shares`' dealt values (default: seed 0 on
    the transport's device)."""

    def __init__(self, generator=None):
        self.generator = generator

    def field_triples(self, spec, shape):
        one = _promote_to_shared(MpcFp.const(spec, 1))
        t = T.current()
        full = party_shape(t, shape) + (spec.nlimbs,)

        def bcast(f: FpArray):
            limbs = f.limbs.reshape((t.rows,) + (1,) * len(shape) + (spec.nlimbs,))
            return FpArray(limbs.expand(full), spec, f.bound)
        a = one.map(bcast)
        return a, a, a

    def group_triples(self, P, scalar_spec):
        """Group triple (a, B, C = a*B) with a = 1 and B = the group
        generator held by the leader; batch shape matches P.  Under SPDZ
        every party's MAC share of B is alpha_i * G."""
        from ..ops.curve import SWPoint
        from ..ops.fp2 import Fp2Array
        from ..ops.msm import _bcast_sw
        from .group import MpcSWPoint, _alpha_scale

        t = T.current()
        a, _, _ = self.field_triples(scalar_spec, P.shape)
        if isinstance(P.point.x, Fp2Array):
            gen = SWPoint.g2_from_affine_ints([SC.G2_GEN], t.device)
        else:
            gen = SWPoint.g1_from_affine_ints([SC.G1_GEN], t.device)
        gen = _bcast_sw(gen[0], P.point.shape)
        mask = t.leader_mask(len(P.shape)).expand(P.point.shape)
        mac = _alpha_scale(gen) if ctx().backend == "spdz" else None
        Bp = MpcSWPoint(SWPoint.select(mask, gen, SWPoint.infinity_like(gen)),
                        SHARED, mac)
        return a, Bp, Bp

    def inv_pairs(self, spec, shape):
        """Inverse pairs (r, r^-1) with r = 1, the constant triple's a."""
        a, _, _ = self.field_triples(spec, shape)
        return a, a

    def rand_shares(self, spec, shape):
        """INSECURE <r> shares: a value drawn from the source's generator
        and dealt by the leader with MACs, so every party learns it (the
        reference's test-only `can_cheat` escape hatch)."""
        t = T.current()
        if self.generator is None:
            self.generator = torch.Generator(t.device).manual_seed(0)
        v = R.uniform_fp(self.generator, spec, tuple(shape), device=t.device)
        return king_share(v, self.generator)


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
    """Fresh random shared value.  Semi-honest: each party holds an
    independent uniform share drawn from its own generator
    (`rand.uniform_rows`); ``shares``: optional injected share tensor
    (FpArray [P, *shape]) in place of the draw.  SPDZ: the value must carry
    MACs, so it comes from the triple source's <r> pool (a source without
    one raises)."""
    c = ctx()
    t = c.transport
    if c.backend == "spdz":
        if shares is not None:
            raise ValueError("spdz random shares come from the triple source")
        return c.triple_source.rand_shares(spec, shape)
    if shares is None:
        return MpcFp(R.uniform_rows(generator, spec, t, shape), SHARED)
    assert shares.shape == stacked_shape(t, shape), shares.shape
    return MpcFp(t.own_rows(shares.to(t.device)), SHARED)


def deal_fp(t: T.Transport, rows: FpArray | None, dealer: int, spec: FieldSpec,
            batch) -> FpArray:
    """Party ``dealer``'s FpArray rows [P, *batch] (None in a process that
    does not play it) -> this process's rows, in one round
    (`Transport.deal`).  On a socket the bound travels as a last word
    beside the limbs, so each party's row carries the stacked run's."""
    batch = tuple(batch)
    if t.holds_all_rows:
        t.deal(rows.limbs, dealer, batch + (spec.nlimbs,))
        return rows
    packed = None
    if rows is not None:
        limbs = rows.limbs
        bound = torch.full(limbs.shape[:-1] + (1,), rows.bound, dtype=limbs.dtype,
                           device=limbs.device)
        packed = torch.cat([limbs, bound], dim=-1)
    got = t.deal(packed, dealer, batch + (spec.nlimbs + 1,))
    return FpArray(got[..., :-1].contiguous(), spec, int(got.reshape(-1)[-1]))


def king_share(value: FpArray, generator, shares=None) -> MpcFp:
    """The leader (party 0) deals additive shares of ``value``: parties
    1..P-1 hold uniform masks the leader draws from its own generator, the
    leader value minus their sum, and each party gets its row in one round
    (`deal_fp`).  A replicated generator (one process playing every party)
    draws [P, *shape] and leaves row 0 unused, as the reference does.
    Under SPDZ every party knows the value, so each forms its MAC share
    alpha_i * value.  ``shares``: optional injected draws (FpArray
    [P, *shape]) in place of the generator's."""
    c = ctx()
    t = c.transport
    spec = value.spec
    batch = tuple(value.shape)
    if shares is None and not R._is_private(generator, t):
        shares = R.uniform_fp(generator, spec, stacked_shape(t, batch), device=t.device)
    if shares is not None:
        assert shares.shape == stacked_shape(t, batch), shares.shape
        masks = shares.to(t.device)[1:]
    else:
        masks = R.dealer_draw(generator, spec, t, 0, (t.n_parties - 1,) + batch)
    rows = None
    if t.holds(0):
        value = value.to(t.device)
        leader = value - _sum_axis0(masks)
        rows = FpArray.concat([leader.reshape((1,) + batch), masks], axis=0)
    sh = deal_fp(t, rows, 0, spec, batch)
    mac = None
    if c.backend == "spdz":
        vparty = FpArray(_rebroadcast(t, value.limbs), spec, value.bound)
        mac = vparty * c.alpha_for(len(batch))
    return MpcFp(sh, SHARED, mac)


def _sum_axis0(x: FpArray) -> FpArray:
    if x.shape[0] == 0:
        return FpArray.zeros(x.spec, x.shape[1:], x.device)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


# ---------------------------------------------------------------------------
# modulus conversion: re-embed a wire mod p1 as a wire mod p2
# ---------------------------------------------------------------------------


def modulus_conversion(x: MpcFp, target: FieldSpec, generator, shares=None) -> MpcFp:
    """A field wire mod p1 as a wire mod p2 (reference
    `mpc_primitives.rs:75-87` ``ModulusConversion``), as the reference does
    it (`share/additive.rs:164-181`, `spdz.rs:253-265`, both marked "bad
    implementation, just for testing"): the value is opened, its integer
    bits re-embedded mod p2 (`ops.limbs.fp_from_digits`), and the result
    dealt by the leader (`king_share`, its masks from ``generator``, or the
    injected ``shares``).  Only for values that may be made public
    mid-protocol.

    SPDZ: dealing in another field needs a MAC key in that field; the
    ambient key serves when ``target`` is its field, and otherwise the
    shares are dealt semi-style, without MACs, as on the reference's
    path."""
    from ..ops.limbs import fp_from_digits

    c = ctx()
    t = c.transport
    if x.visibility == PUBLIC:
        return MpcFp.from_public(fp_from_digits(target, x.value[0].int_limbs()))
    converted = fp_from_digits(target, x.reveal()[0].int_limbs())
    if c.backend == "spdz" and c.alpha_share.spec is not target:
        with mpc_scope(MpcContext(t, "semi", c.triple_source)):
            return king_share(converted, generator, shares)
    return king_share(converted, generator, shares)
