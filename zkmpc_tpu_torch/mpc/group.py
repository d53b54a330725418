"""Secret-shared elliptic-curve points (additive group shares).

Port of ``zkmpc_tpu/mpc/group.py``:

- a shared point tensor is one Jacobian point (batch) per party, on a
  leading axis of ``transport.rows`` rows;
- reveal = complete-addition fold over the party axis (on a socket the
  parties' tightened shares are all-gathered first);
- scaling a shared point by a shared scalar uses a group Beaver triple;
- an MSM of public bases with shared scalars is local to each party;
- under the SPDZ backend a shared point carries group MAC shares
  (sum_i mac_i = alpha * P) that linear ops maintain; an opening queues its
  residue for the context's group-MAC check.  A public point added to a
  shared one joins a public offset beside the MAC shares instead of an
  alpha_i ladder; the check subtracts it from the opened point.
"""

from __future__ import annotations

import torch

from ..ops import msm as M
from ..ops.curve import (SWPoint, _point_bound2, _stack_points, sw_add_complete, sw_neg,
                         sw_scalar_mul)
from ..ops.limbs import FpArray
from ..parallel import transport as T
from .share import _CTX, PUBLIC, SHARED, MpcFp, ctx

__all__ = ["MpcSWPoint", "mpc_msm", "mpc_msm_many", "scale_many", "scale_sum",
           "with_mac_from_public"]


class MpcSWPoint:
    """Shared (or public) batch of short-Weierstrass points; layout
    [rows, batch...].  ``mac``: the group MAC shares of a shared point under
    SPDZ, in the same layout; ``offset``: None or a public point Q (party
    layout, replicated) that they leave out: party i's MAC share is
    mac_i + alpha_i * Q, and its residue at an opening P' is
    mac_i - alpha_i * (P' - Q)."""

    __slots__ = ("point", "visibility", "mac", "offset")

    def __init__(self, point: SWPoint, visibility: str, mac: SWPoint | None = None,
                 offset: SWPoint | None = None):
        self.point = point
        self.visibility = visibility
        self.mac = mac
        self.offset = offset

    @property
    def shape(self):
        return self.point.shape[1:]

    @classmethod
    def from_public(cls, point: SWPoint):
        t = T.current()
        return cls(M._bcast_sw(point, (t.rows,) + tuple(point.shape)), PUBLIC)

    # ---------------------------------------------------------------- algebra

    def __add__(self, other: "MpcSWPoint") -> "MpcSWPoint":
        a, b = self, other
        if a.visibility == b.visibility == PUBLIC:
            return MpcSWPoint(sw_add_complete(a.point, b.point), PUBLIC)
        if a.visibility == PUBLIC:
            a, b = b, a
        if b.visibility == PUBLIC:
            # the leader adds the public point to its share; the MAC shares
            # owe alpha_i * P_pub more, which the offset carries
            t = T.current()
            mask = t.leader_mask(len(self.shape)).expand(a.point.shape)
            added = sw_add_complete(a.point, b.point)
            offset = None if a.mac is None else _add_offsets(a.offset, b.point)
            return MpcSWPoint(SWPoint.select(mask, added, a.point), SHARED, a.mac, offset)
        if (a.mac is None) != (b.mac is None):
            # a MAC'd share may only combine with another MAC'd share
            raise ValueError("adding a MAC'd group share to a MAC-less one would "
                             "silently drop SPDZ authentication")
        if a.mac is None:
            return MpcSWPoint(sw_add_complete(a.point, b.point), SHARED)
        return MpcSWPoint(sw_add_complete(a.point, b.point), SHARED,
                          sw_add_complete(a.mac, b.mac), _add_offsets(a.offset, b.offset))

    def __neg__(self):
        return MpcSWPoint(sw_neg(self.point), self.visibility,
                          None if self.mac is None else sw_neg(self.mac),
                          None if self.offset is None else sw_neg(self.offset))

    def __sub__(self, other):
        return self + (-other)

    def scale_public(self, k: MpcFp) -> "MpcSWPoint":
        """Multiply by a public scalar (local); the MAC shares ride the same
        ladder."""
        assert k.visibility == PUBLIC
        if self.mac is None:
            return MpcSWPoint(sw_scalar_mul(self.point, k.value), self.visibility)
        pts = [self.point, self.mac] + ([] if self.offset is None else [self.offset])
        out = sw_scalar_mul(_stack_points(_bcast_all(pts)), k.value)
        return MpcSWPoint(out[0], self.visibility, out[1],
                          None if self.offset is None else out[2])

    def scale(self, x: MpcFp) -> "MpcSWPoint":
        """Multiply by a (possibly shared) scalar."""
        if x.visibility == PUBLIC:
            return self.scale_public(x)
        if self.visibility == PUBLIC:
            # public base, shared scalar: each party scales the base by its
            # share; the MAC share of x*P is mac_x * P (linearity), in the
            # same ladder
            if x.mac is None:
                return MpcSWPoint(sw_scalar_mul(self.point, x.value), SHARED)
            both = sw_scalar_mul(self.point, FpArray.stack([x.value, x.mac]))
            return MpcSWPoint(both[0], SHARED, both[1])
        return _group_beaver_scale(self, x)

    def reveal(self) -> SWPoint:
        """Open the shared point: fold all party shares with complete adds
        (a socket party all-gathers them first).  Under SPDZ the MAC
        residue joins the context's group-MAC queue."""
        if self.visibility == PUBLIC:
            return self.point
        t = T.current()
        shares = self.point if t.holds_all_rows else _gather_shares(t, self.point)
        acc = _fold_leading_axis(shares, t.n_parties)
        acc = M._bcast_sw(acc, (t.rows,) + tuple(acc.shape))
        if self.mac is not None:
            owed = acc if self.offset is None else sw_add_complete(acc, sw_neg(self.offset))
            ctx().accumulate_group_mac_residue(self.mac, owed)
        return acc

    def open(self) -> "MpcSWPoint":
        return MpcSWPoint(self.reveal(), PUBLIC)


def _gather_shares(t: T.Transport, p: SWPoint) -> SWPoint:
    """A socket party's point share [1, ...] -> every party's [P, ...]:
    one all-gather of the tightened Jacobian coordinates, with the
    infinity flag as one more column."""
    p = p.tighten()
    leaves = p.leaves()
    widths = [leaf.shape[-1] for leaf in leaves[:-1]]
    packed = torch.cat(leaves[:-1] + [p.inf.to(torch.int64)[..., None]], dim=-1)
    cols = iter(torch.split(t.all_gather(packed)[0], widths + [1], dim=-1))
    return p.map(lambda _: next(cols), lambda _: next(cols)[..., 0].bool())


def _fold_leading_axis(p: SWPoint, n: int) -> SWPoint:
    """Sum a point batch over its leading (party) axis with the masked
    log-depth fold."""
    if n == 1:
        return p[0]
    moved = p.map(lambda leaf: torch.movedim(leaf, 0, -2),
                  lambda leaf: torch.movedim(leaf, 0, -1))
    return M._sw_reduce_last(moved)


def _add_offsets(a: SWPoint | None, b: SWPoint | None) -> SWPoint | None:
    """The sum of two public MAC offsets (None: no offset)."""
    if a is None or b is None:
        return b if a is None else a
    return sw_add_complete(a, b)


def _bcast_all(pts):
    """Point batches broadcast to their common shape."""
    shape = torch.broadcast_shapes(*(tuple(p.shape) for p in pts))
    return [M._bcast_sw(p, shape) for p in pts]


def _alpha_scale(point: SWPoint) -> SWPoint:
    """alpha_i * P for the context's SPDZ key share (local scalar mul);
    ``point`` is party-shaped."""
    return sw_scalar_mul(point, ctx().alpha_for(len(point.shape) - 1))


def with_mac_from_public(point_pub: SWPoint) -> MpcSWPoint:
    """Lift a public point into a MAC'd SPDZ sharing: the leader holds P,
    every party holds the MAC share alpha_i * P."""
    t = T.current()
    point_pub = M._bcast_sw(point_pub, (t.rows,) + tuple(point_pub.shape))
    mask = t.leader_mask(len(point_pub.shape) - 1).expand(point_pub.shape)
    share = SWPoint.select(mask, point_pub, SWPoint.infinity_like(point_pub))
    return MpcSWPoint(share, SHARED, _alpha_scale(point_pub))


def mpc_msm(bases: SWPoint, scalars: MpcFp) -> MpcSWPoint:
    """MSM of public bases with a (shared or public) scalar vector [..., N]:
    each party MSMs its own scalar shares, no communication.  Under SPDZ
    the MSM of the scalar MAC shares is the group MAC share
    (sum_i msm(b, mac_i) = alpha * msm(b, s)); it rides the same call."""
    return mpc_msm_many([bases], [scalars])[0]


#: calls of `mpc_msm_many` (and so `mpc_msm`) in this process: with a
#: chips group each is one gather over it
MSM_CALLS = 0


def mpc_msm_many(bases_list, scalars_list) -> list:
    """k MSMs of public base sets with shared scalar vectors, fused into
    one call (`ops/msm.py:sw_msm_multi`); MAC'd scalars add their MAC MSMs
    to the same call.  Where the context carries a chips group and the
    bases are unbatched ([N] each, the JAX package's rule), each chip takes
    its block of every MSM, still fused into one call, and the partials
    meet in one gather over the chips
    (`parallel.sharded.replicated_sharded_sw_msms`)."""
    global MSM_CALLS
    MSM_CALLS += 1
    k = len(bases_list)
    macs = [s.mac for s in scalars_list]
    with_mac = all(m is not None for m in macs)
    bases = list(bases_list) * (2 if with_mac else 1)
    scal = [s.value for s in scalars_list] + (macs if with_mac else [])
    c = _CTX.get()
    chips = None if c is None else c.chips
    if chips is not None and all(len(b.shape) == 1 for b in bases):
        from ..parallel.sharded import replicated_sharded_sw_msms
        outs = replicated_sharded_sw_msms(bases, scal, chips)
    elif len(bases) == 1:
        outs = [M.sw_msm(bases[0], scal[0])]
    else:
        outs = M.sw_msm_multi(bases, scal)
    vis = scalars_list[0].visibility
    return [MpcSWPoint(outs[j], vis, outs[k + j] if with_mac else None)
            for j in range(k)]


def _group_beaver_scale(P: MpcSWPoint, x: MpcFp) -> MpcSWPoint:
    """x*P for shared x and shared P via a group triple (a, B, C = a*B):
    open d = x - a and E = P - B, then x*P = C + d*B + a*E + d*E."""
    return scale_many([(P, x)])[0]


def _stack_points_last(pts):
    """Stack k same-shaped SWPoints along a new trailing batch axis."""
    exp = [p.reshape(tuple(p.shape) + (1,)) for p in pts]
    return exp[0] if len(exp) == 1 else SWPoint.concat(exp, axis=-1)


def _take_trailing(p: SWPoint, j: int) -> SWPoint:
    return p.map(lambda leaf: leaf[..., j, :], lambda leaf: leaf[..., j])


def _tslice(p: SWPoint, a: int, b: int) -> SWPoint:
    return p.map(lambda leaf: leaf[..., a:b, :], lambda leaf: leaf[..., a:b])


def scale_many(pairs) -> list:
    """Batched group-Beaver scaling: [x_j * P_j for (P_j, x_j) in pairs]
    with one triple batch, one batched open round, and one fused
    double-and-add ladder for all terms (d*B, a*E, d*E, and under SPDZ the
    MAC terms d*mac_B and mac_a*E, stacked on a trailing batch axis).  Per
    pair: open d = x - a and E = P - B, then x*P = C + d*B + a*E + d*E."""
    c = ctx()
    k = len(pairs)
    P_macs = P_offsets = None
    if all(p.mac is not None for p, _ in pairs):
        P_macs = _stack_points_last([p.mac for p, _ in pairs])
        if any(p.offset is not None for p, _ in pairs):
            P_offsets = _stack_points_last(
                [SWPoint.infinity_like(p.point) if p.offset is None
                 else _bcast_all([p.offset, p.point])[0] for p, _ in pairs])
    P = MpcSWPoint(_stack_points_last([p.point for p, _ in pairs]), SHARED, P_macs, P_offsets)
    x = MpcFp.concat([xx.reshape(1) for _, xx in pairs], axis=0)   # [k]

    a, Bp, Cp = c.triple_source.group_triples(P, x.spec)
    d = (x - a).reveal()                      # public scalars [k]
    E = (P - Bp).reveal()                     # public points [k]

    spdz = a.mac is not None and Bp.mac is not None
    bases = [Bp.point, E, E]
    scal = [d, a.value, d]
    if spdz:
        # mac(d*B) = d * mac_B, mac(a*E) = mac_a * E
        bases += [Bp.mac, E]
        scal += [d, a.mac]
    prods = sw_scalar_mul(SWPoint.concat(bases, axis=-1),
                          FpArray.concat(scal, axis=-2))   # -2: last batch axis

    db = _tslice(prods, 0, k)
    aE = _tslice(prods, k, 2 * k)
    dE = _tslice(prods, 2 * k, 3 * k)
    # per-pair shared sum C + d*B + a*E in one masked log fold
    shared_sum = M._sw_reduce_last(_stack_term_axis([Cp.point, db, aE]))
    mac_sum = None
    if spdz:
        mac_sum = M._sw_reduce_last(_stack_term_axis(
            [Cp.mac, _tslice(prods, 3 * k, 4 * k), _tslice(prods, 4 * k, 5 * k)]))
    res = MpcSWPoint(shared_sum, SHARED, mac_sum) + MpcSWPoint(dE, PUBLIC)

    def take(p, j):
        return None if p is None else _take_trailing(p, j)
    return [MpcSWPoint(take(res.point, j), SHARED, take(res.mac, j), take(res.offset, j))
            for j in range(k)]


def _stack_term_axis(pts):
    """Stack k same-shaped point batches along a NEW trailing batch axis
    (bounds normalized to 2 first)."""
    pts = [_point_bound2(p.tighten()) for p in pts]

    def coords(name):
        fs = [getattr(p, name) for p in pts]
        return type(fs[0]).stack(fs, axis=-2)      # limbs stay last
    return SWPoint(coords("x"), coords("y"), coords("z"),
                   torch.stack([p.inf for p in pts], dim=-1))


def scale_sum(pairs, extra_shared=()) -> MpcSWPoint:
    """sum_j x_j * P_j (+ extra SHARED points), all shared terms folded by
    one masked log fold (Groth16's C = h-msm + l-msm + s*A + r*B1)."""
    outs = scale_many(pairs)
    terms = list(outs) + list(extra_shared)
    if len(terms) == 1:
        return terms[0]
    val = M._sw_reduce_last(_stack_term_axis([t.point for t in terms]))
    mac = offset = None
    n_mac = sum(t.mac is not None for t in terms)
    if n_mac:
        if n_mac != len(terms):
            raise ValueError("scale_sum: mixing MAC'd and MAC-less group shares "
                             "would silently drop SPDZ authentication")
        mac = M._sw_reduce_last(_stack_term_axis([t.mac for t in terms]))
        for t in terms:
            offset = _add_offsets(offset, t.offset)
    return MpcSWPoint(val, SHARED, mac, offset)
