"""Secret-shared elliptic-curve points (additive group shares).

Port of the semi-honest half of ``zkmpc_tpu/mpc/group.py``:

- a shared point tensor is one Jacobian point (batch) per party;
- reveal = complete-addition fold over the party axis;
- scaling a shared point by a shared scalar uses a group Beaver triple;
- an MSM of public bases with shared scalars is local to each party.
"""

from __future__ import annotations

import torch

from ..ops import msm as M
from ..ops.curve import (SWPoint, _point_bound2, sw_add_complete, sw_neg,
                         sw_scalar_mul)
from ..ops.limbs import FpArray
from ..parallel import transport as T
from .share import PUBLIC, SHARED, MpcFp, ctx

__all__ = ["MpcSWPoint", "mpc_msm", "mpc_msm_many", "scale_many", "scale_sum"]


class MpcSWPoint:
    """Shared (or public) batch of short-Weierstrass points; layout
    [P, batch...]."""

    __slots__ = ("point", "visibility")

    def __init__(self, point: SWPoint, visibility: str):
        self.point = point
        self.visibility = visibility

    @property
    def shape(self):
        return self.point.shape[1:]

    @classmethod
    def from_public(cls, point: SWPoint):
        t = T.current()
        return cls(M._bcast_sw(point, (t.n_parties,) + tuple(point.shape)), PUBLIC)

    # ---------------------------------------------------------------- algebra

    def __add__(self, other: "MpcSWPoint") -> "MpcSWPoint":
        a, b = self, other
        if a.visibility == b.visibility == PUBLIC:
            return MpcSWPoint(sw_add_complete(a.point, b.point), PUBLIC)
        if a.visibility == PUBLIC:
            a, b = b, a
        if b.visibility == PUBLIC:
            # the leader adds the public point to its share
            t = T.current()
            mask = (t.party_index(len(self.shape)) == 0).expand(a.point.shape)
            added = sw_add_complete(a.point, b.point)
            return MpcSWPoint(SWPoint.select(mask, added, a.point), SHARED)
        return MpcSWPoint(sw_add_complete(a.point, b.point), SHARED)

    def __neg__(self):
        return MpcSWPoint(sw_neg(self.point), self.visibility)

    def __sub__(self, other):
        return self + (-other)

    def reveal(self) -> SWPoint:
        """Open the shared point: fold all party shares with complete adds."""
        if self.visibility == PUBLIC:
            return self.point
        t = T.current()
        acc = _fold_leading_axis(self.point, t.n_parties)
        return M._bcast_sw(acc, (t.n_parties,) + tuple(acc.shape))

    def open(self) -> "MpcSWPoint":
        return MpcSWPoint(self.reveal(), PUBLIC)


def _fold_leading_axis(p: SWPoint, n: int) -> SWPoint:
    """Sum a point batch over its leading (party) axis with the masked
    log-depth fold."""
    if n == 1:
        return p[0]
    moved = p.map(lambda leaf: torch.movedim(leaf, 0, -2),
                  lambda leaf: torch.movedim(leaf, 0, -1))
    return M._sw_reduce_last(moved)


def mpc_msm(bases: SWPoint, scalars: MpcFp) -> MpcSWPoint:
    """MSM of public bases with a (shared or public) scalar vector [..., N]:
    each party MSMs its own scalar shares, no communication."""
    return MpcSWPoint(M.sw_msm(bases, scalars.value), scalars.visibility)


def mpc_msm_many(bases_list, scalars_list) -> list:
    """k MSMs of public base sets with shared scalar vectors, fused into
    one bucketed call (`ops/msm.py:sw_msm_multi`)."""
    if len(bases_list) == 1:
        return [mpc_msm(bases_list[0], scalars_list[0])]
    vals = M.sw_msm_multi(bases_list, [s.value for s in scalars_list])
    vis = scalars_list[0].visibility
    return [MpcSWPoint(v, vis) for v in vals]


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
    double-and-add ladder for all 3k terms (d*B, a*E, d*E stacked on a
    trailing batch axis).  Per pair: open d = x - a and E = P - B, then
    x*P = C + d*B + a*E + d*E."""
    c = ctx()
    k = len(pairs)
    P = MpcSWPoint(_stack_points_last([p.point for p, _ in pairs]), SHARED)
    x = MpcFp.concat([xx.reshape(1) for _, xx in pairs], axis=0)   # [k]

    a, Bp, Cp = c.triple_source.group_triples(P, x.spec)
    d = (x - a).reveal()                      # public scalars [k]
    E = (P - Bp).reveal()                     # public points [k]

    bases_t = SWPoint.concat([Bp.point, E, E], axis=-1)
    scal_t = FpArray.concat([d, a.value, d], axis=-2)   # -2: last batch axis
    prods = sw_scalar_mul(bases_t, scal_t)    # one ladder for every term

    db = _tslice(prods, 0, k)
    aE = _tslice(prods, k, 2 * k)
    dE = _tslice(prods, 2 * k, 3 * k)
    # per-pair shared sum C + d*B + a*E in one masked log fold
    shared_sum = M._sw_reduce_last(_stack_term_axis([Cp.point, db, aE]))
    res = MpcSWPoint(shared_sum, SHARED) + MpcSWPoint(dE, PUBLIC)
    return [MpcSWPoint(_take_trailing(res.point, j), SHARED) for j in range(k)]


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
    return MpcSWPoint(val, SHARED)
