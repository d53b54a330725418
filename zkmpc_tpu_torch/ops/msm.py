"""Multi-scalar multiplication.

Port of ``zkmpc_tpu/ops/msm.py``.  Short Weierstrass: 16 points and more
go to the bucketed Pippenger MSM (`msm_pippenger.sw_msm_bucketed`); fewer
use a batched double-and-add ladder plus a masked log-depth fold.  The
16-point cutoff is the reference's; it is still to be re-measured on the
H100.  Twisted Edwards (`te_msm`): a per-point double-and-add, then a
log-depth fold of the products.
"""

from __future__ import annotations

import torch

from .curve import (SWPoint, TEPoint, _bcast_sw, _point_bound2, sw_add_complete,
                    sw_scalar_mul, te_add, te_scalar_mul)
from .fp2 import Fp2Array
from .limbs import FpArray

MIN_BUCKETED_POINTS = 16


def sw_msm(points: SWPoint, scalars: FpArray, nbits: int | None = None) -> SWPoint:
    """points: [N] (or broadcastable), scalars: [..., N] -> SWPoint [...]."""
    N = scalars.shape[-1]
    if N >= MIN_BUCKETED_POINTS and len(points.shape) == 1:
        from .msm_pippenger import sw_msm_bucketed
        return sw_msm_bucketed(points, scalars, nbits=nbits)
    prods = sw_scalar_mul(points, scalars, nbits)
    return _sw_reduce_last(prods)


def sw_msm_multi(points_list, scalars_list, nbits: int | None = None):
    """k MSMs over different base sets in ONE bucketed call.

    points_list[j]: SWPoint [N_j] public bases; scalars_list[j]: FpArray
    [..., N_j] with a common leading batch shape.  Shorter MSMs pad with
    (infinity, 0) pairs.  Returns a list of k SWPoint [...] results."""
    from .msm_pippenger import sw_msm_bucketed

    k = len(points_list)
    if k == 1:
        return [sw_msm(points_list[0], scalars_list[0], nbits=nbits)]
    Nmax = max(p.shape[0] for p in points_list)
    if Nmax < MIN_BUCKETED_POINTS:
        return _sw_msm_ladders(points_list, scalars_list, nbits)
    spec = scalars_list[0].spec

    def pad_pts(p):
        n = p.shape[0]
        if n == Nmax:
            return p
        pad = SWPoint.infinity_like(_bcast_sw(p[0:1], (Nmax - n,)))
        return SWPoint.concat([p.tighten(), pad], axis=0)

    def pad_sc(s):
        n = s.shape[-1]
        if n == Nmax:
            return s
        limbs = torch.nn.functional.pad(s.limbs, (0, 0, 0, Nmax - n))
        return FpArray(limbs, spec, s.bound)

    pts = SWPoint.concat([pad_pts(p).reshape((1, Nmax)) for p in points_list],
                         axis=0)                              # [k, Nmax]
    # the k MSMs stack as a new batch axis before N (limbs stay last)
    scal = FpArray(torch.stack([pad_sc(s).limbs for s in scalars_list], dim=-3),
                   spec, max(s.bound for s in scalars_list))
    out = sw_msm_bucketed(pts, scal, nbits=nbits, point_batches=k)
    return [_take_last(out, j) for j in range(k)]


def _sw_msm_ladders(points_list, scalars_list, nbits):
    """Small MSMs: ONE double-and-add ladder over every term of every MSM
    (lanes are independent, so each product is what its own ladder gives),
    then one masked fold per MSM."""
    sizes = [s.shape[-1] for s in scalars_list]
    pts = SWPoint.concat(list(points_list), axis=-1)
    scal = FpArray.concat(scalars_list, axis=-2)
    prods = sw_scalar_mul(pts, scal, nbits)
    out, start = [], 0
    for n in sizes:
        part = prods.map(lambda leaf: leaf[..., start:start + n, :],
                         lambda leaf: leaf[..., start:start + n])
        out.append(_sw_reduce_last(part))
        start += n
    return out


def _sw_reduce_last(p: SWPoint) -> SWPoint:
    """Fold the last batch axis with complete adds (masked log-depth tree)."""
    n = p.shape[-1]
    if n == 1:
        return _take_last(p, 0)
    log = (n - 1).bit_length()
    iota = torch.arange(n, device=p.device)
    x = _point_bound2(p.tighten())
    inf = _point_bound2(SWPoint.infinity_like(x))
    for k in range(log):
        d = 1 << k
        rolled = x.map(lambda leaf: torch.roll(leaf, -d, dims=-2),
                       lambda leaf: torch.roll(leaf, -d, dims=-1))
        valid = ((iota + d) < n).expand(x.inf.shape)
        rolled = SWPoint.select(valid, rolled, inf)
        x = _point_bound2(sw_add_complete(x, rolled).tighten())
    return _take_last(x, 0)


def _take_last(p: SWPoint, i) -> SWPoint:
    return SWPoint(_coord_slice(p.x, i), _coord_slice(p.y, i),
                   _coord_slice(p.z, i), p.inf[..., i])


def _coord_slice(f, sl):
    if isinstance(f, FpArray):
        return FpArray(f.limbs[..., sl, :], f.spec, f.bound)
    return Fp2Array(_coord_slice(f.c0, sl), _coord_slice(f.c1, sl))


def te_msm(points: TEPoint, scalars: FpArray, nbits: int | None = None) -> TEPoint:
    """points: [N] (or broadcastable), scalars: [..., N] -> TEPoint [...]:
    every product by `curve.te_scalar_mul`, then pairwise folds of the
    last axis (an odd last product carried to the next level)."""
    shape = scalars.shape
    prods = te_scalar_mul(points.map(lambda c: c.broadcast_to(shape)), scalars, nbits)
    while prods.shape[-1] > 1:
        n = prods.shape[-1]
        half = n // 2
        folded = te_add(prods.map(lambda c: _coord_slice(c, slice(0, half))),
                        prods.map(lambda c: _coord_slice(c, slice(half, 2 * half))))
        if n % 2:
            folded = TEPoint.concat([folded, prods.map(
                lambda c: _coord_slice(c, slice(2 * half, n)))], axis=-1)
        prods = folded
    return prods.map(lambda c: _coord_slice(c, 0))
