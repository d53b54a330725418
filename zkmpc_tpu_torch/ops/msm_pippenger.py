"""Bucketed (Pippenger) MSM: sort + chunked segmented accumulation.

Port of ``zkmpc_tpu/ops/msm_pippenger.py``; the reference's ``fori_loop``s
are Python loops here, each step one batched complete point add (kernel
K2/K3 on the card):

1. window digits (c bits) for every scalar -> flat keys (batch, window, digit);
2. one global stable argsort of the keys;
3. chunked segmented accumulation: the sorted stream is split into L lanes
   x S sequential steps; each step adds one point per lane, writing running
   sums into [L, S] buffers;
4. segment partials are compacted by a second sort and lane-boundary
   duplicates merged with log2 masked combine rounds;
5. merged bucket sums scatter into a dense [batch*W, 2^c] grid; two
   log2(2^c)-round suffix walks give each window's sum, and a Horner pass
   over windows the final points.

All point operations are complete, so duplicate and infinity bases are
handled.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve import SWPoint, _point_bound2, sw_add_complete, sw_double
from .limbs import FpArray, W as LIMB_W

# Max accumulation lanes: the reference's value, tuned on a TPU; the right
# width for the H100 is still to be measured.
LANE_CAP = 32768
SENT = 0xFFFFFFFF       # sentinel key (int64, above every real key)


def _digits(scalars: FpArray, c: int, nwin: int):
    """[..., N] scalars -> int64 digits [..., N, nwin] (little-endian windows)."""
    limbs = scalars.int_limbs()                      # [..., N, nl]
    limbs = torch.nn.functional.pad(limbs, (0, 1))
    starts = np.arange(nwin) * c
    dev = limbs.device
    idx0 = torch.as_tensor(starts // LIMB_W, device=dev)
    shift = torch.as_tensor(starts % LIMB_W, device=dev)
    l0 = limbs[..., idx0]
    l1 = limbs[..., idx0 + 1]
    d = (l0 >> shift) | (l1 << (LIMB_W - shift))
    return d & ((1 << c) - 1)


def _gather(p: SWPoint, idx) -> SWPoint:
    """Gather points along the (single) batch axis."""
    return p.map(lambda leaf: leaf.index_select(0, idx))


def _tighten2(p: SWPoint) -> SWPoint:
    return _point_bound2(p.tighten())


def sw_msm_bucketed(points: SWPoint, scalars: FpArray, c: int = 8,
                    nbits: int | None = None,
                    point_batches: int = 1) -> SWPoint:
    """points: [N] public bases (or [kB, N] with point_batches=kB distinct
    base sets cycling over the flattened scalar batch); scalars: [..., N]
    -> SWPoint [...]."""
    nbits = nbits or scalars.spec.p.bit_length()
    nwin = -(-nbits // c)
    batch_shape = scalars.shape[:-1]
    N = scalars.shape[-1]
    Bt = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    D = 1 << c
    nb_total = Bt * nwin * D
    M = Bt * nwin * N
    kB = point_batches
    assert Bt % kB == 0, "point batches must divide the flattened batch"
    if kB > 1:
        points = points.reshape((kB * N,))
    dev = scalars.device

    digits = _digits(scalars, c, nwin).reshape((Bt, N, nwin))
    flat_d = digits.permute(0, 2, 1).reshape(-1)     # [M], layout (b, w, i)
    bw = torch.arange(Bt * nwin, device=dev).repeat_interleave(N)
    keys = bw * D + flat_d

    perm = torch.argsort(keys, stable=True)
    skeys = keys[perm]
    if kB > 1:
        b_idx = perm // (nwin * N)
        spoint_idx = (b_idx % kB) * N + perm % N
    else:
        spoint_idx = perm % N

    L = int(min(LANE_CAP, max(64, 2 ** int(np.ceil(np.log2(max(M // 16, 1)))))))
    S = -(-M // L)
    pad = L * S - M
    skeys = torch.cat([skeys, torch.full((pad,), SENT, dtype=skeys.dtype,
                                         device=dev)]).reshape(L, S)
    spoint_idx = torch.cat([spoint_idx, torch.zeros(pad, dtype=spoint_idx.dtype,
                                                    device=dev)]).reshape(L, S)

    pts = _point_bound2(points.tighten())
    zeros_l = torch.zeros(L, dtype=torch.int64, device=dev)
    inf_L = _point_bound2(SWPoint.infinity_like(_gather(pts, zeros_l)))

    # [L, S] running-sum buffers, written one step column at a time
    bufs = inf_L.map(lambda leaf: torch.empty((L, S) + tuple(leaf.shape[1:]),
                                              dtype=leaf.dtype, device=dev))

    acc = inf_L
    for s in range(S):
        k = skeys[:, s]
        kprev = skeys[:, max(s - 1, 0)]
        p = _gather(pts, spoint_idx[:, s])
        p = SWPoint.select(k == SENT, inf_L, p)
        same = (k == kprev) & (s > 0)
        acc = _tighten2(SWPoint.select(same, sw_add_complete(acc, p), p))
        _store_column(bufs, acc, s)

    # segment-end mask (per lane; cross-lane merging below)
    nxt = torch.cat([skeys[:, 1:], torch.full((L, 1), SENT, dtype=skeys.dtype,
                                               device=dev)], dim=1)
    is_end = (skeys != nxt)
    is_end[:, S - 1] = True
    ends = (is_end & (skeys != SENT)).reshape(-1)
    cand_keys = torch.where(ends, skeys.reshape(-1),
                            torch.full_like(skeys.reshape(-1), SENT))

    # compaction: valid partials number <= nb_total + L
    K = int(min(nb_total + L, L * S))
    order = torch.argsort(cand_keys, stable=True)[:K]
    ckeys = cand_keys[order]
    parts = bufs.map(lambda buf: buf.reshape((L * S,) + tuple(buf.shape[2:]))[order])
    parts = SWPoint(parts.x, parts.y, parts.z, parts.inf | (ckeys == SENT))
    del bufs

    # merge lane-boundary duplicates: log rounds of masked combines
    rounds = int(np.ceil(np.log2(max(L, 2)))) + 1
    iota_k = torch.arange(K, device=dev)
    parts = _tighten2(parts)
    for r in range(rounds):
        d = 1 << r
        shifted = parts.map(lambda leaf: torch.roll(leaf, d, dims=0))
        samek = (iota_k >= d) & (ckeys == torch.roll(ckeys, d))
        parts = _tighten2(SWPoint.select(samek, sw_add_complete(parts, shifted),
                                         parts))
    last = torch.cat([ckeys[1:] != ckeys[:-1],
                      torch.ones(1, dtype=torch.bool, device=dev)])
    final_mask = last & (ckeys != SENT)

    # scatter bucket sums into the dense grid (unique indices)
    tgt = ckeys[final_mask]
    zeros_g = torch.zeros(nb_total, dtype=torch.int64, device=dev)
    grid = _point_bound2(SWPoint.infinity_like(_gather(pts, zeros_g)))
    grid = _scatter(grid, tgt, parts.map(lambda leaf: leaf[final_mask]))
    grid = grid.map(lambda leaf: leaf.reshape((Bt * nwin, D) + tuple(leaf.shape[1:])))

    # bucket combine: tot = sum_d d * S_d = sum_{j>=1} (sum_{d>=j} S_d) per
    # (batch, window): two log2(D)-round suffix walks over the whole grid,
    # the j = 0 bucket dropped between them
    iota_d = torch.arange(D, device=dev)[None, :]
    log2d = int(np.ceil(np.log2(max(D, 2))))

    def rolled(pt: SWPoint, d) -> SWPoint:
        """pt[:, j] <- pt[:, j+d] along buckets, infinity past the end."""
        sh = pt.map(lambda leaf: torch.roll(leaf, -d, dims=1))
        return SWPoint(sh.x, sh.y, sh.z, sh.inf | (iota_d + d >= D))

    run = _tighten2(grid)
    for r in range(2 * log2d):
        d = 1 << (r % log2d)
        if r == log2d:
            run = SWPoint(run.x, run.y, run.z, run.inf | (iota_d == 0))
        run = _tighten2(sw_add_complete(run, rolled(run, d)))
    tot = run.map(lambda leaf: leaf[:, 0])

    # Horner over windows
    win = tot.map(lambda leaf: leaf.reshape((Bt, nwin) + tuple(leaf.shape[1:])))
    res = win.map(lambda leaf: leaf[:, nwin - 1])
    for j in range(nwin - 1):
        w = nwin - 2 - j
        for _ in range(c):
            res = sw_double(res)
        res = _tighten2(sw_add_complete(res, win.map(lambda leaf: leaf[:, w])))
    return res.reshape(batch_shape)


def _store_column(bufs: SWPoint, val: SWPoint, s: int):
    for buf, v in zip(bufs.leaves(), val.leaves()):
        buf[:, s] = v


def _scatter(grid: SWPoint, idx, src: SWPoint) -> SWPoint:
    """grid[idx] = src on every leaf (fresh tensors; idx unique)."""
    out = grid.map(lambda leaf: leaf.clone())
    for dst, v in zip(out.leaves(), src.leaves()):
        dst[idx] = v
    return out
