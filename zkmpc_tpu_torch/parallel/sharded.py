"""Intra-party multi-chip sharding of the hot kernels (MSM, NTT): the chips
axis.

Port of ``zkmpc_tpu/parallel/sharded.py``.  A party may run on several
chips: its MSMs and NTTs split across them over a second process-group
axis beside the party axis.  A `ChipsGroup` (one party's chip ranks in a
``torch.distributed`` process group, with its size and this rank's index)
stands where the JAX code takes ``axis_name``:

- **MSM** is embarrassingly parallel over points: each chip computes the
  partial MSM of its slice of (points, scalars); the partials meet in one
  all-gather over the chips and a log-depth complete-add fold.
  Communication: one point a chip a MSM, whatever N.
- **NTT** uses the four-step factorization n = n1*n2: local row NTTs of
  length n1 and n2 (`ops.ntt.Domain`) around a twiddle scaling, with the
  distributed transposes as all-to-all collectives.  Each chip only runs
  dense local butterflies on its [n/C]-row block.

Shares are additively linear, so splitting the point or coefficient axis
across a party's chips commutes with the party axis: every chip of a party
holds the party's whole (replicated) share tensors, and each computes its
part of the work on them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import msm as M
from ..ops.curve import SWPoint, _bcast_sw
from ..ops.limbs import FieldSpec, FpArray
from ..ops.ntt import Domain
from . import transport as T


class ChipsGroup:
    """One party's chip ranks: a ``torch.distributed`` process group, its
    size (the chips a party) and this rank's chip index in it.

    On gloo each collective copies its tensor to the host and the result
    back to ``device``, as `transport.MeshTransport` does; on NCCL the
    tensors stay on the device.  ``gathers`` counts the all-gathers and
    their bytes (one a sharded MSM call, one a `sharded_ifft`),
    ``transposes`` the all-to-alls (three a `sharded_fft`)."""

    def __init__(self, group=None, device="cuda"):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.device = torch.device(device)
        T.check_backend(self.backend, [self.device])
        self._wire_device = self.device if self.backend == "nccl" else torch.device("cpu")
        self.gathers = T.CommStats()
        self.transposes = T.CommStats()

    def _wire(self, x, dtype=None):
        return x.detach().to(self._wire_device, dtype or x.dtype, copy=True).contiguous()

    def all_gather(self, x):
        """x [...] -> [C, ...]: every chip's x, by chip index."""
        self.gathers.record(x)
        y = self._wire(x, torch.uint8 if x.dtype == torch.bool else None)
        parts = [torch.empty_like(y) for _ in range(self.size)]
        self._dist.all_gather(parts, y, group=self.group)
        return torch.stack(parts, dim=0).to(self.device, x.dtype)

    def all_to_all(self, x):
        """x [C, ...]: block j goes to chip j; returns [C, ...] whose block
        j came from chip j."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all takes one block a chip: {tuple(x.shape)} for "
                             f"{self.size} chips")
        self.transposes.record(x)
        y = self._wire(x)
        out = torch.empty_like(y)
        self._dist.all_to_all_single(out, y, group=self.group)
        return out.to(self.device)


# ------------------------------------------------------------------ MSM


def _gather_fold(partials: SWPoint, chips: ChipsGroup) -> SWPoint:
    """Every chip's partial points [...] meet in one all-gather (limbs and
    infinity flag packed into one int64 tensor) and fold over the chips
    with complete adds: the sum over the chips, [...], on every chip."""
    leaves = partials.leaves()
    widths = [leaf.shape[-1] for leaf in leaves[:-1]] + [1]
    packed = torch.cat(leaves[:-1] + [leaves[-1][..., None].to(torch.int64)], dim=-1)
    gathered = torch.movedim(chips.all_gather(packed), 0, -2)      # [..., C, total]
    parts = iter(torch.split(gathered, widths, dim=-1))
    pts = partials.map(lambda _: next(parts), lambda _: next(parts)[..., 0] != 0)
    return M._sw_reduce_last(pts)


def sharded_sw_msm(points: SWPoint, scalars: FpArray, chips: ChipsGroup,
                   nbits: int | None = None) -> SWPoint:
    """MSM over points/scalars split across ``chips``: ``points`` [N/C] and
    ``scalars`` [..., N/C] are this chip's slice.  Returns the whole MSM
    [...] on every chip."""
    return _gather_fold(M.sw_msm(points, scalars, nbits=nbits), chips)


def _local_block(points: SWPoint, scalars: FpArray, chips: ChipsGroup):
    """This chip's block [i*per, (i+1)*per) of replicated points [N] and
    scalars [..., N], per = ceil(N/C); the tail past N is padded with
    infinity points and zero scalars, so every chip's block has per terms."""
    n = scalars.shape[-1]
    per = -(-n // chips.size)
    lo, hi = min(chips.index * per, n), min((chips.index + 1) * per, n)
    pts = points[lo:hi]
    sc = FpArray(scalars.limbs[..., lo:hi, :], scalars.spec, scalars.bound)
    pad = per - (hi - lo)
    if pad:
        inf = SWPoint.infinity_like(_bcast_sw(points[0:1], (pad,)))
        pts = SWPoint.concat([pts.tighten(), inf], axis=0)
        sc = FpArray(torch.nn.functional.pad(sc.limbs, (0, 0, 0, pad)), sc.spec, sc.bound)
    return pts, sc


def replicated_sharded_sw_msms(points_list, scalars_list, chips: ChipsGroup,
                               nbits: int | None = None) -> list:
    """k MSMs with replicated inputs (``points_list[j]`` [N_j] public
    bases, ``scalars_list[j]`` [..., N_j], every chip holding all of them),
    the work split across ``chips``: each chip takes its block of every
    MSM (`_local_block`) and runs them in one fused call
    (`ops.msm.sw_msm_multi`); the k partials meet in one all-gather and
    fold.  Returns the k MSMs [...] on every chip."""
    blocks = [_local_block(p, s, chips) for p, s in zip(points_list, scalars_list)]
    partials = M.sw_msm_multi([b[0] for b in blocks], [b[1] for b in blocks], nbits=nbits)
    shape = tuple(partials[0].shape)
    stacked = SWPoint.concat([p.reshape(shape + (1,)) for p in partials], axis=-1)
    folded = _gather_fold(stacked, chips)                             # [..., k]
    return [folded.map(lambda leaf: leaf[..., j, :], lambda leaf: leaf[..., j])
            for j in range(len(partials))]


def replicated_sharded_sw_msm(points: SWPoint, scalars: FpArray, chips: ChipsGroup,
                              nbits: int | None = None) -> SWPoint:
    """MSM with replicated points [N] and scalars [..., N], work-split
    across ``chips``: each chip's block of ceil(N/C) terms (the tail
    padded), its partial MSM, then one all-gather and the fold; the
    prove's path, where the witness is party-split but chip-replicated."""
    return replicated_sharded_sw_msms([points], [scalars], chips, nbits)[0]


# ------------------------------------------------------------------ NTT


def _transpose_shards(limbs, chips: ChipsGroup):
    """Distributed transpose of a row-split matrix of field elements:
    limbs [R_local, S, nlimbs] (global [R, S]) -> [S_local, R, nlimbs]
    (global [S, R]).  One all-to-all and a local transpose."""
    r_local, s, nl = limbs.shape
    c = chips.size
    # column block j of the local rows goes to chip j; the blocks received
    # stack by sender, which holds rows [j*R_local, (j+1)*R_local)
    blocks = limbs.reshape(r_local, c, s // c, nl).transpose(0, 1)    # [C, R_local, S/C, L]
    y = chips.all_to_all(blocks).reshape(c * r_local, s // c, nl)    # [R, S/C, L]
    return y.transpose(0, 1)                                          # [S/C, R, L]


@functools.lru_cache(maxsize=64)
def _twiddles(spec: FieldSpec, n: int, n1: int, rows_local: int, chip: int,
              device: str) -> FpArray:
    """w_n^(i2*k1) for the four-step middle scaling on one chip, made on
    the host: rows i2 = chip*rows_local + r, columns k1 < n1."""
    from ..spec import field as specfield
    omega = specfield.root_of_unity(spec.p, spec.generator, spec.two_adicity, n)
    tab = np.empty((rows_local, n1), dtype=object)
    for r in range(rows_local):
        w = pow(omega, chip * rows_local + r, spec.p)
        acc = 1
        for k1 in range(n1):
            tab[r, k1] = acc
            acc = acc * w % spec.p
    return FpArray.from_int(spec, tab, device=device)


def _factors(n: int, c: int):
    """n = n1 * n2 with both multiples of c (n1 the lower half of log2 n,
    else c)."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 % c or n2 % c:
        n1, n2 = c, n // c
    if n1 % c or n2 % c:
        raise ValueError(f"a size-{n} NTT does not split over {c} chips")
    return n1, n2


def sharded_fft(spec: FieldSpec, n: int, coeffs_local: FpArray,
                chips: ChipsGroup) -> FpArray:
    """Four-step distributed NTT.  ``coeffs_local``: this chip's
    contiguous [n/C] block of coefficients (rows of the [n1, n2] matrix
    view).  Returns this chip's contiguous [n/C] block of the evaluations
    f(omega^k), in natural order."""
    c = chips.size
    n_local = coeffs_local.shape[-1]
    if coeffs_local.shape != (n_local,) or n_local * c != n:
        raise ValueError(f"sharded_fft takes this chip's [{n}/{c}] block, not "
                         f"{coeffs_local.shape}")
    n1, n2 = _factors(n, c)
    nl = spec.nlimbs
    dev = coeffs_local.device
    x = coeffs_local.limbs.reshape(n1 // c, n2, nl)                 # rows i1, cols i2
    x = _transpose_shards(x, chips)                                   # [n2/C, n1]: rows i2
    y = Domain(spec, n1, dev).fft(FpArray(x, spec, coeffs_local.bound))   # C[i2, k1]
    y = y * _twiddles(spec, n, n1, n2 // c, chips.index, str(dev))   # w_n^(i2*k1)
    z = _transpose_shards(y.limbs, chips)                             # [n1/C, n2]: rows k1
    e = Domain(spec, n2, dev).fft(FpArray(z, spec, y.bound))          # X[k1 + n1*k2]
    out = _transpose_shards(e.limbs, chips)                           # [n2/C, n1]
    return FpArray(out.reshape(n_local, nl), spec, e.bound)


def sharded_ifft(spec: FieldSpec, n: int, evals_local: FpArray,
                 chips: ChipsGroup) -> FpArray:
    """Inverse of `sharded_fft` (natural-order blocks in and out):
    iNTT(x)[i] = (1/n) * NTT(x)[(-i) mod n], so the forward four-step, one
    all-gather of its blocks and this chip's block of the index reversal."""
    fwd = sharded_fft(spec, n, evals_local, chips)
    n_local = evals_local.shape[-1]
    full = chips.all_gather(fwd.limbs).reshape(n, spec.nlimbs)
    dev = full.device
    idx = (n - (chips.index * n_local + torch.arange(n_local, device=dev))) % n
    rev = FpArray(full.index_select(0, idx), spec, fwd.bound)
    return rev * FpArray.from_int(spec, pow(n, -1, spec.p), device=dev)
