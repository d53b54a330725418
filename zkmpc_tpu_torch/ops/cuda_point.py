"""Complete short-Weierstrass point addition: kernels K2 (G1) and K3 (G2)
and their plain twin.

Port of ``zkmpc_tpu/ops/pallas_point.py`` (`_point_add_kernel`,
`_point_add_kernel_g2`, built by `_point_add_call`, called by
`sw_add_complete_pallas`).  ``point_add`` launches ``csrc/point_add.cu`` for
CUDA tensors, one thread per lane, at every batch size; for CPU tensors it
runs ``sw_add_complete_plain``, the reference's ``curve.sw_add_complete``
formula in `FpArray`/`Fp2Array` ops.  The kernel works on 32-bit words at
Montgomery radix 2^384 and returns canonical limbs, so its outputs are the
same points as the plain twin's (compare affine values), not the same
Jacobian limbs.
"""

from __future__ import annotations

import torch

from . import build as K
from .limbs import FQ, FieldSpec

_I64 = torch.int64
NWORDS = 12             # 32-bit words of an FQ element inside the kernel


def sw_add_complete_plain(p, q):
    """Addition handling all cases (doubling, negation, infinity):
    add-2007-bl with exact h == 0 / r == 0 tests, in tensor ops."""
    from .curve import SWPoint, _sw_add_core, sw_double
    out, h, r = _sw_add_core(p, q)
    h0 = h.is_zero()
    r0 = r.is_zero()
    finite = (~p.inf) & (~q.inf)
    is_dbl = finite & h0 & r0
    is_neg = finite & h0 & (~r0)
    out = SWPoint.select(is_dbl, sw_double(p), out)
    out = SWPoint(out.x, out.y, out.z, out.inf | is_neg)
    out = SWPoint.select(q.inf, p, out)
    out = SWPoint.select(p.inf, q, out)
    return out


def _words(x: int, n: int = NWORDS) -> list:
    """Nonnegative int -> n 32-bit words, low word first."""
    return [(x >> (32 * j)) & 0xFFFFFFFF for j in range(n)]


def _kernel_consts(spec: FieldSpec):
    """The kernel's field constants, int64 [2 * NWORDS + 2] in host memory
    (the C entry copies them into the kernel's parameters): p and 2p as
    32-bit words, -p^-1 mod 2^32 (the CIOS reduction factor) and p^-1 mod 64
    (the radix change 2^390 -> 2^384 at load)."""
    t = spec._dev.get("point_consts")
    if t is None:
        p = spec.p
        assert 4 * p < 1 << (32 * NWORDS), "values below 2p must stay below R/2"
        vals = _words(p) + _words(2 * p) + [-pow(p, -1, 1 << 32) % (1 << 32),
                                          pow(p, -1, 64)]
        t = torch.tensor(vals, dtype=_I64)
        spec._dev["point_consts"] = t
    return t


def _coord_parts(f):
    from .fp2 import Fp2Array
    return (f.c0, f.c1) if isinstance(f, Fp2Array) else (f,)


def sw_add_complete_cuda(p, q):
    """Launch K2 (Fp coordinates) or K3 (Fp2 coordinates) on CUDA points.

    Inputs are tightened to bound <= 2 first (as the Pallas wrapper does);
    outputs have canonical limbs and bound 2."""
    from .curve import SWPoint
    from .fp2 import Fp2Array
    from .limbs import FpArray

    g2 = isinstance(p.x, Fp2Array)
    spec = (p.x.c0 if g2 else p.x).spec
    if spec is not FQ:
        raise ValueError("point-add kernel is built for FQ coordinates only")
    dev = p.inf.device
    if dev.type != "cuda" or q.inf.device != dev:
        raise ValueError("sw_add_complete_cuda needs points on one CUDA device")
    n = spec.nlimbs
    batch = torch.broadcast_shapes(tuple(p.x.shape), tuple(q.x.shape))
    size = 1
    for d in batch:
        size *= d

    def prep(pt):
        parts = []
        for coord in (pt.x, pt.y, pt.z):
            for c in _coord_parts(coord):
                c = c.tighten()
                if c.limbs.dtype != _I64 or c.limbs.device != dev:
                    raise ValueError("coordinates must be int64 on the CUDA device")
                parts.append(c.limbs.expand(batch + (n,)))
        coords = torch.stack(parts, dim=-2).reshape(size, len(parts), n)
        inf = pt.inf.expand(batch).reshape(size).to(torch.uint8).contiguous()
        return coords.contiguous(), inf

    pc, pinf = prep(p)
    qc, qinf = prep(q)
    nc = pc.shape[1]
    out = torch.empty_like(pc)
    oinf = torch.empty_like(pinf)
    if size:
        lib = K.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zk_point_add(n, int(g2), pc.data_ptr(), pinf.data_ptr(),
                              qc.data_ptr(), qinf.data_ptr(), out.data_ptr(),
                              oinf.data_ptr(), _kernel_consts(spec).data_ptr(),
                              size, stream)
        K.check(rc, "point_add")
        K.LAUNCHES["point_add_g2" if g2 else "point_add_g1"] += 1
    out = out.reshape(batch + (nc, n))

    def fp(j):
        return FpArray(out[..., j, :], spec, 2)

    oinf = oinf.reshape(batch).to(torch.bool)
    if g2:
        return SWPoint(Fp2Array(fp(0), fp(1)), Fp2Array(fp(2), fp(3)),
                       Fp2Array(fp(4), fp(5)), oinf)
    return SWPoint(fp(0), fp(1), fp(2), oinf)


def point_add(p, q):
    """K2/K3 wrapper: the plain twin for CPU points, the kernel for CUDA ones."""
    if p.inf.device.type == "cpu" and q.inf.device.type == "cpu":
        return sw_add_complete_plain(p, q)
    return sw_add_complete_cuda(p, q)
