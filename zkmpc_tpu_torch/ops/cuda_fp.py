"""Batched Montgomery multiplication: kernel K1 and its plain twin.

Port of ``zkmpc_tpu/ops/pallas_fp.py`` (`_mont_kernel`, built by
`_mont_call`, called by `mont_mul_pallas`).  ``mont_mul`` launches the CUDA
kernel ``csrc/mont_mul.cu`` for CUDA tensors, one thread per field element,
at every batch size; for CPU tensors it runs ``mont_mul_plain``, the same
limb algorithm in PyTorch ops.  Both give limbs bit-identical to the
reference's XLA path: Horner/schoolbook columns split into low-15 and high
parts, two relaxed carry passes, m = T·p' mod R from the low half,
u = (T + m·p)/R, and the carry-out fix-up.

Contract (same as `limbs._mont_mul_limbs`): a, b int64 limbs ``[..., n]``,
each limb <= B+1, value bounds c1·c2·p <= R/2; b may be one 1-D ``[n]``
constant.  Output ``[..., n]`` < 2p with limbs <= B.
"""

from __future__ import annotations

import torch

from . import build as K
from .limbs import FieldSpec, _conv_cols, _resolve2

_I64 = torch.int64

# NLIMBS values the kernel is instantiated for (FR/EDFR, FQ, MNT4Q)
KERNEL_NLIMBS = (18, 26, 51)


def mont_mul_plain(spec: FieldSpec, a, b):
    """REDC(a*b) in plain PyTorch int64 ops (any device)."""
    n = spec.nlimbs
    t_cols = _conv_cols(a, b)                           # [..., 2n]
    t = _resolve2(t_cols)                               # [..., 2n+1]
    pprime = spec.const("pprime_limbs", t.device)
    m = _resolve2(_conv_cols(t[..., :n], pprime, nout=n))[..., :n]
    u_cols = _conv_cols(m, spec.const("p_limbs", t.device)) + t_cols
    u = _resolve2(u_cols)                               # [..., 2n+1]
    # low half is 0 or exactly R; carry-out = 1 iff any low limb nonzero
    carry = (u[..., :n].amax(dim=-1) > 0).to(_I64)
    res = u[..., n:2 * n].clone()
    res[..., 0] += carry
    return res


def _kernel_consts(spec: FieldSpec, device):
    key = ("mont_consts", str(device))
    t = spec._dev.get(key)
    if t is None:
        t = torch.cat([spec.const("p_limbs", device),
                       spec.const("pprime_limbs", device)])
        spec._dev[key] = t
    return t


def mont_mul_cuda(spec: FieldSpec, a, b):
    """Launch K1 on CUDA tensors; raises on anything the kernel does not take."""
    n = spec.nlimbs
    if n not in KERNEL_NLIMBS:
        raise ValueError(f"mont_mul kernel has no {n}-limb instance")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("mont_mul_cuda needs both operands on one CUDA device")
    if a.dtype != _I64 or b.dtype != _I64:
        raise TypeError("limb tensors must be int64")
    if a.shape[-1] != n or b.shape[-1] != n:
        raise ValueError(f"limb axis must have {n} limbs")
    b_const = b.dim() == 1
    if a.dim() == 1 and not b_const:
        a, b = b, a
        b_const = True
    batch = torch.broadcast_shapes(a.shape[:-1], () if b_const else b.shape[:-1])
    a = a.expand(batch + (n,)).contiguous()
    b = b.contiguous() if b_const else b.expand(batch + (n,)).contiguous()
    out = torch.empty(batch + (n,), dtype=_I64, device=a.device)
    size = out.numel() // n
    if size == 0:
        return out
    lib = K.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.zk_mont_mul(n, a.data_ptr(), b.data_ptr(), int(b_const),
                         out.data_ptr(), _kernel_consts(spec, a.device).data_ptr(),
                         size, stream)
    K.check(rc, "mont_mul")
    K.LAUNCHES["mont_mul"] += 1
    return out


def mont_mul(spec: FieldSpec, a, b):
    """K1 wrapper: the plain twin for CPU tensors, the kernel for CUDA ones."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    return mont_mul_cuda(spec, a, b)
