"""Batched Montgomery multiplication: kernel K1 and its plain twin.

Port of ``zkmpc_tpu/ops/pallas_fp.py`` (`_mont_kernel`, built by
`_mont_call`, called by `mont_mul_pallas`).  ``mont_mul`` launches the CUDA
kernel ``csrc/mont_mul.cu`` for CUDA tensors and runs ``mont_mul_plain`` for
CPU tensors.

- ``mont_mul_plain`` keeps the reference's limb algorithm in PyTorch ops
  (Horner/schoolbook columns split into low-15 and high parts, two relaxed
  carry passes, m = T·p' mod R from the low half, u = (T + m·p)/R and the
  carry-out fix-up), so on the CPU the port's limbs equal the XLA path's.
- The kernel packs the limbs into 32-bit words and returns exactly
  REDC_R(a·b) (below 1.5p) as canonical 15-bit limbs (`csrc/mont.cuh`).
  The plain version's m need not be reduced below R, so the two agree
  modulo p and may differ by exactly p in some lanes: the same values, not
  the same limbs.  Every consumer of limbs compares values
  (`limbs._canonicalize_lt2p`).

Contract (same as `limbs._mont_mul_limbs`): a, b int64 limbs ``[..., n]``
that broadcast against each other, each limb <= B+1, value bounds
c1·c2·p <= R/2.  Output ``[..., n]`` < 2p with limbs <= B, a fresh
contiguous tensor.  The kernel reads strided and broadcast operands where
they lie; only an operand whose limb axis is not at stride 1, or whose batch
needs more than 4 dimensions, is copied first, counted as
``LAUNCHES["mont_mul_operand_copy"]``.

Each launch adds one to ``LAUNCHES["mont_mul"]`` and one to the count of
its width, ``LAUNCHES["mont_mul_n<limbs>"]`` (n18 for FR and EDFR, n26 for
FQ, n51 for MNT4Q, the SHE ciphertext ring).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build as K
from .limbs import FieldSpec, _conv_cols, _resolve2

_I64 = torch.int64

# NLIMBS values the kernel is instantiated for (FR/EDFR, FQ, MNT4Q)
KERNEL_NLIMBS = (18, 26, 51)
MAX_DIMS = 4            # batch dimensions the kernel takes (`Layout` in mont_mul.cu)
COPY_COUNT = "mont_mul_operand_copy"


#: rows of a plain product computed at once on a CPU: the column temporaries
#: of a chunk stay in the cache (a large batch runs about 1.5x faster), and
#: a triple batch of the `main` binary (49,152 rows of 51 limbs) needs some
#: 50 MiB of them instead of about 2 GiB
PLAIN_CHUNK = 1024


def mont_mul_plain(spec: FieldSpec, a, b):
    """REDC(a*b) in plain PyTorch int64 ops (any device).  On a CPU a large
    batch goes through in chunks of PLAIN_CHUNK rows (each row's limbs are
    computed alone, so the limbs are the same)."""
    if a.device.type == "cpu":
        n = spec.nlimbs
        batch = a.shape[:-1] if a.shape == b.shape else \
            torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        rows = math.prod(batch)
        if rows > PLAIN_CHUNK:
            a2 = a.expand(batch + (n,)).reshape(rows, n)
            b2 = b.expand(batch + (n,)).reshape(rows, n)
            return torch.cat([_mont_mul_rows(spec, a2[i:i + PLAIN_CHUNK],
                                             b2[i:i + PLAIN_CHUNK])
                              for i in range(0, rows, PLAIN_CHUNK)]).reshape(batch + (n,))
    return _mont_mul_rows(spec, a, b)


def _mont_mul_rows(spec: FieldSpec, a, b):
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


def kernel_shape(n: int):
    """(W, S) of the kernel at n limbs: R = 2^(15n) is W-1 words and S bits."""
    w = -(-15 * n // 32)
    return w, 15 * n - 32 * (w - 1)


def kernel_consts_list(spec: FieldSpec) -> list:
    """p as W 32-bit words (low word first), -p^-1 mod 2^32, -p^-1 mod 2^S."""
    w, s = kernel_shape(spec.nlimbs)
    p = spec.p
    return ([(p >> (32 * j)) & 0xFFFFFFFF for j in range(w)]
            + [-pow(p, -1, 1 << 32) % (1 << 32), -pow(p, -1, 1 << s) % (1 << s)])


def _kernel_consts(spec: FieldSpec):
    """`kernel_consts_list` as an int64 array in host memory (the C entry
    copies it into the kernel's parameters)."""
    c = spec._dev.get("mont_consts")
    if c is None:
        vals = kernel_consts_list(spec)
        c = (ctypes.c_int64 * len(vals))(*vals)
        spec._dev["mont_consts"] = c
    return c


def _layout(batch, a, b):
    """Merged batch dimensions of a and b (views expanded to ``batch``):
    [(size, a stride, b stride)], outermost first, or None past MAX_DIMS.
    Dimensions of size 1 go; neighbours merge where both operands step
    through them as through one."""
    dims = []
    for size, sa, sb in zip(batch, a.stride()[:-1], b.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == sa * size and dims[-1][2] == sb * size:
            dims[-1] = (dims[-1][0] * size, sa, sb)
        else:
            dims.append((size, sa, sb))
    if len(dims) > MAX_DIMS:
        return None
    return tuple(dims) or ((1, 0, 0),)


@functools.lru_cache(maxsize=4096)
def _layout_array(dims):
    """`_layout`'s dims as the C entry's int64 array in host memory."""
    pad = [0] * (MAX_DIMS - len(dims))
    vals = ([len(dims)] + [d[0] for d in dims] + pad + [d[1] for d in dims] + pad
            + [d[2] for d in dims] + pad)
    return (ctypes.c_int64 * len(vals))(*vals)


def _copied(x):
    K.LAUNCHES[COPY_COUNT] += 1
    return x.contiguous()


def kernel_operands(batch, a, b):
    """(a, b, dims) as the kernel takes them: views of a and b expanded to
    ``batch``, copied only where the limb axis is not at stride 1 or the
    merged layout has more than MAX_DIMS dimensions, and swapped so that a
    constant operand comes second (the kernel then reads it once a block)."""
    n = a.shape[-1]
    if a.stride(-1) != 1:
        a = _copied(a)
    if b.stride(-1) != 1:
        b = _copied(b)
    a, b = a.expand(batch + (n,)), b.expand(batch + (n,))
    dims = _layout(batch, a, b)
    if dims is None:
        a = _copied(a)
        dims = _layout(batch, a, b)
    if dims is None:
        b = _copied(b)
        dims = _layout(batch, a, b)
    if not any(d[1] for d in dims) and any(d[2] for d in dims):
        a, b = b, a
        dims = tuple((size, sb, sa) for size, sa, sb in dims)
    return a, b, dims


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
    # (broadcast_shapes costs microseconds of host time a call)
    batch = a.shape[:-1] if a.shape == b.shape else \
        torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.empty(batch + (n,), dtype=_I64, device=a.device)
    size = out.numel() // n
    if size == 0:
        return out
    if size >= 1 << 31:
        raise ValueError("mont_mul kernel takes fewer than 2^31 elements")
    a, b, dims = kernel_operands(batch, a, b)
    lib = K.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.zk_mont_mul(n, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         _kernel_consts(spec), _layout_array(dims), size, stream)
    K.check(rc, "mont_mul")
    K.LAUNCHES["mont_mul"] += 1
    K.LAUNCHES[f"mont_mul_n{n}"] += 1
    return out


def mont_mul(spec: FieldSpec, a, b):
    """K1 wrapper: the plain twin for CPU tensors, the kernel for CUDA ones."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    return mont_mul_cuda(spec, a, b)
