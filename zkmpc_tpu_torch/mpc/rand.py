"""Randomness helpers: batched uniform field elements from a torch.Generator.

Port of ``zkmpc_tpu/mpc/rand.py``.  The bits come from an explicit
``torch.Generator`` (JAX's threefry bits cannot be reproduced in torch), or
are injected: ``uniform_fp(..., bits=(hi, lo))`` takes the two raw 32-bit
draws ``[..., nlimbs]`` the reference's ``_raw_half_range`` would draw, so
a test gets the reference's field elements bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.limbs import MASK, W, FieldSpec, FpArray

_I64 = torch.int64


def _raw_half_range(raw, spec: FieldSpec) -> FpArray:
    """Raw draws -> value uniform over [0, 2^b), b = 15*nlimbs - 1 (top bit
    cleared so the value is < R/2, inside every op's bound budget)."""
    limbs = raw & MASK
    limbs[..., -1] &= MASK >> 1
    return FpArray(limbs, spec, spec.mul_bound_budget).tighten()


def draw_bits(generator: torch.Generator, spec: FieldSpec, shape):
    """Raw 15-bit limb draws [*shape, nlimbs] from ``generator`` (CPU)."""
    return torch.randint(0, 1 << W, tuple(shape) + (spec.nlimbs,),
                         generator=generator, dtype=_I64)


def uniform_fp(generator, spec: FieldSpec, shape=(), device="cuda",
               bits=None) -> FpArray:
    """Uniform field elements (Montgomery domain) with negligible bias.

    Double-width sampling: X = hi * 2^b + lo uniform over [0, 2^{2b}) with
    b = 15*nlimbs - 1 >= |p|, reduced mod p with one Montgomery multiply by
    repr(2^b).  ``bits``: optional injected (hi, lo) raw draws."""
    if bits is None:
        bits = (draw_bits(generator, spec, shape), draw_bits(generator, spec, shape))
    hi_raw, lo_raw = (torch.as_tensor(b, dtype=_I64).to(device).clone()
                      for b in bits)
    hi = _raw_half_range(hi_raw, spec)
    lo = _raw_half_range(lo_raw, spec)
    kconst = FpArray.from_int(spec, pow(2, W * spec.nlimbs - 1, spec.p),
                              device=device)
    return hi * kconst.broadcast_to(hi.shape) + lo
