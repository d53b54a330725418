"""Randomness helpers: batched uniform field elements from a torch.Generator.

Port of ``zkmpc_tpu/mpc/rand.py``.  The bits come from an explicit
``torch.Generator`` (JAX's threefry bits cannot be reproduced in torch), or
are injected: ``uniform_fp(..., bits=(hi, lo))`` takes the two raw 32-bit
draws ``[..., nlimbs]`` the reference's ``_raw_half_range`` would draw, so
a test gets the reference's field elements bit for bit.  `coin_toss` is
the parties' commit-then-open toss for public randomness no party can
predict (the MAC checks' weights).
"""

from __future__ import annotations

import hashlib
import secrets

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
    """Raw 15-bit limb draws [*shape, nlimbs] from ``generator``, made on
    the generator's device."""
    return torch.randint(0, 1 << W, tuple(shape) + (spec.nlimbs,),
                         generator=generator, dtype=_I64, device=generator.device)


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


def _commitment(party: int, seed: bytes) -> bytes:
    return hashlib.sha256(bytes([party]) + seed).digest()


def coin_toss(transport, seeds=None, openings=None) -> int:
    """A public 63-bit seed no party can predict or bias alone: a
    commit-then-open coin toss.  Each party draws a private 32-byte seed
    from its own entropy source (``seeds``: injected, one per party) and
    broadcasts its hash commitment; once every commitment is in, each
    opens its seed (``openings``: what each party opens, by default its
    seed).  Every party checks every opening against its commitment, and
    the result is a hash of all the seeds.  One round of commitments and
    one of openings through the transport, so its `CommStats` counts
    them.  A process draws, commits and opens only the seeds of the parties
    it plays (its rows), on tensors [rows, P, 32]."""
    n = transport.n_parties
    ids = transport.row_ids
    if seeds is None:
        seeds = {i: secrets.token_bytes(32) for i in ids}
    openings = seeds if openings is None else openings

    def tensor(rows):
        return torch.tensor([list(r) for r in rows], dtype=torch.uint8,
                            device=transport.device)
    seen = transport.all_gather(tensor(_commitment(i, seeds[i]) for i in ids))
    opened = transport.all_gather(tensor(openings[i] for i in ids)).cpu().numpy()
    seen = seen.cpu().numpy()                                   # [holder, party, 32]
    for holder in range(len(ids)):
        for i in range(n):
            if _commitment(i, opened[holder, i].tobytes()) != seen[holder, i].tobytes():
                raise AssertionError(f"coin toss: party {i}'s opening does not match "
                                     f"its commitment")
    digest = hashlib.sha256(b"".join(opened[0, i].tobytes() for i in range(n))).digest()
    return int.from_bytes(digest[:8], "little") >> 1
