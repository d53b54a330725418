"""Pedersen commitment and CRH over ed-on-bls12-377, MPC-capable.

Port of ``zkmpc_tpu/crypto/pedersen.py``: a shared field element is
committed by MPC bit-decomposing it and folding the bits into per-bit
generators, plus randomness bits times powers of a blinding generator, all
over shared-coordinate TE points (a handful of batched Beaver rounds).

C(m, r) = sum_i m_i * G_i + sum_j r_j * (2^j * H)

The generators come from Python's ``random.Random(seed)``, as in the
reference, so both packages derive the same points from a seed.
"""

from __future__ import annotations

import dataclasses
import functools
import random

import numpy as np

from .. import params
from ..mpc import bits as B
from ..mpc import te as TE
from ..mpc.share import MpcFp
from ..spec import curves as SC

NBITS = params.FR_MODULUS.bit_length()


def _sample_points(rng: random.Random, n: int) -> list:
    return [SC.te_scalar_mul(SC.TE_GEN, rng.randrange(1, params.ED_FR_MODULUS))
            for _ in range(n)]


def _xs_ys(points):
    return (np.asarray([g[0] for g in points], dtype=object),
            np.asarray([g[1] for g in points], dtype=object))


@dataclasses.dataclass
class PedersenParams:
    generators: list          # NBITS affine points (message bit bases)
    blind_base: tuple         # H (randomness base)

    @classmethod
    def sample(cls, seed: int = 0):
        """Derive the generators deterministically: G_i = k_i * G with k_i
        drawn from ``random.Random(seed)`` (derived once per seed: some
        seconds of Python integer arithmetic)."""
        gens, blind = _sampled(seed)
        return cls(list(gens), blind)


@functools.lru_cache(maxsize=None)
def _sampled(seed: int):
    rng = random.Random(seed)
    gens = _sample_points(rng, NBITS)
    return tuple(gens), _sample_points(rng, 1)[0]


def commit(pp: PedersenParams, m: MpcFp, r_bits: MpcFp, generator) -> TE.MpcTEPoint:
    """Commit shared scalar(s) m [..] with shared randomness bits
    r_bits [.., nbits].  Returns a shared-coordinate TE point batch [..]."""
    m_bits = B.bit_decomposition(m, generator)            # [.., NBITS]
    msg_sum = TE.tree_sum(TE.select_base(m_bits, _xs_ys(pp.generators)))
    return msg_sum.add(TE.scalar_mul_bits(pp.blind_base, r_bits))


def commit_bits(pp: PedersenParams, m_bits: MpcFp, r_bits: MpcFp) -> TE.MpcTEPoint:
    """Commit already bit-decomposed shared bits (no decomposition round)."""
    gens = pp.generators[:m_bits.shape[-1]]
    msg_sum = TE.tree_sum(TE.select_base(m_bits, _xs_ys(gens)))
    return msg_sum.add(TE.scalar_mul_bits(pp.blind_base, r_bits))


def commit_public_ints(pp: PedersenParams, m_int: int, r_int: int):
    """Host oracle: the same commitment over plain ints (spec backend)."""
    acc = SC.TE_NEUTRAL
    for i in range(NBITS):
        if (m_int >> i) & 1:
            acc = SC.te_add(acc, pp.generators[i])
    h = pp.blind_base
    r = r_int
    while r:
        if r & 1:
            acc = SC.te_add(acc, h)
        h = SC.te_add(h, h)
        r >>= 1
    return acc


@dataclasses.dataclass
class CrhParams:
    """Pedersen CRH: the same bit structure, no blinding."""
    generators: list

    @classmethod
    def sample(cls, input_bits: int, seed: int = 1):
        return cls(_sample_points(random.Random(seed), input_bits))


def crh(cp: CrhParams, in_bits: MpcFp) -> TE.MpcTEPoint:
    gens = cp.generators[:in_bits.shape[-1]]
    return TE.tree_sum(TE.select_base(in_bits, _xs_ys(gens)))


def two_to_one_crh(cp: CrhParams, left_bits: MpcFp,
                   right_bits: MpcFp) -> TE.MpcTEPoint:
    """TwoToOneCRH: hash two equal-length bit strings into one point, the
    CRH of their concatenation."""
    assert left_bits.shape[-1] == right_bits.shape[-1], \
        "left and right input should be of equal length"
    return crh(cp, MpcFp.concat([left_bits, right_bits],
                                axis=len(left_bits.shape) - 1))


def crh_public_ints(cp: CrhParams, bit_ints) -> tuple:
    """Host oracle: the Pedersen CRH over plain 0/1 ints."""
    acc = SC.TE_NEUTRAL
    for i, b in enumerate(bit_ints):
        if b:
            acc = SC.te_add(acc, cp.generators[i])
    return acc
