"""Curve ElGamal over ed-on-bls12-377, MPC-capable.

Port of ``zkmpc_tpu/crypto/elgamal.py`` (the reference's
`mpc-algebra/src/encryption/elgamal/elgamal.rs:50-119`): keygen sk,
pk = sk*G; encrypt(M, r) = (r*G, M + r*PK); decrypt(c1, c2) = c2 - sk*c1.
The MPC variant encrypts a shared message point with shared randomness
bits (the werewolf divination flow): both scalar muls are fixed-base over
shared bits.
"""

from __future__ import annotations

import dataclasses
import random as pyrandom

from .. import params
from ..mpc import te as TE
from ..mpc.share import MpcFp
from ..spec import curves as SC


@dataclasses.dataclass
class ElGamalKeys:
    sk: int                   # spec-side secret scalar
    pk: tuple                 # affine point


def keygen(seed: int = 0) -> ElGamalKeys:
    rng = pyrandom.Random(seed)
    sk = rng.randrange(1, params.ED_FR_MODULUS)
    return ElGamalKeys(sk, SC.te_scalar_mul(SC.TE_GEN, sk))


def encrypt_shared(pk: tuple, msg: TE.MpcTEPoint, r_bits: MpcFp):
    """(c1, c2) = (r*G, M + r*PK) with shared randomness bits and a
    shared-coordinate message point."""
    c1 = TE.scalar_mul_bits(SC.TE_GEN, r_bits)
    c2 = msg.add(TE.scalar_mul_bits(pk, r_bits))
    return c1, c2


def decrypt_ints(keys: ElGamalKeys, c1_xy: tuple, c2_xy: tuple) -> tuple:
    """Host decryption of an opened ciphertext: c2 - sk*c1."""
    return SC.te_add(c2_xy, SC.te_neg(SC.te_scalar_mul(c1_xy, keys.sk)))


def encrypt_ints(pk: tuple, msg_xy: tuple, r_int: int):
    """Spec oracle."""
    return (SC.te_scalar_mul(SC.TE_GEN, r_int),
            SC.te_add(msg_xy, SC.te_scalar_mul(pk, r_int)))
