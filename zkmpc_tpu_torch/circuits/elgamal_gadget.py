"""In-circuit ElGamal encryption gadget.

Port of ``zkmpc_tpu/circuits/elgamal_gadget.py`` (the reference's
`ElGamalEncGadget`, `mpc-algebra/src/encryption/elgamal/constraints.rs`,
used by the werewolf DivinationCircuit): prove that a TE-point message
encrypted with randomness bits r yields the public ciphertext

    c1 = r * G,   c2 = M + r * PK

where G (generator) and PK are public instance points, M is a (possibly
shared) in-circuit point, and r's bits are witnesses.
"""

from __future__ import annotations

from ..mpc.share import MpcFp
from ..snark.gadgets import FpVar
from ..snark.r1cs import ConstraintSystem
from .pedersen_gadget import TEAffineVar


class ElGamalCiphertextVar:
    __slots__ = ("c1", "c2")

    def __init__(self, c1: TEAffineVar, c2: TEAffineVar):
        self.c1 = c1
        self.c2 = c2

    def enforce_equal(self, other: "ElGamalCiphertextVar"):
        self.c1.enforce_equal(other.c1)
        self.c2.enforce_equal(other.c2)


def alloc_public_point(cs: ConstraintSystem, xy) -> TEAffineVar:
    """Allocate an affine point as two public instance wires (the reference's
    `new_input` allocation of params, public key and ciphertext)."""
    return TEAffineVar(FpVar.new_input(cs, MpcFp.const(cs.spec, int(xy[0]))),
                       FpVar.new_input(cs, MpcFp.const(cs.spec, int(xy[1]))))


def encrypt_gadget(cs: ConstraintSystem, gen: TEAffineVar, pk: TEAffineVar,
                   msg: TEAffineVar, r_bits: list) -> ElGamalCiphertextVar:
    """(c1, c2) = (r*G, M + r*PK) with Boolean randomness bits (LSB first):
    two variable-base scalar ladders and one complete add
    (`constraints.rs` ElGamalEncGadget::encrypt)."""
    c1 = gen.scalar_mul_le(r_bits)
    s = pk.scalar_mul_le(r_bits)
    return ElGamalCiphertextVar(c1, msg.add(s))
