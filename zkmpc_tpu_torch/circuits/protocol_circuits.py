"""MPC-native protocol circuits.

Port of ``zkmpc_tpu/circuits/protocol_circuits.py`` (the reference's
`src/circuits/{equality_zero,bit_decomposition,smaller_than,
enforce_smaller_or_eq_than}.rs`): each synthesizes identically over public
wires (local proving) or shared wires (collaborative proving), because the
gadget layer runs the MPC protocol inside witness allocation.  Where the
JAX package takes a key, these take a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np

from ..mpc import bits as B
from ..mpc.share import PUBLIC, SHARED, MpcFp
from ..snark.gadgets import Boolean, FpVar, less_than_gadget
from ..snark.r1cs import ConstraintSystem


def equality_zero_circuit(cs: ConstraintSystem, a: MpcFp, generator):
    """`EqualityZeroCircuit` (`equality_zero.rs:19-41`): witness a; enforce
    that [a == 0] is true."""
    FpVar.new_witness(cs, a).is_zero(generator).enforce_true()
    return cs


def not_equality_zero_circuit(cs: ConstraintSystem, a: MpcFp, generator):
    """`NotEqualityZeroCircuit` (`equality_zero.rs:43-81`): the is-zero bit is
    computed by the MPC equality-zero protocol, opened, and allocated as a
    public instance wire; the circuit proves that the in-circuit is_zero
    agrees with the published bit."""
    a_var = FpVar.new_witness(cs, a)
    if a.visibility == SHARED:
        opened = MpcFp(B.equality_zero(a, generator).reveal(), PUBLIC)
    else:
        opened = _is_zero_pub(a)
    is_zero_pub = FpVar.new_input(cs, opened)
    a_var.is_zero(generator).var.enforce_equal(is_zero_pub)
    return cs


def _is_zero_pub(a: MpcFp) -> MpcFp:
    v = int(np.asarray(a.value.to_ints()).reshape(-1)[0])
    return MpcFp.const(a.spec, int(v == 0))


def bit_decomposition_circuit(cs: ConstraintSystem, a: MpcFp, generator):
    """`BitDecompositionCircuit` (`bit_decomposition.rs:11-33`): witness a,
    constrain its full little-endian bit decomposition."""
    FpVar.new_witness(cs, a).to_bits(generator)
    return cs


def smaller_than_circuit(cs: ConstraintSystem, a: MpcFp, b: MpcFp, res: MpcFp,
                         generator, check_eq: bool = False):
    """`SmallerThanCircuit` (`smaller_than.rs:19-51`): witnesses a, b and a
    claimed comparison bit res; enforce res == [a < b] (or [a <= b])."""
    a_var = FpVar.new_witness(cs, a)
    b_var = FpVar.new_witness(cs, b)
    res_var = Boolean.new_witness(cs, res)
    lt = less_than_gadget(a_var, b_var, generator)
    if check_eq:
        lt = Boolean.or_(lt, a_var.is_eq(b_var, generator))
    res_var.var.enforce_equal(lt.var)
    return cs


def smaller_eq_than_circuit(cs: ConstraintSystem, a_bits: MpcFp, b_int: int):
    """`SmallerEqThanCircuit` (`enforce_smaller_or_eq_than.rs:12-43`): witness
    a bit vector a (LSB first), enforce value(a) <= b for the public b."""
    enforce_smaller_or_equal_than_le(cs, Boolean.new_witness_vec(cs, a_bits), b_int)
    return cs


def enforce_smaller_or_equal_than_le(cs: ConstraintSystem, bits: list, element: int):
    """ark-r1cs-std `Boolean::enforce_smaller_or_equal_than_le` semantics
    (run-of-ones k-ary AND / NAND chain) over MPC Booleans.

    bits: LSB-first Booleans; element: the public bound."""
    nbits = element.bit_length()
    # bits above the bound's MSB must be zero
    if len(bits) > nbits:
        or_acc = Boolean.constant(cs, False)
        for extra in bits[nbits:]:
            or_acc = Boolean.or_(or_acc, extra)
        or_acc.enforce_false()
    last_run = Boolean.constant(cs, True)
    current_run: list = []
    # big-endian walk over the bound's significant bits
    for i in range(nbits - 1, -1, -1):
        a = bits[i]
        if (element >> i) & 1:
            current_run.append(a)
        else:
            if current_run:
                current_run.append(last_run)
                last_run = Boolean.kary_and(current_run)
                current_run = []
            # NAND(last_run, a): their AND must be 0
            Boolean.and_(last_run, a).enforce_false()
    return current_run
