"""MyCircuit and MySimpleCircuit (the reference's `src/circuits/circuit.rs`).

Port of ``zkmpc_tpu/circuits/my_circuit.py``.  MySimpleCircuit: a * b = c
with c public (the reference repeats the constraint 6 times for sizing,
`circuit.rs:95-126`).  MyCircuit: a * b = c plus Pedersen-commitment
sub-circuits binding a and b to their published commitments
(`circuit.rs:27-93`), the online binary's workload
(`examples/online.rs:211-297`).  Wires and constraints come in the
reference's order, so the matrices equal the JAX package's.
"""

from __future__ import annotations

from ..mpc import bits as B
from ..mpc.share import MpcFp
from ..snark.gadgets import Boolean, FpVar
from ..snark.r1cs import ConstraintSystem
from .pedersen_gadget import pedersen_com_circuit


def build_simple(cs: ConstraintSystem, a: MpcFp, b: MpcFp, c_pub: int, repeat: int = 6):
    av = FpVar.new_witness(cs, a)
    bv = FpVar.new_witness(cs, b)
    cv = FpVar.new_input(cs, MpcFp.const(cs.spec, c_pub))
    for _ in range(repeat):
        av.mul_equals(bv, cv)
    return cs


def build(cs: ConstraintSystem, a_iwc, b_iwc, c_pub: int, pp, generator,
          com_nbits: int | None = None):
    """a_iwc, b_iwc: `inputs.InputWithCommit` (shared scalar, randomness
    bits, public commitment); ``generator``: the torch.Generator of the
    bit protocols' draws."""
    av = FpVar.new_witness(cs, a_iwc.input)
    bv = FpVar.new_witness(cs, b_iwc.input)
    cv = FpVar.new_input(cs, MpcFp.const(cs.spec, c_pub))
    av.mul_equals(bv, cv)
    for iwc, var in ((a_iwc, av), (b_iwc, bv)):
        r_bools = [Boolean.new_witness(cs, B._index_last(iwc.randomness_bits, i))
                   for i in range(iwc.randomness_bits.shape[-1])]
        pedersen_com_circuit(cs, var, r_bools, iwc.commitment, pp, generator,
                             nbits=com_nbits)
    return cs
