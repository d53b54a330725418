"""MySecretInputCircuit: a range-checked, committed secret input.

Port of ``zkmpc_tpu/circuits/input_circuit.py`` (the reference's
`src/circuits/input_circuit.rs:10-82`, driven by `src/main.rs`): knowledge
of a secret x with lower <= x < upper (two `enforce_cmp`) whose Pedersen
commitment, over the 253 bits of x and n_r_bits randomness bits, is a
public point.  Wires are allocated in the reference's order, so the R1CS
matrices equal the JAX package's.
"""

from __future__ import annotations

from ..crypto import pedersen
from ..mpc import bits as B
from ..mpc.share import MpcFp
from ..ops.limbs import FR
from ..snark.gadgets import Boolean, FpVar
from ..snark.r1cs import ConstraintSystem
from .pedersen_gadget import pedersen_commit_gadget


def build(cs: ConstraintSystem, x_wire: MpcFp, r_bits_wire: MpcFp,
          commitment_xy, pp: pedersen.PedersenParams, lower: int, upper: int,
          generator, n_r_bits: int = 16):
    """Synthesize the circuit.

    - x_wire: shared scalar (the secret input)
    - r_bits_wire: shared randomness bits [n_r_bits]
    - commitment_xy: public affine TE point (the commitment), instance input
    - generator: the torch.Generator of the MPC protocols' draws
    """
    x = FpVar.new_witness(cs, x_wire)

    # range check: lower <= x < upper
    lo = FpVar.constant(cs, lower)
    hi = FpVar.constant(cs, upper)
    lo.enforce_cmp(x, generator, allow_equal=True)
    x.enforce_cmp(hi, generator, allow_equal=False)

    # commitment: bits of x and r folded against the Pedersen bases
    m_bits = x.to_bits(generator)
    r_bools = [Boolean.new_witness(cs, B._index_last(r_bits_wire, i))
               for i in range(n_r_bits)]
    com = pedersen_commit_gadget(cs, m_bits, r_bools, pp)

    cx = FpVar.new_input(cs, MpcFp.const(FR, int(commitment_xy[0])))
    cy = FpVar.new_input(cs, MpcFp.const(FR, int(commitment_xy[1])))
    com.x.enforce_equal(cx)
    com.y.enforce_equal(cy)
    return cs
