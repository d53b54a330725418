"""The port's R1CS gadgets (`zkmpc_tpu_torch.snark.gadgets`) against the JAX
package: FpVar arithmetic, ``to_bits``, ``is_zero``, ``two_bit_lookup``,
``conditionally_select``, ``enforce_cmp`` (through ``less_than_gadget``),
the Boolean ops, the batched forms, and the CRH and variable-base
scalar-product gadgets of `circuits/pedersen_gadget.py`, in one circuit
written once for both packages
(`fixtures/make_torch_pedersen_fixture.gadget_circuit`).  Its matrices,
instance and opened assignment must equal those the JAX package wrote to
the fixture; `test_torch_pedersen.py` regenerates it live (`slow`).
"""

import numpy as np
import torch

from fixtures import make_torch_pedersen_fixture as PF
from torch_parity import CPU, check_circuit
from zkmpc_tpu_torch.mpc.share import MpcContext, MpcFp, king_share, mpc_scope
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.snark import gadgets
from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem

torch.set_num_threads(1)


def port_gadget_cs():
    gen = torch.Generator().manual_seed(1)
    with mpc_scope(MpcContext(StackedTransport(PF.N_PARTIES, CPU), "semi")):
        cs = ConstraintSystem(FR)

        def shared(v):
            return king_share(FpArray.from_int(FR, v, device=CPU), gen)
        PF.gadget_circuit("zkmpc_tpu_torch", cs, shared(PF.A_INT), shared(PF.B_INT),
                          MpcFp.const(FR, PF.C_INT), gen)
    return cs


def test_gadget_circuit_matches_reference():
    check_circuit(port_gadget_cs(), PF.load(np.load(PF.PATH))["gadgets"])


def test_batched_gadgets_open_like_scalar_ones():
    """mul_many, matmul_gadget, to_bits_many, is_zero_many and
    less_than_many open to the values of their scalar forms on zero and
    nonzero wires, and the system is satisfied (their matrices are held
    against the JAX package's in `test_gadget_circuit_matches_reference`)."""
    gen = torch.Generator().manual_seed(2)
    with mpc_scope(MpcContext(StackedTransport(PF.N_PARTIES, CPU), "semi")):
        cs = ConstraintSystem(FR)
        xs = [gadgets.FpVar.new_witness(cs, king_share(FpArray.from_int(FR, v, device=CPU),
                                                       gen)) for v in (0, 2, 3, 5)]
        prods = gadgets.mul_many([(xs[1], xs[2]), (xs[2], xs[3])])
        C = gadgets.matmul_gadget([[xs[1], xs[2]]], [[xs[2]], [xs[3]]])
        bits = gadgets.to_bits_many(xs[1:3], gen, nbits=3)
        zs = gadgets.is_zero_many(xs[:2], gen)
        lts = gadgets.less_than_many([(xs[1], xs[2]), (xs[3], xs[2])], gen)
        opened = [int(v.value.reveal().to_ints()[0]) for v in
                  prods + [C[0][0]] + [b.var for row in bits for b in row] +
                  [z.var for z in zs] + [lt.var for lt in lts]]
        assert cs.is_satisfied_ints()
    assert opened == [6, 15, 21, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0]
