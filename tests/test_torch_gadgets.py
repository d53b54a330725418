"""The port's R1CS gadgets (`zkmpc_tpu_torch.snark.gadgets`) against the JAX
package: FpVar arithmetic, ``to_bits``, ``is_zero``, ``two_bit_lookup``,
``conditionally_select``, ``enforce_cmp`` (through ``less_than_gadget``),
the Boolean ops, the batched forms, and the CRH and variable-base
scalar-product gadgets of `circuits/pedersen_gadget.py`, in one circuit
written once for both packages
(`fixtures/make_torch_pedersen_fixture.gadget_circuit`), synthesized once
for the module, its bit protocols at one candidate
(`torch_parity.fewer_attempts(1)`: what the circuit holds does not depend
on them).  Its matrices, instance
and opened assignment must equal those the JAX package wrote to the
fixture; `test_torch_pedersen.py` regenerates it live (`slow`).
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_pedersen_fixture as PF
from torch_parity import CPU, check_circuit, fewer_attempts
from zkmpc_tpu_torch.mpc.share import MpcContext, MpcFp, king_share, mpc_scope
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem

torch.set_num_threads(1)


def _scope():
    return mpc_scope(MpcContext(StackedTransport(PF.N_PARTIES, CPU), "semi"))


def port_gadget_cs(outputs=None):
    """The gadget circuit through the port; ``outputs``: a dict that
    receives `gadget_circuit`'s wires by gadget name."""
    gen = torch.Generator().manual_seed(1)
    with fewer_attempts(1), _scope():
        cs = ConstraintSystem(FR)

        def shared(v):
            return king_share(FpArray.from_int(FR, v, device=CPU), gen)
        out = PF.gadget_circuit("zkmpc_tpu_torch", cs, shared(PF.A_INT), shared(PF.B_INT),
                                MpcFp.const(FR, PF.C_INT), gen)
    if outputs is not None:
        outputs.update(out)
    return cs


@pytest.fixture(scope="module")
def gadget_cs():
    outputs = {}
    return port_gadget_cs(outputs), outputs


def test_gadget_circuit_matches_reference(gadget_cs):
    check_circuit(gadget_cs[0], PF.load(np.load(PF.PATH))["gadgets"])


def test_batched_gadgets_open_like_scalar_ones(gadget_cs):
    """mul_many, matmul_gadget, to_bits_many, is_zero_many and
    less_than_many open to the values of their scalar forms on the same
    wires, zero and nonzero (x - 3 and y), and to the host ints (their
    matrices are held against the JAX package's in
    `test_gadget_circuit_matches_reference`)."""
    _, out = gadget_cs
    x, y, k = PF.A_INT, PF.B_INT, PF.C_INT
    with _scope():
        opened = {name: [int(v.value.reveal().to_ints()[0]) for v in wires]
                  for name, wires in out.items()}
    bits = [(x >> i) & 1 for i in range(PF.NBITS)]
    assert opened["mul_many"] == opened["mul"] == [x * y]
    assert opened["matmul"] == [x * y + y * k]
    assert opened["to_bits_many"][:PF.NBITS] == opened["to_bits"] == bits
    assert opened["to_bits_many"][PF.NBITS:] == [(y >> i) & 1 for i in range(PF.NBITS)]
    assert opened["is_zero_many"] == opened["is_zero"] == [1, 0]
    assert opened["less_than_many"] == [int(x < y), int(y < x)]


def test_gadget_system_is_satisfied(gadget_cs):
    """The opened assignment of the whole gadget circuit satisfies its
    system."""
    with _scope():
        assert gadget_cs[0].is_satisfied_ints()
