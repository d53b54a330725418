"""Writes ``torch_online_4b_3p.npz``: the online binary's MyCircuit
(``zkmpc_tpu/circuits/my_circuit.py``) synthesized by the JAX package at 3
parties and ``com_nbits=4``, in a jax-free form that the PyTorch port's
online tests load.

The inputs: a = 3 and b = 5 dealt by the leader, c = a * b public, their
randomness bits RA_INT and RB_INT (4 bits each, public, as in the online
binary) and the commitments ``commit_public_ints(PedersenParams.sample(0),
x, r)``.  The file holds, as JSON of plain ints
(``make_torch_pedersen_fixture.record``): the R1CS (A, B, C), the instance,
the opened full assignment and the counts.  None of them depends on the
protocols' random draws.

Run from the repository root (a few minutes on a CPU: the JAX package
synthesizes eagerly):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_online_fixture.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

NBITS = 4
N_PARTIES = 3
A_INT, B_INT = 3, 5
RA_INT, RB_INT = 0b1010, 0b0110
PP_SEED = 0
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_online_4b_3p.npz")


def generate() -> dict:
    """Synthesize MyCircuit with the JAX package; returns the npz arrays."""
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import make_torch_pedersen_fixture as PF
    from zkmpc_tpu import inputs as IN
    from zkmpc_tpu.circuits import my_circuit
    from zkmpc_tpu.crypto import pedersen
    from zkmpc_tpu.mpc.share import MpcContext, MpcFp, king_share, mpc_scope
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu.snark.r1cs import ConstraintSystem

    def fr(v):
        return FpArray.from_int(FR, np.asarray(v, dtype=object))
    pp = pedersen.PedersenParams.sample(PP_SEED)
    with mpc_scope(MpcContext(StackedTransport(N_PARTIES), backend="semi")):
        iwcs = [IN.InputWithCommit(
            i, king_share(fr(x), jax.random.PRNGKey(i)),
            MpcFp.const(FR, np.asarray([(r >> j) & 1 for j in range(NBITS)], dtype=object)),
            pedersen.commit_public_ints(pp, x, r))
            for i, (x, r) in enumerate(((A_INT, RA_INT), (B_INT, RB_INT)))]
        cs = ConstraintSystem(FR)
        my_circuit.build(cs, iwcs[0], iwcs[1], A_INT * B_INT, pp, jax.random.PRNGKey(8),
                         com_nbits=NBITS)
        assert cs.is_satisfied_ints()
        opened = np.asarray(cs.full_assignment().reveal().to_ints())[0]
        rec = PF.record(cs, opened)
    return {"my_circuit_json": np.asarray(json.dumps(rec))}


def load(arrays) -> dict:
    return json.loads(str(arrays["my_circuit_json"]))


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
