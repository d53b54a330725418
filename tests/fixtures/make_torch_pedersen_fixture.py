"""Writes ``torch_pedersen_4b_3p.npz``: two circuits synthesized by the JAX
package at 3 parties, in a jax-free form that the PyTorch port's Pedersen
and gadget tests load.

- ``pedersen``: the PedersenComCircuit at 4 message bits and 4 randomness
  bits, the circuit ``zkmpc_tpu_torch.snark.driver`` builds at ``nbits=4``:
  ``PedersenParams.sample(7)``, m and r its values cut to 4 bits (m = 5,
  r = 10), the leader dealing m and the bits of r.  Eight bits take
  the windowed-lookup and Edwards-tree path of the full circuit.
- ``gadgets``: `gadget_circuit` below, FpVar arithmetic, ``to_bits``,
  ``is_zero``, ``two_bit_lookup``, ``conditionally_select``, ``enforce_cmp``,
  the Boolean ops, the batched forms (``mul_many``, ``matmul_gadget``,
  ``to_bits_many``, ``is_zero_many``, ``less_than_many``), the two-to-one
  Pedersen CRH gadget, ``TEAffineVar.scalar_mul_le`` and a 3-bit
  commitment (the window path below 8 bits) over shared a = 3, b = 5 and a
  public 7.

Per circuit the file holds, as JSON of plain ints: the R1CS (A, B, C), each
as [rows, cols, coeffs]; the instance values (the leading 1 included); the
opened full assignment [1, instance, witness]; and the counts.  The opened
values do not depend on the protocols' random draws.

Run from the repository root (several minutes on a CPU: the JAX package
synthesizes eagerly):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_pedersen_fixture.py
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

NBITS = 4
N_PARTIES = 3
M_INT = 123456789 % (1 << NBITS)
R_INT = 0x5A5A5A5A5A % (1 << NBITS)
A_INT, B_INT, C_INT = 3, 5, 7
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_pedersen_4b_3p.npz")
CIRCUITS = ("pedersen", "gadgets")


def gadget_circuit(pkg, cs, a, b, c, rnd):
    """The gadget case, written once for either package: ``pkg`` its name
    (``zkmpc_tpu`` or ``zkmpc_tpu_torch``), a and b shared wires of A_INT
    and B_INT, c a public wire of C_INT, ``rnd`` a JAX key or a
    torch.Generator.  Returns the outputs of the batched forms and of the
    scalar forms on the same wires, by gadget name: {name: [FpVar]}."""
    G = importlib.import_module(f"{pkg}.snark.gadgets")
    PG = importlib.import_module(f"{pkg}.circuits.pedersen_gadget")
    PD = importlib.import_module(f"{pkg}.crypto.pedersen")
    SC = importlib.import_module(f"{pkg}.spec.curves")
    FpVar, Boolean = G.FpVar, G.Boolean
    x = FpVar.new_witness(cs, a)
    y = FpVar.new_witness(cs, b)
    k = FpVar.new_input(cs, c)
    s = 4 + (x + y) - k.scale(2)                        # -2
    prod = x * y
    prod.enforce_equal(FpVar.constant(cs, A_INT * B_INT))
    ((-x).square() + s).enforce_equal(FpVar.constant(cs, 7))
    x.mul_equals(y, prod)
    bits = x.to_bits(rnd, NBITS)                        # 3 = 1100
    z = (x - A_INT).is_zero(rnd)                        # 1
    nz = y.is_zero(rnd)                                 # 0
    look = G.two_bit_lookup(bits[:2], [10, 20, 30, 40])      # 40
    FpVar.conditionally_select(z, look, y).enforce_equal(FpVar.constant(cs, 40))
    FpVar.conditionally_select(nz, look, y).enforce_equal(y)
    x.enforce_cmp(y, rnd)                               # 3 < 5
    y.enforce_cmp(y, rnd, allow_equal=True)
    Boolean.kary_and([Boolean.or_(z, nz), Boolean.xor(z, nz), bits[0],
                      Boolean.and_(nz.not_(), bits[1])]).enforce_true()
    Boolean.constant(cs, False).enforce_false()
    # the batched forms
    p1, _ = G.mul_many([(x, y), (y, k)])                # 15, 35
    p1.enforce_equal(prod)
    mm = G.matmul_gadget([[x, y]], [[y], [k]])[0][0]    # 3*5 + 5*7
    mm.enforce_equal(FpVar.constant(cs, 50))
    bx, by = G.to_bits_many([x, y], rnd, NBITS)         # 1100, 1010
    zs = G.is_zero_many([x - A_INT, y], rnd)            # 1, 0
    lts = G.less_than_many([(x, y), (y, x)], rnd)       # 1, 0
    Boolean.kary_and([zs[0], zs[1].not_(), lts[0], lts[1].not_(), by[2]]).enforce_true()
    out = {"mul_many": [p1], "mul": [prod], "matmul": [mm],
           "to_bits_many": [v.var for v in bx + by], "to_bits": [v.var for v in bits],
           "is_zero_many": [v.var for v in zs], "is_zero": [z.var, nz.var],
           "less_than_many": [v.var for v in lts]}
    # the two-to-one CRH over shared bits, then a variable-base product
    cp = PD.CrhParams.sample(4)
    h = PG.pedersen_two_to_one_crh_gadget(cs, bx[:2], by[:2], cp)
    hv = PD.crh_public_ints(cp, [1, 1, 1, 0])
    h.enforce_equal(PG.TEAffineVar.constant(cs, hv))
    h.scalar_mul_le(bx[:2]).enforce_equal(
        PG.TEAffineVar.constant(cs, SC.te_scalar_mul(hv, 3)))
    # a commitment below 8 bits: one 2-bit window and an odd bit's add
    pp = PD.PedersenParams.sample(7)
    PG.pedersen_commit_gadget(cs, bx[:2], by[:1], pp).enforce_equal(
        PG.TEAffineVar.constant(cs, PD.commit_public_ints(pp, 3, 1)))
    return out


def record(cs, opened) -> dict:
    """One circuit's arrays: matrices, instance, opened assignment, counts
    (``opened``: the opened full assignment as host ints)."""
    mats = [[r.tolist(), c.tolist(), [int(v) for v in k]] for r, c, k in cs.matrices()]
    return {
        "matrices": mats,
        "instance": [int(v) for v in cs.instance_ints()],
        "assignment": [int(v) for v in opened],
        "counts": {"num_instance": cs.num_instance, "num_witness": cs.num_witness,
                   "constraints": len(cs.constraints)},
    }


def generate() -> dict:
    """Synthesize both circuits with the JAX package; returns the npz arrays."""
    import jax

    from zkmpc_tpu.circuits.pedersen_gadget import pedersen_com_circuit
    from zkmpc_tpu.crypto import pedersen as PD
    from zkmpc_tpu.mpc import bits as B
    from zkmpc_tpu.mpc.share import MpcContext, MpcFp, king_share, mpc_scope
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu.snark import gadgets
    from zkmpc_tpu.snark.r1cs import ConstraintSystem

    def fr(v):
        return FpArray.from_int(FR, np.asarray(v, dtype=object))

    out = {}
    pp = PD.PedersenParams.sample(7)
    com = PD.commit_public_ints(pp, M_INT, R_INT)
    with mpc_scope(MpcContext(StackedTransport(N_PARTIES), backend="semi")):
        cs = ConstraintSystem(FR)
        x = king_share(fr(M_INT), jax.random.PRNGKey(3))
        rb = king_share(fr([(R_INT >> i) & 1 for i in range(NBITS)]),
                        jax.random.PRNGKey(4))
        xv = gadgets.FpVar.new_witness(cs, x)
        r_bools = [gadgets.Boolean.new_witness(cs, B._index_last(rb, i))
                   for i in range(NBITS)]
        pedersen_com_circuit(cs, xv, r_bools, com, pp, jax.random.PRNGKey(5),
                             nbits=NBITS)
        assert cs.is_satisfied_ints()
        out["pedersen"] = record(cs, np.asarray(cs.full_assignment().reveal().to_ints())[0])

        cs = ConstraintSystem(FR)
        gadget_circuit("zkmpc_tpu", cs, king_share(fr(A_INT), jax.random.PRNGKey(6)),
                       king_share(fr(B_INT), jax.random.PRNGKey(7)),
                       MpcFp.const(FR, C_INT), jax.random.PRNGKey(8))
        assert cs.is_satisfied_ints()
        out["gadgets"] = record(cs, np.asarray(cs.full_assignment().reveal().to_ints())[0])
    return {f"{name}_json": np.asarray(json.dumps(v)) for name, v in out.items()}


def load(arrays) -> dict:
    """npz arrays -> {circuit name: {"matrices", "instance", "assignment",
    "counts"}}."""
    return {name: json.loads(str(arrays[f"{name}_json"])) for name in CIRCUITS}


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
