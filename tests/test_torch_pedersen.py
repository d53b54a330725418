"""The port's Pedersen slice at 3 parties against the JAX package and the
spec oracle: the generators, the MPC commitment through `mpc/te.py`, the
PedersenComCircuit at 4 message and 4 randomness bits (its R1CS, instance
and opened assignment), and a proof of that circuit.

The JAX package synthesizes the circuit eagerly, about 40 s on a CPU, so
the tier-1 test reads its results from a fixture it wrote
(`fixtures/make_torch_pedersen_fixture.py`); a `slow` test regenerates it.
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_pedersen_fixture as PF
from fixtures import make_torch_xla_fixture as XF
from torch_parity import CPU, check_circuit, fewer_attempts
from zkmpc_tpu_torch.crypto import pedersen as TPD
from zkmpc_tpu_torch.mpc import te as TE
from zkmpc_tpu_torch.mpc.share import MpcContext, king_share, mpc_scope
from zkmpc_tpu_torch.ops import msm as OM
from zkmpc_tpu_torch.ops.limbs import FR, FpArray, limbs_to_ints
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.snark import driver, groth16
from zkmpc_tpu_torch.spec import curves as SC

torch.set_num_threads(1)


def _scope():
    return mpc_scope(MpcContext(StackedTransport(PF.N_PARTIES, CPU), "semi"))


def _fr(vals):
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=CPU)


#: the cases of `test_generators_and_public_commitment_match_reference`:
#: generator seed, commitment message and randomness, CRH width and input
PP_SEED, COM_M, COM_R = 7, 123456789, 0x5A5A5A5A5A
CRH_BITS, CRH_INPUT = 6, [1, 0, 1, 1, 0, 1]


def _points_of(limbs):
    """Integer limbs [k, 2, n] -> affine (x, y) int pairs."""
    ints = limbs_to_ints(limbs)
    return [(ints[2 * i], ints[2 * i + 1]) for i in range(len(ints) // 2)]


def test_generators_and_public_commitment_match_reference():
    """The generators, a commitment, the CRH generators and a CRH value are
    the JAX package's (from ``fixtures/torch_xla.npz``,
    `fixtures/make_torch_xla_fixture.py`)."""
    gens, (blind,), (com,), crh_gens, (crh,) = (
        _points_of(a) for a in XF.ref("pedersen_params"))
    got = TPD.PedersenParams.sample(PP_SEED)
    assert got.generators == gens and got.blind_base == blind
    assert all(SC.te_is_on_curve(g) for g in got.generators[:8])
    assert TPD.commit_public_ints(got, COM_M, COM_R) == com
    cp = TPD.CrhParams.sample(CRH_BITS)
    assert cp.generators == crh_gens
    assert TPD.crh_public_ints(cp, CRH_INPUT) == crh


def test_mpc_commitment_and_te_points_match_spec():
    """`crypto.pedersen.commit` through `mpc/te.py` equals the spec oracle,
    as `tests/test_crypto.py` holds the JAX package's."""
    gen = torch.Generator().manual_seed(5)
    pp = TPD.PedersenParams.sample(7)
    g = SC.TE_GEN
    g2 = SC.te_add(g, g)
    m_int, r_int = 123456789, 0b110101
    with _scope():
        pt = TE.MpcTEPoint.from_public_affine([g, g2])
        assert pt.add(pt).reveal_affine_ints() == [SC.te_add(g, g), SC.te_add(g2, g2)]
        bit = king_share(_fr([0, 1]), gen)
        sel = TE.select_base(bit, (np.asarray([g[0]] * 2, dtype=object),
                                   np.asarray([g[1]] * 2, dtype=object)))
        assert sel.reveal_affine_ints() == [SC.TE_NEUTRAL, g]
        val = 0b1011001
        b = king_share(_fr([(val >> i) & 1 for i in range(7)]), gen)
        assert TE.scalar_mul_bits(g, b).reveal_affine_ints() == [SC.te_scalar_mul(g, val)]
        m = king_share(_fr([m_int]), gen)
        r_bits = king_share(_fr([[(r_int >> i) & 1 for i in range(6)]]), gen)
        got = TPD.commit(pp, m, r_bits, gen).reveal_affine_ints()
        cp = TPD.CrhParams.sample(6)
        left, right = king_share(_fr([1, 0, 1]), gen), king_share(_fr([1, 0, 1]), gen)
        crh = TPD.two_to_one_crh(cp, left, right).reveal_affine_ints()
    assert got == [TPD.commit_public_ints(pp, m_int, r_int)]
    assert crh == [TPD.crh_public_ints(cp, [1, 0, 1, 1, 0, 1])]


def _port_pedersen_cs():
    # one candidate a random bitwise-shared value: the circuit does not
    # depend on the draws
    with fewer_attempts(1):
        return driver.synthesize_pedersen_cs(PF.N_PARTIES, nbits=PF.NBITS, device=CPU)


@pytest.fixture(scope="module")
def pedersen_cs():
    """The 4+4-bit circuit, synthesized once for the module."""
    return _port_pedersen_cs()


def test_pedersen_circuit_matches_reference(pedersen_cs):
    fx = PF.load(np.load(PF.PATH))["pedersen"]
    cs = pedersen_cs
    check_circuit(cs, fx)
    assert fx["instance"] == driver.expected_pedersen_instance(PF.NBITS)
    assert fx["counts"]["constraints"] == 40     # 8 bits take the tree path


@pytest.mark.slow
def test_circuits_against_live_reference():
    """Regenerates both circuits of the fixture with the JAX package
    (several minutes on a CPU) and holds the port against them."""
    from test_torch_gadgets import port_gadget_cs
    fx = PF.load(PF.generate())
    check_circuit(_port_pedersen_cs(), fx["pedersen"])
    check_circuit(port_gadget_cs(), fx["gadgets"])


#: parties of the prove test: the prove runs the same code at any party
#: count, and its ladders' work grows with the rows
PROVE_PARTIES = 2


def test_pedersen_prove_verifies(monkeypatch, pedersen_cs):
    """Setup and a prove of the 4+4-bit circuit with injected r/s, at
    `PROVE_PARTIES` parties: the proof verifies and a wrong instance is
    rejected.  The ~40-point MSMs take the ladder path here (the card runs
    the bucketed path at 3 parties in `chip_smoke.py`); an MSM's value does
    not depend on the path."""
    monkeypatch.setattr(OM, "MIN_BUCKETED_POINTS", 1 << 30)
    dpk = groth16.device_setup(pedersen_cs, seed=1, device=CPU)
    step, args = driver.make_pedersen_prove_fn(dpk, PROVE_PARTIES, nbits=PF.NBITS)
    r, s = (_fr(v) for v in ([5, 7], [2, 3]))
    t = StackedTransport(PROVE_PARTIES, CPU)
    with fewer_attempts(1):
        proof = driver.proof_arrays_to_ints(step(*args, r=r, s=s, transport=t))
    assert t.stats.rounds > 0                  # the prove ran on the given transport
    inst = driver.expected_pedersen_instance(PF.NBITS)
    assert all(pt is not None for pt in proof)
    assert groth16.verify(dpk.pk.vk, inst, proof)
    assert not groth16.verify(dpk.pk.vk, [1, (inst[1] + 1) % FR.p, inst[2]], proof)
