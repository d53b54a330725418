"""The port's shared bytes and byte gadget at 3 parties, against the JAX
package: `mpc/uint8.py` (`MpcU8`), `snark/uint8_gadget.py` (`UInt8`),
`ops.limbs.fp_from_digits` and `mpc.share.modulus_conversion`.

Inputs are made with numpy from a seed; where a protocol draws, the JAX
draws are injected (`king_share(shares=)`, `input_share(mask=)`,
`rand_number_bitwise(raw=)`), so shares must match the reference limb for
limb or value for value.  The JAX package synthesizes the byte circuit
eagerly, and its byte and conversion cases take seconds of XLA compiles,
so the tier-1 tests read its side from a fixture
(`fixtures/make_torch_uint8_fixture.py`); a `slow` test regenerates it.
`fp_from_digits` reads the JAX side from ``fixtures/torch_xla.npz``
(`fixtures/make_torch_xla_fixture.py`).
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_uint8_fixture as UF
from fixtures import make_torch_xla_fixture as XF
from torch_parity import ATTEMPTS, CPU, SPECS, check_circuit, rand_ints
from zkmpc_tpu_torch import inputs as IN
from zkmpc_tpu_torch.mpc import bits as TB
from zkmpc_tpu_torch.mpc.share import (PUBLIC, MpcContext, MpcFp, king_share,
                                       modulus_conversion, mpc_scope)
from zkmpc_tpu_torch.mpc.uint8 import MpcU8, bytes_to_u8
from zkmpc_tpu_torch.ops.limbs import EDFR, FQ, FR, FpArray, fp_from_digits, int_to_limbs
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem

torch.set_num_threads(1)

NP = UF.N_PARTIES


def _scope(backend="semi", **kw):
    return mpc_scope(MpcContext(StackedTransport(NP, CPU), backend, **kw))


@pytest.fixture(scope="module")
def fx():
    return UF.load(np.load(UF.PATH))


# ------------------------------------------------------------------ MpcU8


def _draw(fx, name, spec):
    limbs, bound = fx["draws"][name]
    return FpArray(torch.as_tensor(limbs), spec, bound)


def test_u8_ops_match_reference(fx):
    """Shared bytes dealt under the JAX package's draws: xor, and, or and
    not give its bit shares limb for limb and open to the host's bytes."""
    a_vals, b_vals = UF.u8_inputs()
    with _scope():
        a, b = (MpcU8(king_share(FpArray.from_int(FR, UF.bit_ints(v), device=CPU), None,
                                 shares=_draw(fx, name, FR)))
                for v, name in zip((a_vals, b_vals), ("u8_a", "u8_b")))
        outs = [a.xor(b), a.and_(b), a.or_(b), a.not_()]
        opened = [u.reveal_ints() for u in outs]
        pub = bytes_to_u8(bytes(a_vals))
        assert pub.shape == (6,) and pub.xor(b).reveal_ints() == opened[0]
        assert MpcU8.from_public_ints(b_vals).to_field().visibility == PUBLIC
    for u, w in zip(outs, fx["u8"]):
        np.testing.assert_array_equal(u.bits.value.limbs.numpy(), w)
    assert opened == [[x ^ y for x, y in zip(a_vals, b_vals)],
                      [x & y for x, y in zip(a_vals, b_vals)],
                      [x | y for x, y in zip(a_vals, b_vals)], [x ^ 0xFF for x in a_vals]]


# ------------------------------------------------------------- the gadget


def port_byte_cs(fx):
    """The byte circuit through the port, under the fixture's input masks
    and bit-protocol draws; returns the ConstraintSystem."""
    masks = [FpArray(torch.as_tensor(m), FR, int(b)) for m, b in fx["masks"]]
    raws = list(fx["raws"])
    orig = TB.rand_number_bitwise

    def injected(generator, spec, shape=(), attempts=16, raw=None):
        return orig(generator, spec, shape, UF.ATTEMPTS, raws.pop(0))

    with pytest.MonkeyPatch.context() as mp, _scope():
        mp.setattr(TB, "rand_number_bitwise", injected)
        wires = [IN.input_share(FpArray.from_int(FR, np.asarray(v, dtype=object), device=CPU),
                                owner, None, mask=masks[owner])
                 for owner, v in enumerate((UF.A_BYTES, UF.B_BYTES))]
        cs = ConstraintSystem(FR)
        UF.byte_circuit("zkmpc_tpu_torch", cs, wires[0], wires[1], [None] * 3)
    assert not raws, "the port drew fewer bit-protocol candidates than the reference"
    return cs


def _check_byte_cs(cs, fx):
    check_circuit(cs, fx["gadget"], NP)
    with _scope():
        shares = [[int(v) for v in row] for row in cs.full_assignment().value.to_ints()]
    assert shares == fx["gadget"]["shares"]


def test_byte_gadget_matches_reference(fx):
    """`UInt8.new_witness_vec` over input-shared bytes, the bit algebra,
    rotr, shl, the bit round trip, to_fp and is_eq: the R1CS, instance,
    opened full assignment and every party's share of it equal the JAX
    package's under its draws."""
    assert UF.ATTEMPTS == ATTEMPTS
    _check_byte_cs(port_byte_cs(fx), fx)


def test_byte_gadget_restricts_the_range():
    """A value of 300 allocated as a byte leaves the system unsatisfied:
    the recomposition over 8 bits cannot match it."""
    from torch_parity import fewer_attempts
    from zkmpc_tpu_torch.snark.uint8_gadget import UInt8
    gen = torch.Generator().manual_seed(3)
    with fewer_attempts(), _scope():
        cs = ConstraintSystem(FR)
        u = UInt8.new_witness(cs, king_share(FpArray.from_int(FR, 300, device=CPU), gen), gen)
        assert not cs.is_satisfied_ints() and len(u.to_bits_le()) == 8


@pytest.mark.slow
def test_against_live_reference():
    """Regenerates the fixture with the JAX package (a few minutes on a
    CPU) and holds the port against it."""
    from test_torch_mul_share import test_mul_share_matches_reference
    from test_torch_te import check_curves
    fresh = UF.load(UF.generate())
    _check_byte_cs(port_byte_cs(fresh), fresh)
    test_u8_ops_match_reference(fresh)
    test_modulus_conversion_matches_reference(fresh)
    for name in UF.MUL_SPECS:
        test_mul_share_matches_reference(fresh, name)
    check_curves(fresh)


# ------------------------------------------------ modulus conversion


@pytest.mark.parametrize("pair", [("bls12_377_fr", "mnt4_753_fq"),
                                  ("mnt4_753_fq", "bls12_377_fr"),
                                  ("bls12_377_fr", "ed_bls12_377_fr"),
                                  ("bls12_377_fq", "bls12_377_fr")])
def test_fp_from_digits_matches_reference(pair):
    """Canonical digits of numpy-seeded integers (the source field's width,
    and a 3-digit one) re-embedded in the target field: the JAX package's
    limbs (from ``fixtures/torch_xla.npz``, `fixtures/make_torch_xla_fixture.py`),
    and the integers mod the target's p."""
    (_, src), (_, dst) = SPECS[pair[0]], SPECS[pair[1]]
    vals, digits, short = _digit_inputs(src)
    got = [fp_from_digits(dst, torch.as_tensor(d)) for d in (digits, short)]
    for g, w in zip(got, XF.ref(f"fp_from_digits.{pair[0]}.{pair[1]}"), strict=True):
        np.testing.assert_array_equal(g.limbs.numpy(), w)
    assert [int(v) for v in got[0].to_ints()] == [v % dst.p for v in vals]


def _digit_inputs(src):
    """Numpy-seeded integers below ``src``'s p, their canonical digits and
    the first three digits (int64)."""
    rng = np.random.default_rng(5)
    vals = rand_ints(rng, src.p, 6) + [src.p - 1, 0]
    digits = np.stack([int_to_limbs(v, src.nlimbs) for v in vals]).astype(np.int64)
    return vals, digits, digits[:, :3]


def test_modulus_conversion_matches_reference(fx):
    """Shared FR values below 2^250 converted to EDFR and FQ under the JAX
    package's dealing draws, and the public values: its shares limb for
    limb, and the integers mod the target."""
    vals = UF.conv_inputs()
    with _scope():
        x = king_share(FpArray.from_int(FR, np.asarray(vals, dtype=object), device=CPU), None,
                       shares=_draw(fx, "conv_in", FR))
        outs = [modulus_conversion(x, EDFR, None, shares=_draw(fx, "conv_ed", EDFR)),
                modulus_conversion(x, FQ, None, shares=_draw(fx, "conv_fq", FQ)),
                modulus_conversion(MpcFp.const(FR, vals), EDFR, None)]
        opened = [[int(v) for v in o.reveal().to_ints()[0]] for o in outs]
    for o, w in zip(outs, fx["conv"]):
        np.testing.assert_array_equal(o.value.limbs.numpy(), w)
    assert outs[2].visibility == PUBLIC
    assert opened == [[v % EDFR.p for v in vals], [v % FQ.p for v in vals],
                      [v % EDFR.p for v in vals]]


def test_modulus_conversion_under_spdz_deals_by_the_key_field():
    """Under SPDZ a conversion into the MAC key's field deals shares with
    MACs; into another field, semi-style shares without them (the
    reference's path); both open to the value and the field MAC check
    passes."""
    gen = torch.Generator().manual_seed(9)
    alphas = FpArray.from_int(FR, [3, 5, 11], device=CPU)
    with _scope("spdz", alpha_share=alphas) as c:
        x = king_share(FpArray.from_int(FR, [7, 1 << 240], device=CPU), gen)
        same = modulus_conversion(x, FR, gen)
        other = modulus_conversion(x, EDFR, gen)
        assert same.mac is not None and other.mac is None
        assert [int(v) for v in same.reveal().to_ints()[0]] == [7, 1 << 240]
        with _scope():
            assert [int(v) for v in other.reveal().to_ints()[0]] == [7, (1 << 240) % EDFR.p]
        assert c.assert_field_macs(require_nonempty=True)
