"""The port's point layer (`zkmpc_tpu_torch.ops.curve`, `cuda_point`) against
the JAX package on the same inputs.

The plain twin of kernels K2/K3 is the reference's XLA formula, so its
Jacobian limbs must equal `zkmpc_tpu.ops.curve.sw_add_complete`'s exactly;
the JAX package's limbs on these inputs are read from
``fixtures/torch_xla.npz`` (`fixtures/make_torch_xla_fixture.py`), which
the ``slow`` `test_xla_fixture_against_live_reference` regenerates.
The fused Pallas kernel tightens its inputs first and so may leave other
Jacobian limbs: against it the affine values and infinity flags must match.
"""

import numpy as np
import pytest
import torch

from chip_smoke import case_points, limbs_at_b
from fixtures import make_torch_xla_fixture as XF
from torch_parity import CPU, point_leaves_np, point_to_jax, point_to_torch, rand_ints
from zkmpc_tpu.ops import pallas_point as PPT
from zkmpc_tpu.spec import curves as SC
from zkmpc_tpu_torch.ops import build as K
from zkmpc_tpu_torch.ops import cuda_point
from zkmpc_tpu_torch.ops import curve as TC
from zkmpc_tpu_torch.ops import limbs as TL

torch.set_num_threads(1)

G1 = (SC.G1_GEN, SC.g1_mul, SC.g1_add, SC.g1_neg, TC.SWPoint.g1_from_affine_ints)
G2 = (SC.G2_GEN, SC.g2_mul, SC.g2_add, SC.g2_neg, TC.SWPoint.g2_from_affine_ints)


def _all_cases(group):
    """The lanes of tests/test_pallas_point.py: generic, generic, p == q,
    q == -p, q at infinity, p at infinity, both at infinity, generic."""
    gen, mul, add, neg, make = group
    pa = [mul(gen, k) for k in (2, 3, 5, 7, 11, 13, 17, 19)]
    qa = [mul(gen, k) for k in (10, 20, 5, 7, 30, 40, 50, 60)]
    qa[3] = neg(pa[3])
    pinf = [0, 0, 0, 0, 0, 1, 1, 0]
    qinf = [0, 0, 0, 0, 1, 0, 1, 0]
    p, q = make(pa, CPU), make(qa, CPU)
    p.inf = torch.tensor(pinf, dtype=torch.bool)
    q.inf = torch.tensor(qinf, dtype=torch.bool)
    exp = []
    for a, b, ia, ib in zip(pa, qa, pinf, qinf):
        a, b = (None if ia else a), (None if ib else b)
        exp.append(b if a is None else a if b is None else add(a, b))
    return p, q, exp


@pytest.mark.parametrize("group", [G1, G2], ids=["g1", "g2"])
def test_complete_add_plain_matches_xla_path(group):
    p, q, exp = _all_cases(group)
    got = cuda_point.point_add(p, q)
    ref = XF.ref(f"complete_add.{'g1' if group is G1 else 'g2'}")
    for g, r in zip(point_leaves_np(got), ref, strict=True):
        np.testing.assert_array_equal(g, r)
    assert got.to_affine_ints() == exp


@pytest.mark.slow
@pytest.mark.parametrize("group", [G1, G2], ids=["g1", "g2"])
def test_complete_add_plain_matches_pallas_interpret(group):
    """Slow: the interpreted Pallas kernel takes 10-20 s on a CPU.  Tier-1
    covers it through the exact match with the XLA path above and the
    reference's own Pallas-vs-XLA test on the same lanes."""
    p, q, _ = _all_cases(group)
    got = cuda_point.sw_add_complete_plain(p, q)
    ref = point_to_torch(PPT.sw_add_complete_pallas(point_to_jax(p),
                                                    point_to_jax(q), "interpret"))
    assert torch.equal(got.inf, ref.inf)
    assert got.to_affine_ints() == ref.to_affine_ints()


def test_point_add_wrapper_on_cpu_and_kernel_refuses_cpu_points():
    p, q, exp = _all_cases(G1)
    K.reset_launches()
    assert TC.sw_add_complete(p, q).to_affine_ints() == exp
    assert sum(K.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        cuda_point.sw_add_complete_cuda(p, q)


def _point_op_inputs():
    """The G1 points of `test_double_unsafe_add_and_neg_match_xla_path`."""
    gen, mul, _, _, make = G1
    return (make([mul(gen, k) for k in (3, 4, 9)], CPU),
            make([mul(gen, k) for k in (5, 11, 2)], CPU))


def test_double_unsafe_add_and_neg_match_xla_path():
    p, q = _point_op_inputs()
    for got, name in ((TC.sw_double(p), "double"), (TC.sw_add_unsafe(p, q), "add_unsafe"),
                      (TC.sw_neg(p), "neg")):
        for g, r in zip(point_leaves_np(got), XF.ref(name), strict=True):
            np.testing.assert_array_equal(g, r)


@pytest.mark.slow
def test_xla_fixture_against_live_reference():
    """Regenerates every case of ``fixtures/torch_xla.npz`` with the JAX
    package and holds the committed file against it."""
    live, committed = XF.load(XF.generate()), XF.load(np.load(XF.PATH))
    assert sorted(live) == sorted(committed)
    for name, arrays in live.items():
        for a, b in zip(arrays, committed[name], strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("group,nbits", [(G1, None), (G2, 64)], ids=["g1", "g2"])
def test_scalar_mul_matches_spec(group, nbits):
    """Full-width ladder on G1 (its top step is the complete add); a 64-bit
    ladder on G2 keeps the test short."""
    gen, mul, _, _, make = group
    rng = np.random.default_rng(7)
    top = TL.FR.p - 1 if nbits is None else 2**nbits - 1
    ks = [0, 1, top] + [int(x) for x in rng.integers(1, 2**62, 2)]
    pts = make([mul(gen, 3 + i) for i in range(len(ks))], CPU)
    sc = TL.FpArray.from_int(TL.FR, np.asarray(ks, dtype=object), device=CPU)
    got = TC.sw_scalar_mul(pts, sc, nbits).to_affine_ints()
    assert got == [mul(mul(gen, 3 + i), k) for i, k in enumerate(ks)]


@pytest.mark.parametrize("group,nbits", [(G1, None), (G2, 64)], ids=["g1", "g2"])
def test_fixed_base_mul_matches_spec(group, nbits):
    """One base point broadcast against a [2, 3] batch of scalars (as the
    group triples use the ladder), and the setup's fixed-base comb
    (`groth16._fixed_base_muls`: window bases 2^(4j) G from the host,
    `curve.sw_fixed_base_mul` on the batch) on the same scalars and one
    whose every digit is 15, against `spec.curves` on 0, 1, the top scalar
    and random ones."""
    from zkmpc_tpu_torch.snark import groth16
    gen, mul, _, _, make = group
    rng = np.random.default_rng(8)
    top = TL.FR.p - 1 if nbits is None else 2**nbits - 1
    ks = [0, 1, top] + [int(x) for x in rng.integers(1, 2**62, 3)]
    sc = TL.FpArray.from_int(TL.FR, np.asarray(ks, dtype=object).reshape(2, 3), device=CPU)
    got = TC.sw_scalar_mul(make([gen], CPU)[0], sc, nbits)
    assert got.shape == (2, 3)
    assert got.reshape((6,)).to_affine_ints() == [mul(gen, k) for k in ks]
    ks += [2**252 - 1]
    comb = groth16._fixed_base_muls(gen, group is G2, ks, CPU)
    assert comb.shape == (7,)
    assert comb.to_affine_ints() == [mul(gen, k) for k in ks]


def test_scalar_bits_are_integer_bits():
    ks = [0, 5, TL.FR.p - 1, 2**200 + 17]
    bits = TC.scalar_bits(TL.FpArray.from_int(TL.FR, np.asarray(ks, dtype=object),
                                              device=CPU), 253)
    for k, row in zip(ks, bits.tolist()):
        assert sum(b << i for i, b in enumerate(row)) == k


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_case_lanes_of_the_point_kernels_on_the_plain_version(g2):
    """The lanes that `chip_smoke.py` and the card tests hold K2/K3 to
    (Jacobian z != 1, values in [p, 2p), limbs equal to B, p == q with
    z1 != z2, Jacobian q == -p, a warp of doublings) give `spec.curves`'s
    sums through the plain version."""
    p, q, exp, _ = case_points(g2, CPU, n_lanes=128)
    assert any((leaf == TL.B).any() for leaf in p.leaves()[:-1])
    got = cuda_point.point_add(p, q)
    assert got.to_affine_ints() == exp


def test_point_kernel_constants_and_radix_change():
    """The wrapper's constants for K2/K3, and a pure-int model of the
    kernel's load (26 relaxed 15-bit limbs at radix 2^390 -> 12 words at
    radix 2^384, via (v + k p) / 64) and store (6 doublings mod p, then
    canonical 15-bit limbs), on random values, values in [p, 2p) and limbs
    equal to B."""
    spec = TL.FQ
    p, R1, R2 = spec.p, spec.R, 1 << 384
    k = cuda_point._kernel_consts(spec).tolist()
    assert len(k) == 2 * cuda_point.NWORDS + 2
    assert sum(w << (32 * j) for j, w in enumerate(k[:12])) == p
    assert sum(w << (32 * j) for j, w in enumerate(k[12:24])) == 2 * p
    assert k[24] * p % 2**32 == 2**32 - 1 and k[25] * p % 64 == 1
    assert 4 * p < R2

    def pack(limbs):
        """The kernel's running 64-bit accumulator: a word leaves it once the
        limbs below the word's top have all come in."""
        words, acc = [], 0
        for i, limb in enumerate(limbs):
            acc += int(limb) << (15 * i - 32 * len(words))
            assert acc < 2**64
            if len(words) < 12 and 15 * (i + 1) >= 32 * (len(words) + 1):
                words.append(acc & 0xFFFFFFFF)
                acc >>= 32
        assert acc == 0
        return sum(w << (32 * j) for j, w in enumerate(words))

    rng = np.random.default_rng(44)
    reps = [x * R1 % p for x in rand_ints(rng, p, 30)] + [0, p - 1]
    cases = [TL.int_to_limbs(m, spec.nlimbs) for m in reps]
    cases += [TL.int_to_limbs(m + p, spec.nlimbs) for m in reps]
    py_rng = __import__("random").Random(45)
    cases += [np.asarray(limbs_at_b(py_rng)) for _ in range(20)]
    for limbs in cases:
        v = TL.limbs_to_int(limbs)
        assert v < 2 * p and pack(limbs) == v
        u = v + (-v * k[25] % 64) * p
        assert u % 64 == 0 and u < R2
        x = u >> 6                                     # x R2, below 2p
        assert x < 2 * p and x % p == v * R2 * pow(R1, -1, p) % p
        y = x - p if x >= p else x
        for _ in range(6):
            y = 2 * y - p if 2 * y >= p else 2 * y
        out = TL.int_to_limbs(y, spec.nlimbs)          # canonical limbs
        assert y == v % p and out.max() < TL.B
