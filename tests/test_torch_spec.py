"""The port's own copies of the JAX package's pure-Python modules
(`zkmpc_tpu_torch.params`, `spec.field`, `spec.curves`, `compat.ark`,
`compat.chacha`) against the originals on a few seeded inputs.

Exact everywhere: these are constants and integer arithmetic.  The pairing
copy is exercised by `tests/test_torch_groth16.py`, which verifies proofs
through it.
"""

import numpy as np

from zkmpc_tpu import params as JP
from zkmpc_tpu.compat import ark as JA
from zkmpc_tpu.spec import curves as JC
from zkmpc_tpu.spec import field as JF
from zkmpc_tpu_torch import params as TP
from zkmpc_tpu_torch.compat import ark as TA
from zkmpc_tpu_torch.spec import curves as TC
from zkmpc_tpu_torch.spec import field as TF


def test_params_match_reference():
    names = [n for n in dir(TP) if n.isupper()]
    assert len(names) >= 15
    for n in names:
        assert getattr(TP, n) == getattr(JP, n), n


def test_field_helpers_match_reference():
    rng = np.random.default_rng(41)
    for p, gen, adicity in ((TP.FR_MODULUS, TP.FR_GENERATOR, TP.FR_TWO_ADICITY),
                            (TP.FQ_MODULUS, TP.FQ_GENERATOR, TP.FQ_TWO_ADICITY)):
        xs = [int(x) for x in rng.integers(1, 2**62, 6)]
        assert TF.batch_inv(xs, p) == JF.batch_inv(xs, p)
        for logn in (0, 1, 5, 14):
            n = 1 << logn
            assert TF.root_of_unity(p, gen, adicity, n) == JF.root_of_unity(p, gen, adicity, n)


def test_curves_match_reference():
    rng = np.random.default_rng(42)
    ks = [1, 2, TP.FR_MODULUS - 1] + [int(x) for x in rng.integers(3, 2**62, 2)]
    assert TC.G1_GEN == JC.G1_GEN and TC.G2_GEN == JC.G2_GEN
    for gen, mul, add, neg, jmul, jadd, jneg in (
            (TC.G1_GEN, TC.g1_mul, TC.g1_add, TC.g1_neg, JC.g1_mul, JC.g1_add, JC.g1_neg),
            (TC.G2_GEN, TC.g2_mul, TC.g2_add, TC.g2_neg, JC.g2_mul, JC.g2_add, JC.g2_neg)):
        pts = [mul(gen, k) for k in ks]
        assert pts == [jmul(gen, k) for k in ks]
        assert [add(a, b) for a, b in zip(pts, pts[1:] + [None])] == \
            [jadd(a, b) for a, b in zip(pts, pts[1:] + [None])]
        assert add(pts[3], neg(pts[3])) is None
        assert neg(pts[4]) == jneg(pts[4])
        assert add(pts[1], pts[1]) == jadd(pts[1], pts[1])


def test_fr_rand_stream_matches_reference():
    for seed in (0, 1, 7):
        t, j = TA.seeded_rng(seed), JA.seeded_rng(seed)
        assert [TA.fr_rand(t) for _ in range(5)] == [JA.fr_rand(j) for _ in range(5)]
        # the word stream itself, across a 64-word buffer edge
        assert [t.next_u32() if i % 3 else t.next_u64() for i in range(50)] == \
            [j.next_u32() if i % 3 else j.next_u64() for i in range(50)]
