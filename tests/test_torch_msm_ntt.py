"""The port's NTT (`zkmpc_tpu_torch.ops.ntt`) against the JAX package, and
its MSMs (`ops.msm`, `ops.msm_pippenger`) against `zkmpc_tpu.spec.curves`.

NTT limbs must match exactly (at n = 16 both packages run the same
unrolled butterflies).  The MSMs are compared in affine ints: the order of
point additions decides the Jacobian limbs, and the JAX bucketed MSM is too
compile-heavy on a CPU to run here.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import CPU, fp_to_torch, rand_ints
from zkmpc_tpu.ops import limbs as JL
from zkmpc_tpu.ops import ntt as JN
from zkmpc_tpu.spec import curves as SC
from zkmpc_tpu_torch.ops import curve as TC
from zkmpc_tpu_torch.ops import limbs as TL
from zkmpc_tpu_torch.ops import msm as TM
from zkmpc_tpu_torch.ops import ntt as TN
from zkmpc_tpu_torch.ops.msm_pippenger import sw_msm_bucketed

torch.set_num_threads(1)

G1 = (SC.G1_GEN, SC.g1_mul, SC.g1_add, TC.SWPoint.g1_from_affine_ints)
G2 = (SC.G2_GEN, SC.g2_mul, SC.g2_add, TC.SWPoint.g2_from_affine_ints)


def test_ntt_matches_reference():
    n = 16
    rng = np.random.default_rng(11)
    vals = np.asarray(rand_ints(rng, TL.FR.p, 3 * n), dtype=object).reshape(3, n)
    x = JL.FpArray.from_int(JL.FR, vals)
    jd, td = JN.Domain(JL.FR, n), TN.Domain(TL.FR, n, CPU)
    tx = fp_to_torch(x)
    # fft and coset_ifft run the butterflies with both twiddle sets and both
    # permutations; ifft and coset_fft compose the same pieces
    # (jit: one XLA compile per function is ten times cheaper here than
    # eager dispatch, and integer ops give the same limbs either way)
    pairs = [(td.fft(tx), jax.jit(jd.fft)(x)),
             (td.coset_ifft(tx), jax.jit(jd.coset_ifft)(x)),
             (td.divide_by_vanishing_poly_on_coset(tx),
              jd.divide_by_vanishing_poly_on_coset(x))]
    for got, ref in pairs:
        assert got.bound == ref.bound
        np.testing.assert_array_equal(got.limbs.numpy(), np.asarray(ref.limbs))
    assert td.ifft(td.fft(tx)).to_ints().tolist() == vals.tolist()
    assert td.coset_ifft(td.coset_fft(tx)).to_ints().tolist() == vals.tolist()
    # fft(coeffs)[i] = f(omega^i)
    p, w = TL.FR.p, td.omega
    f = td.fft(tx).to_ints()
    for i in (0, 1, 7):
        assert f[1, i] == sum(int(c) * pow(w, i * j, p) for j, c in enumerate(vals[1])) % p


def _msm_case(group, n, seed, nbits=64):
    """n bases (one at infinity, one repeated) and n scalars (one zero)."""
    gen, mul, add, make = group
    rng = np.random.default_rng(seed)
    ks = [int(x) for x in rng.integers(0, 2**63, n)]
    ks[1] = 0
    ks = [k % 2**nbits for k in ks]
    aff = [mul(gen, 3 + 7 * i) for i in range(n)]
    aff[n // 2] = None
    aff[-1] = aff[-2]
    exp = None
    for p, k in zip(aff, ks):
        if p is not None:
            exp = add(exp, mul(p, k))
    return make(aff, CPU), ks, exp


@pytest.mark.parametrize("group,n,nbits", [(G1, 20, 64), (G1, 40, 64), (G2, 20, 32)],
                         ids=["g1-20", "g1-40", "g2-20"])
def test_bucketed_msm_matches_spec(group, n, nbits):
    pts, ks, exp = _msm_case(group, n, seed=n, nbits=nbits)
    sc = TL.FpArray.from_int(TL.FR, np.asarray(ks, dtype=object), device=CPU)
    out = sw_msm_bucketed(pts, sc, c=4, nbits=nbits)
    assert out.reshape((1,)).to_affine_ints() == [exp]


@pytest.mark.parametrize("n,nbits", [(17, 8), (6, 32)], ids=["bucketed", "ladder"])
def test_msm_batched_scalars(n, nbits):
    """sw_msm over a [2, N] scalar batch: N = 17 takes the bucketed path
    (one 8-bit window keeps it short), N = 6 the ladder path."""
    pts, ks, _ = _msm_case(G1, n, seed=3, nbits=nbits)
    ks2 = [(3 * k + 1) % 2**nbits for k in ks]
    sc = TL.FpArray.from_int(TL.FR, np.asarray([ks, ks2], dtype=object), device=CPU)
    got = TM.sw_msm(pts, sc, nbits=nbits).to_affine_ints()
    aff = pts.to_affine_ints()
    want = []
    for row in (ks, ks2):
        acc = None
        for p, k in zip(aff, row):
            if p is not None:
                acc = SC.g1_add(acc, SC.g1_mul(p, k))
        want.append(acc)
    assert got == want


@pytest.mark.parametrize("sizes,nbits", [((17, 12), 8), ((5, 3), 32)],
                         ids=["bucketed", "ladders"])
def test_msm_multi_matches_separate_msms(sizes, nbits):
    """Two MSMs over different base sets in one call, as the prove fuses its
    G1 MSMs: the shorter one pads with (infinity, 0) pairs."""
    cases = [_msm_case(G1, n, seed=20 + n, nbits=nbits) for n in sizes]
    got = TM.sw_msm_multi(
        [c[0] for c in cases],
        [TL.FpArray.from_int(TL.FR, np.asarray([c[1]], dtype=object), device=CPU)
         for c in cases], nbits=nbits)
    for out, (_, _, exp) in zip(got, cases):
        assert out.to_affine_ints() == [exp]
