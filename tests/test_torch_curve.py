"""The port's point layer (`zkmpc_tpu_torch.ops.curve`, `cuda_point`) against
the JAX package on the same inputs.

The plain twin of kernels K2/K3 is the reference's XLA formula, so its
Jacobian limbs must equal `zkmpc_tpu.ops.curve.sw_add_complete`'s exactly.
The fused Pallas kernel tightens its inputs first and so may leave other
Jacobian limbs: against it the affine values and infinity flags must match.
"""

import numpy as np
import pytest
import torch

from torch_parity import point_leaves_np, point_to_jax, point_to_torch
from zkmpc_tpu.ops import curve as JC
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
    p, q = make(pa), make(qa)
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
    ref = point_to_torch(JC.sw_add_complete(point_to_jax(p), point_to_jax(q)))
    for g, r in zip(point_leaves_np(got), point_leaves_np(ref)):
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


def test_double_unsafe_add_and_neg_match_xla_path():
    gen, mul, _, _, make = G1
    p = make([mul(gen, k) for k in (3, 4, 9)])
    q = make([mul(gen, k) for k in (5, 11, 2)])
    jp, jq = point_to_jax(p), point_to_jax(q)
    for got, ref in ((TC.sw_double(p), JC.sw_double(jp)),
                     (TC.sw_add_unsafe(p, q), JC.sw_add_unsafe(jp, jq)),
                     (TC.sw_neg(p), JC.sw_neg(jp))):
        for g, r in zip(point_leaves_np(got), point_leaves_np(point_to_torch(ref))):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("group,nbits", [(G1, None), (G2, 64)], ids=["g1", "g2"])
def test_scalar_mul_matches_spec(group, nbits):
    """Full-width ladder on G1 (its top step is the complete add); a 64-bit
    ladder on G2 keeps the test short."""
    gen, mul, _, _, make = group
    rng = np.random.default_rng(7)
    top = TL.FR.p - 1 if nbits is None else 2**nbits - 1
    ks = [0, 1, top] + [int(x) for x in rng.integers(1, 2**62, 2)]
    pts = make([mul(gen, 3 + i) for i in range(len(ks))])
    sc = TL.FpArray.from_int(TL.FR, np.asarray(ks, dtype=object))
    got = TC.sw_scalar_mul(pts, sc, nbits).to_affine_ints()
    assert got == [mul(mul(gen, 3 + i), k) for i, k in enumerate(ks)]


def test_scalar_bits_are_integer_bits():
    ks = [0, 5, TL.FR.p - 1, 2**200 + 17]
    bits = TC.scalar_bits(TL.FpArray.from_int(TL.FR, np.asarray(ks, dtype=object)), 253)
    for k, row in zip(ks, bits.tolist()):
        assert sum(b << i for i, b in enumerate(row)) == k
