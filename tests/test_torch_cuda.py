"""The port's CUDA kernels K1-K3 against their plain PyTorch versions, on a
CUDA card.

Marked ``gpu``; each test skips where no card is present.  The machine with
the card has no JAX, which the tests' conftest imports, so run them there as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from zkmpc_tpu.spec import curves as SC
from zkmpc_tpu_torch.ops import build as K
from zkmpc_tpu_torch.ops import cuda_fp, cuda_point
from zkmpc_tpu_torch.ops.curve import SWPoint, sw_add_complete
from zkmpc_tpu_torch.ops.limbs import FQ, FR, MNT4Q, FpArray

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fp(spec, ints, dev):
    return FpArray.from_int(spec, np.asarray(ints, dtype=object), device=dev)


@pytest.mark.parametrize("spec", [FR, FQ, MNT4Q], ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain(spec, dev):
    rng = random.Random(3)
    for n in (1, 129, 1000):
        xs = [rng.randrange(spec.p) for _ in range(n)]
        ys = [rng.randrange(spec.p) for _ in range(n)]
        a, b = _fp(spec, xs, dev), _fp(spec, ys, dev)
        a2 = a + a
        for la, lb in ((a.limbs, b.limbs), (a2.limbs, b.limbs), (a2.limbs, b.limbs[0])):
            K.reset_launches()
            got = cuda_fp.mont_mul(spec, la, lb)
            assert K.LAUNCHES["mont_mul"] == 1
            assert torch.equal(got, cuda_fp.mont_mul_plain(spec, la, lb))
    # broadcast batch axes: [3, 1] x [1, 5]
    a = _fp(spec, [rng.randrange(spec.p) for _ in range(3)], dev).reshape((3, 1))
    b = _fp(spec, [rng.randrange(spec.p) for _ in range(5)], dev).reshape((1, 5))
    got = cuda_fp.mont_mul(spec, a.limbs, b.limbs)
    assert got.shape == (3, 5, spec.nlimbs)
    assert torch.equal(got, cuda_fp.mont_mul_plain(spec, a.limbs, b.limbs))


def _cases(g2, dev, extra=200):
    gen, mul, neg = (SC.G2_GEN, SC.g2_mul, SC.g2_neg) if g2 else \
        (SC.G1_GEN, SC.g1_mul, SC.g1_neg)
    make = SWPoint.g2_from_affine_ints if g2 else SWPoint.g1_from_affine_ints
    pk = [2, 3, 5, 7, 11, 13, 17, 19] + [3 + i % 13 for i in range(extra)]
    qk = [10, 20, 5, 7, 30, 40, 50, 60] + [1 + (5 * i) % 17 for i in range(extra)]
    pa = [mul(gen, k) for k in pk]
    qa = [mul(gen, k) for k in qk]
    qa[3] = neg(pa[3])
    p, q = make(pa, dev), make(qa, dev)
    p.inf[5] = p.inf[6] = True
    q.inf[4] = q.inf[6] = True
    return p, q


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_add_kernel_matches_plain(g2, dev):
    p, q = _cases(g2, dev)
    K.reset_launches()
    got = sw_add_complete(p, q)
    assert K.LAUNCHES["point_add_g2" if g2 else "point_add_g1"] == 1
    want = cuda_point.sw_add_complete_plain(p, q)
    assert torch.equal(got.inf, want.inf)
    ga = got.to_affine_ints()
    assert ga == want.to_affine_ints()
    assert ga[3] is None and ga[6] is None


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a = _fp(FQ, [1, 2], dev)
    with pytest.raises(TypeError):
        cuda_fp.mont_mul(FQ, a.limbs.to(torch.int32), a.limbs)
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(FQ, a.limbs[..., :20], a.limbs[..., :20])
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(FQ, a.limbs, a.limbs.cpu())
    p, q = _cases(False, dev, extra=0)
    with pytest.raises(ValueError):
        cuda_point.point_add(p, SWPoint(q.x, q.y, q.z, q.inf.cpu()))
