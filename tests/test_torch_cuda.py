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

from chip_smoke import case_points
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


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_add_kernel_matches_plain(g2, dev):
    """`chip_smoke.case_points`'s lanes: generic, p == q, q == -p, infinity,
    Jacobian z != 1, values in [p, 2p), limbs equal to B, p == q with
    z1 != z2, Jacobian q == -p and a full warp of doublings."""
    p, q, exp, _ = case_points(g2, dev, n_lanes=208)
    K.reset_launches()
    got = sw_add_complete(p, q)
    assert K.LAUNCHES["point_add_g2" if g2 else "point_add_g1"] == 1
    want = cuda_point.sw_add_complete_plain(p, q)
    assert torch.equal(got.inf, want.inf)
    ga = got.to_affine_ints()
    assert ga == want.to_affine_ints() == exp
    assert ga[2] is None and ga[5] is None


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a = _fp(FQ, [1, 2], dev)
    with pytest.raises(TypeError):
        cuda_fp.mont_mul(FQ, a.limbs.to(torch.int32), a.limbs)
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(FQ, a.limbs[..., :20], a.limbs[..., :20])
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(FQ, a.limbs, a.limbs.cpu())
    p, q, _, _ = case_points(False, dev, n_lanes=128)
    with pytest.raises(ValueError):
        cuda_point.point_add(p, SWPoint(q.x, q.y, q.z, q.inf.cpu()))
