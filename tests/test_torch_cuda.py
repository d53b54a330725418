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

from chip_smoke import case_points, check_k1, k1_cases, k1_views
from zkmpc_tpu_torch.ops import build as K
from zkmpc_tpu_torch.ops import cuda_fp, cuda_point
from zkmpc_tpu_torch.ops.curve import SWPoint, sw_add_complete
from zkmpc_tpu_torch.ops.limbs import FQ, FR, MNT4Q, FpArray, limbs_to_int
from zkmpc_tpu_torch.ops.ntt import Domain

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fp(spec, ints, dev):
    return FpArray.from_int(spec, np.asarray(ints, dtype=object), device=dev)


def _one_launch(spec, a, b):
    """K1 through the wrapper: one launch, no operand copy, and the same
    values as the plain version (mod p, below 2p, limbs below 2^15)."""
    K.reset_launches()
    got = cuda_fp.mont_mul(spec, a, b)
    torch.cuda.synchronize()
    assert dict(K.LAUNCHES) == {"mont_mul": 1}
    assert check_k1(spec, got, cuda_fp.mont_mul_plain(spec, a, b)) == 0
    return got


@pytest.mark.parametrize("spec", [FR, FQ, MNT4Q], ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain(spec, dev):
    rng = random.Random(3)
    for n in (1, 129, 1000):
        xs = [rng.randrange(spec.p) for _ in range(n)]
        ys = [rng.randrange(spec.p) for _ in range(n)]
        a, b = _fp(spec, xs, dev), _fp(spec, ys, dev)
        a2 = a + a
        for la, lb, scale, const in ((a.limbs, b.limbs, 1, False), (a2.limbs, b.limbs, 2, False),
                                     (a2.limbs, b.limbs[0], 2, True)):
            got = _one_launch(spec, la, lb)
            # host ints: REDC(xR * yR) = xyR
            want = [scale * x * (ys[0] if const else y) % spec.p for x, y in zip(xs, ys)]
            assert list(FpArray(got, spec, 2).to_ints()) == want
    # broadcast batch axes: [3, 1] x [1, 5]
    a = _fp(spec, [rng.randrange(spec.p) for _ in range(3)], dev).reshape((3, 1))
    b = _fp(spec, [rng.randrange(spec.p) for _ in range(5)], dev).reshape((1, 5))
    assert _one_launch(spec, a.limbs, b.limbs).shape == (3, 5, spec.nlimbs)


@pytest.mark.parametrize("spec", [FR, FQ, MNT4Q], ids=lambda s: s.name)
def test_mont_mul_kernel_at_the_contract_edge(spec, dev):
    """`chip_smoke.k1_cases`: 0, 1, p-1, 2p-1; c1*c2*p = R/2 at most, with
    limbs B+1 where the bound allows; runs of all-ones words."""
    for _, la, lb in k1_cases(spec, seed=4):
        a, b = torch.as_tensor(la, device=dev), torch.as_tensor(lb, device=dev)
        got = _one_launch(spec, a, b).cpu().numpy()
        for ra, rb, rg in zip(la, lb, got):
            assert limbs_to_int(rg) % spec.p == \
                limbs_to_int(ra) * limbs_to_int(rb) * spec.rinv % spec.p


@pytest.mark.parametrize("spec", [FR, FQ, MNT4Q], ids=lambda s: s.name)
def test_mont_mul_kernel_reads_strided_and_broadcast_operands(spec, dev):
    """`chip_smoke.k1_views`: a sliced non-contiguous a, an NTT stage's odd
    view times its [half] twiddles, [3, 1] x [1, 5]; and the NTT itself,
    whose every stage launches K1 alone."""
    for _, a, b in k1_views(spec, dev, seed=5):
        _one_launch(spec, a, b)
    if spec is FR:
        d = Domain(FR, 1 << 10, device=dev)
        x = _fp(FR, list(range(3 << 10)), dev).reshape((3, 1 << 10))
        K.reset_launches()
        y = d.fft(x)
        assert K.LAUNCHES["mont_mul"] >= d.log_n and K.LAUNCHES[cuda_fp.COPY_COUNT] == 0
        assert [list(r) for r in d.ifft(y).to_ints()] == [list(r) for r in x.to_ints()]


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
