"""The port's MPC layer (`zkmpc_tpu_torch.mpc`, `parallel.transport`) on the
stacked transport at 3 parties, against the JAX package and host ints.

Shares are made with numpy from a seed and given to both packages.  The
dummy triple source is deterministic, so Beaver products must match the
reference limb for limb; group results are compared in affine ints.  The
JAX package's Beaver product and `uniform_fp` draws come from
``fixtures/torch_xla.npz`` (`fixtures/make_torch_xla_fixture.py`).
"""

import numpy as np
import torch

from fixtures import make_torch_xla_fixture as XF
from torch_parity import CPU, fp_to_torch, rand_ints
from zkmpc_tpu.ops import limbs as JL
from zkmpc_tpu.spec import curves as SC
from zkmpc_tpu_torch.mpc import group as TG
from zkmpc_tpu_torch.mpc import rand as TR
from zkmpc_tpu_torch.mpc import share as TS
from zkmpc_tpu_torch.ops import curve as TC
from zkmpc_tpu_torch.ops import limbs as TL
from zkmpc_tpu_torch.parallel import transport as TT

torch.set_num_threads(1)

P = TL.FR.p
NP = 3


def _shares(rng, vals):
    """Additive shares [NP, len(vals)] of host ints."""
    rest = [rand_ints(rng, P, len(vals)) for _ in range(NP - 1)]
    first = [(v - sum(r[i] for r in rest)) % P for i, v in enumerate(vals)]
    return np.asarray([first] + rest, dtype=object)


def _torch_ctx():
    return TS.MpcContext(TT.StackedTransport(NP, CPU), "semi")


def _beaver_inputs():
    """Host ints xs, ys and JAX FpArrays of their shares [NP, 5]."""
    rng = np.random.default_rng(21)
    xs, ys = rand_ints(rng, P, 5), rand_ints(rng, P, 5)
    jx = JL.FpArray.from_int(JL.FR, _shares(rng, xs))
    jy = JL.FpArray.from_int(JL.FR, _shares(rng, ys))
    return xs, ys, jx, jy


def test_beaver_mul_matches_reference():
    xs, ys, jx, jy = _beaver_inputs()
    want_share, want_open = XF.ref("beaver_mul")
    with TS.mpc_scope(_torch_ctx()) as c:
        z = TS.beaver_mul(TS.MpcFp(fp_to_torch(jx), TS.SHARED),
                          TS.MpcFp(fp_to_torch(jy), TS.SHARED))
        opened = z.reveal()
        assert c.transport.stats.rounds == 3      # d, e, and the final open
    np.testing.assert_array_equal(z.value.limbs.numpy(), want_share)
    np.testing.assert_array_equal(opened.limbs.numpy(), want_open)
    assert list(opened.to_ints()[0]) == [x * y % P for x, y in zip(xs, ys)]


def test_wire_semantics_with_public_values():
    rng = np.random.default_rng(22)
    xs = rand_ints(rng, P, 3)
    with TS.mpc_scope(_torch_ctx()):
        x = TS.MpcFp(TL.FpArray.from_int(TL.FR, _shares(rng, xs), device=CPU),
                     TS.SHARED)
        c = TS.MpcFp.const(TL.FR, 5)
        assert list((x + c).reveal().to_ints()[0]) == [(v + 5) % P for v in xs]
        assert list((x - c).reveal().to_ints()[0]) == [(v - 5) % P for v in xs]
        assert list((x * c).reveal().to_ints()[0]) == [v * 5 % P for v in xs]
        assert list((c * x).reveal().to_ints()[0]) == [v * 5 % P for v in xs]
        both = TS.MpcFp.concat([x, c.reshape(1)], axis=0)
        assert list(both.reveal().to_ints()[1]) == [v % P for v in xs] + [5]


#: the shape of the JAX package's `uniform_fp` draw under ``PRNGKey(5)``
#: (`fixtures/make_torch_xla_fixture`) and its raw bits
UNIFORM_SHAPE = (NP, 4)


def test_uniform_fp_with_injected_bits_matches_reference():
    """The JAX draws are reproduced bit for bit once their raw bits are
    injected; the port's own draws come from a torch.Generator."""
    want_limbs, want_bound, *bits = XF.ref("uniform_fp")
    got = TR.uniform_fp(None, TL.FR, UNIFORM_SHAPE, device=CPU, bits=bits)
    assert got.bound == int(want_bound)
    np.testing.assert_array_equal(got.limbs.numpy(), want_limbs)
    a = TR.uniform_fp(torch.Generator().manual_seed(1), TL.FR, (64,), device=CPU)
    b = TR.uniform_fp(torch.Generator().manual_seed(1), TL.FR, (64,), device=CPU)
    assert torch.equal(a.limbs, b.limbs)
    assert len(set(a.to_ints().tolist())) == 64


def test_rand_shared_injected_and_drawn():
    inj = TL.FpArray.from_int(TL.FR, np.asarray([[1], [2], [3]], dtype=object),
                              device=CPU).reshape((NP,))
    with TS.mpc_scope(_torch_ctx()):
        r = TS.rand_shared(None, TL.FR, shares=inj)
        assert r.reveal().to_ints().tolist() == [6, 6, 6]
        d = TS.rand_shared(torch.Generator().manual_seed(3), TL.FR, (2,))
        opened = d.reveal().to_ints()
        assert d.value.shape == (NP, 2) and (opened[0] == opened[2]).all()


def _point_shares(rng, ks):
    """Additive G1 shares [NP, len(ks)]: party i holds r_i * G, with the
    r_i summing to k."""
    scal = _shares(rng, ks)
    pts = [[SC.g1_mul(SC.G1_GEN, int(s)) for s in row] for row in scal]
    flat = TC.SWPoint.g1_from_affine_ints([p for row in pts for p in row], CPU)
    return flat.reshape((NP, len(ks)))


def test_group_shares_reveal_add_and_scale_many():
    """(scale_sum, which folds scale_many's outputs, runs in the slice test.)"""
    rng = np.random.default_rng(23)
    ks, xs = rand_ints(rng, P, 2), rand_ints(rng, P, 2)
    G = SC.G1_GEN
    with TS.mpc_scope(_torch_ctx()):
        pt = TG.MpcSWPoint(_point_shares(rng, ks), TS.SHARED)
        assert pt.reveal()[0].to_affine_ints() == [SC.g1_mul(G, k) for k in ks]
        pub = TG.MpcSWPoint.from_public(TC.SWPoint.g1_from_affine_ints(
            [SC.g1_mul(G, 9)] * 2, CPU))
        assert (pt + pub).reveal()[0].to_affine_ints() == \
            [SC.g1_mul(G, k + 9) for k in ks]
        x = [TS.MpcFp(TL.FpArray.from_int(TL.FR, _shares(rng, [v]), device=CPU),
                      TS.SHARED) for v in xs]
        pts = [TG.MpcSWPoint(_point_shares(rng, [k]), TS.SHARED) for k in ks]
        out = TG.scale_many([(pts[0], x[0]), (pts[1], x[1])])
        for o, k, v in zip(out, ks, xs):
            assert o.reveal()[0].to_affine_ints() == [SC.g1_mul(G, k * v % P)]
