"""The port's Edwards point ops (`ops.curve`: `TEPoint`, `te_add`,
`te_double`, `te_neg`, `te_scalar_mul`, `te_tree_reduce`), `ops.msm.te_msm`,
`ops.curve.sw_tree_reduce` and `utils.timer`, against the JAX package and
the spec oracle.

The points and scalars are made with numpy from a seed
(`fixtures/make_torch_uint8_fixture.te_inputs`).  The JAX side of the
curve cases takes about a minute of XLA compiles on a CPU, so it is read
from the fixture that file writes; `test_torch_uint8.py`'s `slow` test
regenerates it.  The results must match the reference limb for limb.
"""

import threading

import numpy as np
import pytest
import torch

from fixtures import make_torch_uint8_fixture as UF
from fixtures import make_torch_xla_fixture as XF
from torch_parity import CPU, limbs_np, te_point_to_jax, te_point_to_torch
from zkmpc_tpu.ops import curve as JC
from zkmpc_tpu.utils import timer as JT
from zkmpc_tpu_torch.ops import curve as C
from zkmpc_tpu_torch.ops import msm as M
from zkmpc_tpu_torch.ops.limbs import EDFR, FpArray
from zkmpc_tpu_torch.spec import curves as SC
from zkmpc_tpu_torch.utils import timer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fx():
    return UF.load(np.load(UF.PATH))


def _te_limbs(p: C.TEPoint) -> np.ndarray:
    return np.stack([c.limbs.numpy() for c in p.coords()])


def _spec_sum(pts):
    acc = SC.TE_NEUTRAL
    for p in pts:
        acc = SC.te_add(acc, p)
    return acc


def check_curves(fx):
    """The port's Edwards ops and SW tree reductions on `te_inputs` and
    `sw_inputs` against the fixture's JAX limbs and the spec oracle."""
    pts, s1, s2 = UF.te_inputs()
    P = C.TEPoint.from_affine_ints(pts, CPU)
    k1 = FpArray.from_int(EDFR, np.asarray(s1, dtype=object), device=CPU)
    k2 = FpArray.from_int(EDFR, np.asarray(s2, dtype=object), device=CPU)
    got = [C.te_add(P[:4], P[4:]), C.te_double(P), C.te_neg(P),
           C.te_scalar_mul(P, k1, UF.TE_BITS), C.te_tree_reduce(P[:5]),
           M.te_msm(P, k1, UF.TE_BITS), M.te_msm(P[:7], k2, UF.TE_BITS)]
    for g, w in zip(got, fx["te"]):
        np.testing.assert_array_equal(_te_limbs(g), w)
    mul = [SC.te_scalar_mul(p, k) for p, k in zip(pts, s1)]
    assert got[3].to_affine_ints() == mul
    assert got[4].to_affine_ints() == [_spec_sum(pts[:5])]
    assert got[5].to_affine_ints() == [_spec_sum(mul)]
    assert got[6].to_affine_ints() == [
        _spec_sum(SC.te_scalar_mul(p, k) for p, k in zip(pts[:7], row)) for row in s2]
    g1, g2 = UF.sw_inputs()
    for name, pts_, mk, spec_add, zero in (
            ("sw_g1", g1, C.SWPoint.g1_from_affine_ints, SC.g1_add, None),
            ("sw_g2", g2, C.SWPoint.g2_from_affine_ints, SC.g2_add, None)):
        r = C.sw_tree_reduce(mk(pts_, CPU))
        limbs, inf = fx[name]
        np.testing.assert_array_equal(np.stack([leaf.numpy() for leaf in r.leaves()[:-1]]),
                                      limbs)
        np.testing.assert_array_equal(r.inf.numpy(), inf)
        want = zero
        for p in pts_:
            want = spec_add(want, p)
        assert r.reshape(1).to_affine_ints() == [want]


def test_te_ops_and_sw_tree_reduce_match_reference(fx):
    """te_add, te_double, te_neg, te_scalar_mul at 16 bits, te_tree_reduce
    of 5 points, te_msm over [8] and [2, 7] scalars, and sw_tree_reduce of
    5 G1 (one pair cancelling) and 3 G2 points."""
    check_curves(fx)


def test_te_full_width_and_helpers_match_spec():
    """te_scalar_mul at the scalar field's full width (251 bits), scalar
    shapes, the neutral point, select, concat and the affine round trip
    against the spec oracle."""
    rng = np.random.default_rng(4)
    ks = [int(v) for v in rng.integers(1, 1 << 62, 2)]
    pts = [SC.te_scalar_mul(SC.TE_GEN, k) for k in ks]
    scal = [EDFR.p - 1, (1 << 250) + 12345]
    P = C.TEPoint.from_affine_ints(pts, CPU)
    got = C.te_scalar_mul(P, FpArray.from_int(EDFR, scal, device=CPU))
    assert got.to_affine_ints() == [SC.te_scalar_mul(p, k) for p, k in zip(pts, scal)]
    one = C.te_scalar_mul(P[0], FpArray.from_int(EDFR, 3, device=CPU), 2)
    assert one.shape == () and one.reshape(1).to_affine_ints() == [SC.te_scalar_mul(pts[0], 3)]
    n = C.TEPoint.neutral((2,), CPU)
    assert n.to_affine_ints() == [SC.TE_NEUTRAL] * 2
    assert C.te_add(P, n).to_affine_ints() == pts
    assert C.te_add(P, C.te_neg(P)).to_affine_ints() == [SC.TE_NEUTRAL] * 2
    pick = C.TEPoint.select(torch.tensor([True, False]), P, n)
    assert pick.to_affine_ints() == [pts[0], SC.TE_NEUTRAL]
    assert C.TEPoint.concat([P, n]).to_affine_ints() == pts + [SC.TE_NEUTRAL] * 2
    assert C.te_tree_reduce(P[:1]).reshape(1).to_affine_ints() == [pts[0]]


def test_te_points_carry_across_packages():
    """A JAX TEPoint carried to the port and back (`torch_parity`): the
    port's te_add of carried points equals the JAX package's, limb for
    limb."""
    pts = _carried_points()
    jp = JC.TEPoint.from_affine_ints(pts)
    tp = te_point_to_torch(jp)
    assert tp.to_affine_ints() == pts
    back = te_point_to_jax(tp)
    np.testing.assert_array_equal(limbs_np(back.t.limbs), limbs_np(jp.t.limbs))
    # the JAX package's te_add of the same points, from fixtures/torch_xla.npz
    got = C.te_add(tp, tp)
    for g, w in zip(got.coords(), XF.ref("te_add"), strict=True):
        np.testing.assert_array_equal(g.limbs.numpy(), w)


def _carried_points():
    return [SC.te_scalar_mul(SC.TE_GEN, k) for k in (5, 6, 7)]


def _timer_script(T):
    """Nested scopes and a raising one, in either package's timer."""
    T.reset()
    with T.timed("outer", enabled=False):
        with T.timed("inner", enabled=False):
            pass
        with T.timed("second", enabled=True):
            pass
    with pytest.raises(KeyError):
        with T.timed("raises", enabled=False):
            raise KeyError("x")
    return [(d, label) for d, label, _ in T.records()]


def test_timer_matches_reference(capsys):
    """Nested labels at their depths, in order of ending, a scope that
    raises still recorded, the enabled scope printed, reset, and records
    kept per thread: as the JAX package's timer."""
    want = _timer_script(JT)
    got = _timer_script(timer)
    assert got == want == [(1, "inner"), (1, "second"), (0, "outer"), (0, "raises")]
    assert "  [timer] second:" in capsys.readouterr().out
    assert all(dt >= 0 for _, _, dt in timer.records())
    seen = []
    th = threading.Thread(target=lambda: seen.append(timer.records()))
    th.start()
    th.join()
    assert seen == [[]] and len(timer.records()) == 4
    timer.reset()
    assert timer.records() == []
