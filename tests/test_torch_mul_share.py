"""The port's multiplicative shares (`zkmpc_tpu_torch.mpc.mul_share`) at 3
parties on the stacked transport, against the JAX package's `MpcMulFp` and
host ints.

The chain (`fixtures/make_torch_uint8_fixture.mul_chain`, written once for
both packages) runs on factors made with numpy from a seed; every
operation is local or one opening, so the factors and the opened values
must match the reference limb for limb.  The JAX side's XLA compiles take
seconds, so it is read from the fixture that file writes
(`test_torch_uint8.py`'s `slow` test regenerates it).
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_uint8_fixture as UF
from torch_parity import CPU, SPECS, fp_to_torch, rand_ints
from zkmpc_tpu.mpc import mul_share as JM
from zkmpc_tpu.mpc import share as JS
from zkmpc_tpu.ops import limbs as JL
from zkmpc_tpu.parallel import transport as JT
from zkmpc_tpu_torch.mpc.mul_share import MpcMulFp
from zkmpc_tpu_torch.mpc.share import PUBLIC, MpcContext, mpc_scope
from zkmpc_tpu_torch.ops.limbs import FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport

torch.set_num_threads(1)

NP = UF.N_PARTIES


def _scope():
    return mpc_scope(MpcContext(StackedTransport(NP, CPU), "semi"))


@pytest.fixture(scope="module")
def fx():
    return UF.load(np.load(UF.PATH))


@pytest.mark.parametrize("name", UF.MUL_SPECS)
def test_mul_share_matches_reference(fx, name):
    """from_shares, from_public, public, the local *, square, inv,
    pow_const (short and long exponents), scale of a shared and of a public
    wire, open, and x * x^-1: each step's factors and its opened value."""
    tspec = SPECS[name][1]
    p = tspec.p
    factors, pub, k = UF.mul_inputs(p)
    with _scope() as c:
        got = UF.mul_chain("zkmpc_tpu_torch", tspec, factors, pub, k)
        assert c.transport.stats.rounds == 10           # one all-gather a shared reveal
    for (g_val, g_open), want in zip(got, fx["mul"][name]):
        np.testing.assert_array_equal(g_val.numpy(), want[0])
        np.testing.assert_array_equal(g_open.numpy(), want[1])
    prod = [int(np.prod(col, dtype=object)) % p for col in zip(*factors)]
    opened = [[int(v) for v in FpArray(o, tspec).to_ints()[0]] for _, o in got]
    assert opened[0] == prod and opened[1] == opened[2] == pub
    assert opened[3] == [a * b % p for a, b in zip(prod, pub)]
    assert opened[5] == [pow(a, -1, p) for a in prod]
    assert opened[7] == [pow(a, 1 << 20, p) for a in prod]
    assert opened[8] == [a * b % p for a, b in zip(prod, k)]
    assert opened[11] == [1] * len(pub)


def test_mul_share_layout_and_unsupported_ops():
    """from_public puts the value on the leader and 1 elsewhere; a public
    wire stays public through the local ops; + and shift raise, as in the
    reference."""
    jspec, tspec = SPECS["bls12_377_fr"]
    with _scope():
        v = FpArray.from_int(tspec, [5, 7, 123456789], device=CPU)
        x = MpcMulFp.from_public(v)
        assert x.is_shared() and x.shape == (3,)
        rows = [[int(u) for u in row] for row in x.value.to_ints()]
        assert rows == [[5, 7, 123456789], [1, 1, 1], [1, 1, 1]]
        w = MpcMulFp.public(v)
        assert w.visibility == PUBLIC and (w * w).visibility == PUBLIC
        assert [int(u) for u in w.square().reveal().to_ints()[1]] == [25, 49,
                                                                      123456789 ** 2 % tspec.p]
        assert torch.equal(x.unwrap_as_public().limbs, x.value.limbs)
        with pytest.raises(NotImplementedError):
            x + x
        with pytest.raises(NotImplementedError):
            x.shift(x)


def test_factors_carry_across_packages():
    """A JAX factor tensor carried across (`torch_parity.fp_to_torch`) opens
    in the port to the product the JAX package opens."""
    jspec, tspec = SPECS["bls12_377_fr"]
    rng = np.random.default_rng(2)
    factors = np.asarray([rand_ints(rng, tspec.p, 3) for _ in range(NP)], dtype=object)
    jf = JL.FpArray.from_int(jspec, factors)
    with JS.mpc_scope(JS.MpcContext(JT.StackedTransport(NP), "semi")):
        want = [int(v) for v in np.asarray(JM.MpcMulFp.from_shares(jf).reveal().to_ints())[0]]
    with _scope():
        got = MpcMulFp.from_shares(fp_to_torch(jf)).reveal()
    assert [int(v) for v in got.to_ints()[0]] == want
