"""The port's MPC bit protocols (`zkmpc_tpu_torch.mpc.bits`) and the shared
inverse/division of `mpc.share`, at 3 parties, against the JAX package and
host ints (the cases of `tests/test_bits.py`).

Shares are made with numpy from a seed and given to both packages.  Where
a protocol draws randomness, the JAX draws are injected into the port
(`bit_rand`'s per-party bits, `king_share`'s shares), and then the shares
must match too; elsewhere the opened outputs must equal JAX's and Python's
integers exactly, whatever the draws.  The JAX side takes minutes of XLA
compiles on a CPU, so its results come from a committed fixture
(`fixtures/make_torch_bits_fixture.py`); `slow` tests regenerate it live.
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_bits_fixture as BF
from torch_parity import ATTEMPTS, CPU
from zkmpc_tpu_torch.mpc import bits as TB
from zkmpc_tpu_torch.mpc import share as TS
from zkmpc_tpu_torch.ops import limbs as TL
from zkmpc_tpu_torch.parallel import transport as TT

torch.set_num_threads(1)

P = TL.FR.p
H = (P - 1) // 2
NP = 3
NBITS = P.bit_length()


@pytest.fixture(scope="module")
def fx():
    return BF.load(np.load(BF.PATH))


@pytest.fixture(scope="module")
def live_inputs():
    return BF.live_inputs(P)


def _torch_scope():
    return TS.mpc_scope(TS.MpcContext(TT.StackedTransport(NP, CPU), "semi"))


def _twire(arr):
    return TS.MpcFp(TL.FpArray.from_int(TL.FR, arr, device=CPU), TS.SHARED)


def _opened(fp):
    """Party 0's row of an opened FpArray as host ints."""
    v = np.asarray(fp.to_ints())[0]
    return v.tolist() if isinstance(v, np.ndarray) else int(v)


def _bits_of(v, n=NBITS):
    return [(v >> i) & 1 for i in range(n)]


def test_bit_rand_and_boolean_ops_match_reference(fx, live_inputs):
    ref = fx["live"]["bit_rand"]
    raw = np.asarray(ref["raw"], dtype=bool)
    with _torch_scope():
        b = TB.bit_rand(None, TL.FR, (16,), raw=raw)
        x, y = _twire(live_inputs["bool_x"]), _twire(live_inputs["bool_y"])
        ops = [TB.b_and(x, y), TB.b_or(x, y), TB.b_xor(x, y), TB.b_not(x),
               TB.kary_and(x), TB.kary_or(x)]
        opened = _opened(b.reveal())
        t_ops = [_opened(o.reveal()) for o in ops]
        drawn = _opened(TB.bit_rand(torch.Generator().manual_seed(1), TL.FR, (64,))
                        .reveal())
    assert opened == ref["opened"] == np.bitwise_xor.reduce(raw, axis=0).astype(int).tolist()
    assert np.asarray(b.value.to_ints()).tolist() == ref["shares"]
    want = [[0, 0, 0, 1], [0, 1, 1, 1], [0, 1, 1, 0], [1, 1, 0, 0], 0, 1]
    assert t_ops == ref["ops"] == want
    assert set(drawn) == {0, 1}


def test_king_share_injected_draws_match_reference(fx, live_inputs):
    ref = fx["live"]["king_share"]
    vals = [int(v) for v in live_inputs["king_vals"]]
    draws = TL.FpArray(torch.as_tensor(np.asarray(ref["draws"], dtype=np.int64)), TL.FR,
                       ref["draws_bound"])
    with _torch_scope():
        got = TS.king_share(TL.FpArray.from_int(TL.FR, np.asarray(vals, dtype=object),
                                                device=CPU), None, shares=draws)
        assert _opened(got.reveal()) == vals
        drawn = TS.king_share(TL.FpArray.from_int(TL.FR, np.asarray(vals, dtype=object),
                                                  device=CPU),
                              torch.Generator().manual_seed(2))
        assert _opened(drawn.reveal()) == vals
    assert got.value.bound == ref["bound"]
    np.testing.assert_array_equal(got.value.limbs.numpy(), np.asarray(ref["limbs"]))


def test_rand_number_bitwise_injected_draws_match_reference(fx):
    ref = fx["live"]["rand_number_bitwise"]
    raw = np.asarray(ref["raw"], dtype=bool)
    with _torch_scope():
        bits, val = TB.rand_number_bitwise(None, TL.FR, (2,), attempts=BF.ATTEMPTS, raw=raw)
        t_bits, t_val = _opened(bits.reveal()), _opened(val.reveal())
    assert t_bits == ref["bits"]
    assert t_val == ref["val"]
    for row, v in zip(t_bits, t_val):
        assert sum(int(b) << i for i, b in enumerate(row)) == v < P


def _run_port(name, inputs, gen):
    """The port's protocol ``name`` on the shares ``inputs``: (opened ints,
    openings counted)."""
    with _torch_scope() as c:
        w = {n: _twire(v) for n, v in inputs.items()}
        out = {
            "eqz": lambda: TB.equality_zero(w["eqz"], gen, attempts=ATTEMPTS),
            "half": lambda: TB.is_smaller_or_equal_than_mod_minus_one_div_two(
                w["half"], gen, attempts=ATTEMPTS),
            "lt": lambda: TB.less_than(w["lt_x"], w["lt_y"], gen, attempts=ATTEMPTS),
            "bd": lambda: TB.bit_decomposition(w["bd"], gen, attempts=ATTEMPTS),
            "bitwise_lt": lambda: TB.bitwise_lt(w["a_bits"], w["b_bits"]),
            "carries": lambda: TB.carries(w["a_bits"], w["b_bits"]),
            "bit_add": lambda: TB.bit_add(w["a_bits"], w["b_bits"]),
            "inv": lambda: TS.beaver_inv(w["inv_x"]),
            "div": lambda: TS.beaver_div(w["inv_x"], w["div_y"]),
        }[name]()
        return _opened(out.reveal()), c.transport.stats.rounds


def _signed(v):
    return v if v <= H else v - P


def _values(shares):
    """Host ints of additive shares [NP, n]."""
    return [sum(int(s) for s in col) % P for col in shares.T]


def _want(name, ins):
    """The expected host ints of a fixture protocol, from its inputs."""
    if name == "lt":
        return [int(_signed(a) < _signed(b))
                for a, b in zip(_values(ins["lt_x"]), _values(ins["lt_y"]))]
    v = _values(ins[name])
    if name == "eqz":
        return [int(x == 0) for x in v]
    if name == "half":
        return [int(x <= H) for x in v]
    return [_bits_of(x) for x in v]


# openings of equality-zero at ATTEMPTS = 4, for any batch: two products
# each (d and e) for bit_rand (2), the comparison with p (8 suffix-or
# levels), the prefix products over the attempts (2 levels), the selection
# (2) and the AND tree (8 levels), and one for x + r
EQZ_ROUNDS = 2 * (2 + 8 + (ATTEMPTS - 1).bit_length() + 2 + 8) + 1


@pytest.mark.parametrize("name", BF.PROTOCOLS)
def test_protocol_opens_like_reference_fixture(fx, name):
    """Equality-zero, the half-range test, less-than and the bit
    decomposition against the JAX package's opened outputs
    (`fixtures/make_torch_bits_fixture.py`) and host ints."""
    got, rounds = _run_port(name, fx["inputs"], torch.Generator().manual_seed(8))
    assert got == fx["opened"][name] == _want(name, fx["inputs"])
    if name == "eqz":
        assert rounds == EQZ_ROUNDS + 1        # and the test's own opening


@pytest.mark.slow
def test_protocols_against_live_reference():
    """Regenerates the fixture's outputs from the JAX package (minutes on a
    CPU): the protocols' openings, against which the port is held again,
    and the reference's side of the share- and draw-level tests, which
    must equal the committed file's."""
    fx = BF.load(BF.generate())
    for name in BF.PROTOCOLS:
        got, _ = _run_port(name, fx["inputs"], torch.Generator().manual_seed(9))
        assert got == fx["opened"][name] == _want(name, fx["inputs"])
    live = BF.load({**BF.generate(), **BF.generate_live()})["live"]
    assert live == BF.load(np.load(BF.PATH))["live"]


@pytest.fixture(scope="module")
def adder_cases(fx, live_inputs):
    """Bit-vector adders and the shared inverse: inputs, JAX's opened
    outputs (from the fixture) and the expected host ints."""
    ins = live_inputs
    a_int, b_int = [int(v) for v in ins["a_int"]], [int(v) for v in ins["b_int"]]
    inv_x, div_y = [int(v) for v in ins["inv_x_int"]], [int(v) for v in ins["div_y_int"]]
    inputs = {k: ins[k] for k in ("a_bits", "b_bits", "inv_x", "div_y")}
    want = {
        "bitwise_lt": [int(a < b) for a, b in zip(a_int, b_int)],
        "carries": [[(a % (1 << (i + 1)) + b % (1 << (i + 1))) >> (i + 1)
                     for i in range(NBITS)] for a, b in zip(a_int, b_int)],
        "bit_add": [_bits_of(a + b, NBITS + 1) for a, b in zip(a_int, b_int)],
        "inv": [pow(x, -1, P) for x in inv_x],
        "div": [x * pow(y, -1, P) % P for x, y in zip(inv_x, div_y)],
    }
    return inputs, fx["live"]["adders"], want


@pytest.mark.parametrize("name", ["bitwise_lt", "carries", "bit_add", "inv", "div"])
def test_adders_and_inverse_open_like_reference(adder_cases, name):
    inputs, ref, want = adder_cases
    got, _ = _run_port(name, inputs, None)
    assert got == ref[name] == want[name]
