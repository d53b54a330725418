"""The port's MPC bit protocols (`zkmpc_tpu_torch.mpc.bits`) and the shared
inverse/division of `mpc.share`, at 3 parties, against the JAX package and
host ints (the cases of `tests/test_bits.py`).

Shares are made with numpy from a seed and given to both packages.  Where
a protocol draws randomness, the JAX draws are injected into the port
(`bit_rand`'s per-party bits, `king_share`'s shares), and then the shares
must match too; elsewhere the opened outputs must equal JAX's and Python's
integers exactly, whatever the draws.  The JAX side runs under one
`jax.jit` per case set (one compile is cheaper than eager dispatch).
"""

import jax
import numpy as np
import pytest
import torch

from fixtures import make_torch_bits_fixture as BF
from torch_parity import CPU, fp_to_torch, limbs_np, rand_ints
from zkmpc_tpu.mpc import bits as JB
from zkmpc_tpu.mpc import rand as JR
from zkmpc_tpu.mpc import share as JS
from zkmpc_tpu.ops import limbs as JL
from zkmpc_tpu.parallel import transport as JT
from zkmpc_tpu_torch.mpc import bits as TB
from zkmpc_tpu_torch.mpc import share as TS
from zkmpc_tpu_torch.ops import limbs as TL
from zkmpc_tpu_torch.parallel import transport as TT

torch.set_num_threads(1)

P = TL.FR.p
H = (P - 1) // 2
NP = 3
NBITS = P.bit_length()


def _shares(rng, vals):
    """Additive shares [NP, *shape] of host ints."""
    vals = np.asarray(vals, dtype=object)
    flat = [int(v) % P for v in vals.reshape(-1)]
    rest = [rand_ints(rng, P, len(flat)) for _ in range(NP - 1)]
    first = [(v - sum(r[i] for r in rest)) % P for i, v in enumerate(flat)]
    return np.asarray([first] + rest, dtype=object).reshape((NP,) + vals.shape)


def _jax_scope():
    return JS.mpc_scope(JS.MpcContext(JT.StackedTransport(NP), "semi"))


def _torch_scope():
    return TS.mpc_scope(TS.MpcContext(TT.StackedTransport(NP, CPU), "semi"))


def _twire(arr):
    return TS.MpcFp(TL.FpArray.from_int(TL.FR, arr, device=CPU), TS.SHARED)


def _opened(fp):
    """Party 0's row of an opened FpArray (either package) as host ints."""
    v = np.asarray(fp.to_ints())[0]
    return v.tolist() if isinstance(v, np.ndarray) else int(v)


def _bits_of(v, n=NBITS):
    return [(v >> i) & 1 for i in range(n)]


def _bernoulli_draws(key, shape):
    """The per-party bits the reference's `bit_rand` draws from ``key``."""
    return np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, i), 0.5, shape)) for i in range(NP)])


def test_bit_rand_and_boolean_ops_match_reference():
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(40)
    xs, ys = [0, 0, 1, 1], [0, 1, 0, 1]
    sx, sy = _shares(rng, xs), _shares(rng, ys)

    def ref(key, x, y):
        with _jax_scope():
            b = JB.bit_rand(key, JL.FR, (16,))
            x, y = JS.MpcFp(x, JS.SHARED), JS.MpcFp(y, JS.SHARED)
            ops = [JB.b_and(x, y), JB.b_or(x, y), JB.b_xor(x, y), JB.b_not(x),
                   JB.kary_and(x), JB.kary_or(x)]
            return b.value, b.reveal(), [o.reveal() for o in ops]

    j_share, j_open, j_ops = jax.jit(ref)(
        key, JL.FpArray.from_int(JL.FR, sx), JL.FpArray.from_int(JL.FR, sy))
    raw = _bernoulli_draws(key, (16,))
    with _torch_scope():
        b = TB.bit_rand(None, TL.FR, (16,), raw=raw)
        x, y = _twire(sx), _twire(sy)
        ops = [TB.b_and(x, y), TB.b_or(x, y), TB.b_xor(x, y), TB.b_not(x),
               TB.kary_and(x), TB.kary_or(x)]
        opened = _opened(b.reveal())
        t_ops = [_opened(o.reveal()) for o in ops]
        drawn = _opened(TB.bit_rand(torch.Generator().manual_seed(1), TL.FR, (64,))
                        .reveal())
    assert opened == _opened(j_open) == np.bitwise_xor.reduce(raw, axis=0).astype(int).tolist()
    np.testing.assert_array_equal(np.asarray(b.value.to_ints()), np.asarray(j_share.to_ints()))
    want = [[0, 0, 0, 1], [0, 1, 1, 1], [0, 1, 1, 0], [1, 1, 0, 0], 0, 1]
    assert t_ops == [_opened(o) for o in j_ops] == want
    assert set(drawn) == {0, 1}


def test_king_share_injected_draws_match_reference():
    key = jax.random.PRNGKey(1)
    vals = rand_ints(np.random.default_rng(41), P, 3)

    def ref(key):
        with _jax_scope():
            return JS.king_share(JL.FpArray.from_int(
                JL.FR, np.asarray(vals, dtype=object)), key).value

    want = jax.jit(ref)(key)
    draws = jax.jit(JR.uniform_fp, static_argnums=(1, 2))(key, JL.FR, (NP, 3))
    with _torch_scope():
        got = TS.king_share(TL.FpArray.from_int(TL.FR, np.asarray(vals, dtype=object),
                                                device=CPU), None,
                            shares=fp_to_torch(draws))
        assert _opened(got.reveal()) == vals
        drawn = TS.king_share(TL.FpArray.from_int(TL.FR, np.asarray(vals, dtype=object),
                                                  device=CPU),
                              torch.Generator().manual_seed(2))
        assert _opened(drawn.reveal()) == vals
    assert got.value.bound == want.bound
    np.testing.assert_array_equal(got.value.limbs.numpy(), limbs_np(want.limbs))


def test_rand_number_bitwise_injected_draws_match_reference():
    key = jax.random.PRNGKey(3)

    def ref(key):
        with _jax_scope():
            bits, val = JB.rand_number_bitwise(key, JL.FR, (2,), attempts=8)
            return bits.reveal(), val.reveal()

    j_bits, j_val = jax.jit(ref)(key)
    raw = _bernoulli_draws(key, (2, 8, NBITS))
    with _torch_scope():
        bits, val = TB.rand_number_bitwise(None, TL.FR, (2,), attempts=8, raw=raw)
        t_bits, t_val = _opened(bits.reveal()), _opened(val.reveal())
    assert t_bits == _opened(j_bits)
    assert t_val == _opened(j_val)
    for row, v in zip(t_bits, t_val):
        assert sum(int(b) << i for i, b in enumerate(row)) == v < P


def _run_port(name, inputs, gen):
    """The port's protocol ``name`` on the shares ``inputs``: (opened ints,
    openings counted)."""
    with _torch_scope() as c:
        w = {n: _twire(v) for n, v in inputs.items()}
        out = {
            "eqz": lambda: TB.equality_zero(w["eqz"], gen, attempts=8),
            "half": lambda: TB.is_smaller_or_equal_than_mod_minus_one_div_two(
                w["half"], gen, attempts=8),
            "lt": lambda: TB.less_than(w["lt_x"], w["lt_y"], gen, attempts=8),
            "bd": lambda: TB.bit_decomposition(w["bd"], gen, attempts=8),
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


# openings of equality-zero at attempts = 8, for any batch: two products
# each (d and e) for bit_rand (2), the comparison with p (8 suffix-or
# levels), the prefix products over the attempts (3 levels), the selection
# (2) and the AND tree (8 levels), and one for x + r
EQZ_ROUNDS = 2 * (2 + 8 + 3 + 2 + 8) + 1


@pytest.mark.parametrize("name", BF.PROTOCOLS)
def test_protocol_opens_like_reference_fixture(name):
    """Equality-zero, the half-range test, less-than and the bit
    decomposition against the JAX package's opened outputs
    (`fixtures/make_torch_bits_fixture.py`) and host ints."""
    fx = BF.load(np.load(BF.PATH))
    got, rounds = _run_port(name, fx["inputs"], torch.Generator().manual_seed(8))
    assert got == fx["opened"][name] == _want(name, fx["inputs"])
    if name == "eqz":
        assert rounds == EQZ_ROUNDS + 1        # and the test's own opening


@pytest.mark.slow
def test_protocols_against_live_reference():
    """Regenerates the fixture's outputs from the JAX package (about two
    minutes on a CPU) and holds the port against them."""
    fx = BF.load(BF.generate())
    for name in BF.PROTOCOLS:
        got, _ = _run_port(name, fx["inputs"], torch.Generator().manual_seed(9))
        assert got == fx["opened"][name] == _want(name, fx["inputs"])


@pytest.fixture(scope="module")
def adder_cases():
    """Bit-vector adders and the shared inverse: inputs, JAX's opened
    outputs (one jit) and the expected host ints."""
    rng = np.random.default_rng(43)
    a_int, b_int = rand_ints(rng, P, 3), rand_ints(rng, P, 3)
    inv_x, div_y = rand_ints(rng, P, 3), rand_ints(rng, P, 3)
    inputs = {k: _shares(rng, v) for k, v in (
        ("a_bits", [_bits_of(v) for v in a_int]), ("b_bits", [_bits_of(v) for v in b_int]),
        ("inv_x", inv_x), ("div_y", div_y))}

    def ref(w):
        with _jax_scope():
            w = {n: JS.MpcFp(v, JS.SHARED) for n, v in w.items()}
            outs = {
                "bitwise_lt": JB.bitwise_lt(w["a_bits"], w["b_bits"]),
                "carries": JB.carries(w["a_bits"], w["b_bits"]),
                "bit_add": JB.bit_add(w["a_bits"], w["b_bits"]),
                "inv": JS.beaver_inv(w["inv_x"]),
                "div": JS.beaver_div(w["inv_x"], w["div_y"]),
            }
            return {n: o.reveal() for n, o in outs.items()}

    got = jax.jit(ref)({n: JL.FpArray.from_int(JL.FR, v) for n, v in inputs.items()})
    want = {
        "bitwise_lt": [int(a < b) for a, b in zip(a_int, b_int)],
        "carries": [[(a % (1 << (i + 1)) + b % (1 << (i + 1))) >> (i + 1)
                     for i in range(NBITS)] for a, b in zip(a_int, b_int)],
        "bit_add": [_bits_of(a + b, NBITS + 1) for a, b in zip(a_int, b_int)],
        "inv": [pow(x, -1, P) for x in inv_x],
        "div": [x * pow(y, -1, P) % P for x, y in zip(inv_x, div_y)],
    }
    return inputs, {n: _opened(v) for n, v in got.items()}, want


@pytest.mark.parametrize("name", ["bitwise_lt", "carries", "bit_add", "inv", "div"])
def test_adders_and_inverse_open_like_reference(adder_cases, name):
    inputs, ref, want = adder_cases
    got, _ = _run_port(name, inputs, None)
    assert got == ref[name] == want[name]
