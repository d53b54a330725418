"""Private draws of the port (`mpc.rand.PartyGenerators`): each party's
stream is the ChaCha20 keystream keyed by its 256-bit seed, in the word
layout of `compat.chacha.ChaChaRng` (rand_chacha's), made in bulk by the
vectorised `compat.chacha.keystream_words`; no private draw takes torch's
generators."""

import numpy as np
import pytest
import torch

from torch_parity import CPU
from zkmpc_tpu_torch import inputs as IN
from zkmpc_tpu_torch.cli import online as ON
from zkmpc_tpu_torch.compat.chacha import ChaChaRng, keystream_words
from zkmpc_tpu_torch.mpc import bits as B
from zkmpc_tpu_torch.mpc import rand as R
from zkmpc_tpu_torch.mpc.share import MpcContext, king_share, mpc_scope, rand_shared
from zkmpc_tpu_torch.ops.limbs import FR, MASK, FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport

torch.set_num_threads(1)

#: a seed above 2^63 (as an int) and one as 32 bytes
SEED_INT = (1 << 255) + (1 << 63) + 5
SEED_BYTES = bytes(range(100, 132))


def _scalar_words(seed: bytes, stream: int, n: int, rounds: int = 20) -> list:
    rng = ChaChaRng(seed, rounds)
    rng.stream = stream
    return [rng.next_u32() for _ in range(n)]


@pytest.mark.parametrize("stream", [0, 1, (1 << 64) - 3])
def test_private_draws_are_the_chacha20_keystream(stream):
    """Party i's raw limbs are its keystream words masked to 15 bits (the
    high half of a field draw first, then the low half), its bits the
    keystream's bits, for its seed and stream id."""
    gens = R.PartyGenerators([0, 1], [SEED_INT, SEED_BYTES], CPU, stream=stream)
    assert gens.seeds == {0: SEED_INT.to_bytes(32, "little"), 1: SEED_BYTES}
    for i, seed in gens.seeds.items():
        n = 3 * FR.nlimbs
        want = _scalar_words(seed, stream, 2 * n + 2)
        hi = R.draw_bits(gens[i], FR, (3,))
        lo = R.draw_bits(gens[i], FR, (3,))
        assert hi.reshape(-1).tolist() == [w & MASK for w in want[:n]]
        assert lo.reshape(-1).tolist() == [w & MASK for w in want[n:2 * n]]
        bits = gens[i].bits((5, 9))
        word = want[2 * n] | (want[2 * n + 1] << 32)
        assert bits.reshape(-1).tolist() == [bool(word >> j & 1) for j in range(45)]
        assert gens[i].position == 2 * n + 2
    # a field draw from a stream is the draw from those words injected
    g = R.PartyGenerators([0], [SEED_INT], CPU, stream=stream)[0]
    words = np.asarray(_scalar_words(SEED_INT.to_bytes(32, "little"), stream, 2 * 4 * FR.nlimbs),
                       dtype=np.int64) & MASK
    got = R.uniform_fp(g, FR, (4,), device=CPU)
    inj = R.uniform_fp(None, FR, (4,), device=CPU,
                       bits=(words[:4 * FR.nlimbs].reshape(4, -1),
                             words[4 * FR.nlimbs:].reshape(4, -1)))
    assert torch.equal(got.limbs, inj.limbs)


@pytest.mark.parametrize("rounds", [20, 12])
def test_vectorised_keystream_equals_scalar_across_buffer_edges(rounds):
    """`keystream_words` at any start equals `ChaChaRng.next_u32` (which
    refills 64 words at a time), across the buffer edge at word 64 and
    many blocks, and a stream read in pieces equals one read at once."""
    want = _scalar_words(SEED_BYTES, 7, 700, rounds)
    for start, n in ((0, 700), (60, 10), (63, 2), (64, 64), (1, 127), (250, 450)):
        assert keystream_words(SEED_BYTES, 7, start, n, rounds).tolist() == \
            want[start:start + n], (start, n)
    s = R.ChaChaStream(SEED_BYTES, 7, CPU)
    got = [w for n in (5, 59, 1, 64, 200, 3) for w in s.words(n).tolist()]
    if rounds == 20:
        assert got == want[:len(got)]
    assert keystream_words(SEED_BYTES, 7, 9, 0).shape == (0,)


def test_streams_differ_and_wide_seeds_are_taken():
    """`stream(k)` keys the same seed with stream id k (distinct streams
    differ); a seed above 2^63 is taken whole (not masked to 63 bits);
    seeds outside [0, 2^256) or not 32 bytes are refused; the default
    seeds are 32 fresh bytes a party."""
    g = R.PartyGenerators([0], [SEED_INT], CPU)
    a, b = g.stream(1)[0].words(16), g.stream(2)[0].words(16)
    assert not np.array_equal(a, b)
    assert np.array_equal(a, keystream_words(g.seeds[0], 1, 0, 16))
    low = R.PartyGenerators([0], [SEED_INT & ((1 << 63) - 1)], CPU)[0].words(16)
    assert not np.array_equal(low, R.PartyGenerators([0], [SEED_INT], CPU)[0].words(16))
    assert R.seed_bytes((1 << 256) - 1) == b"\xff" * 32
    assert R.seed_bytes(np.int64(7)) == (7).to_bytes(32, "little")
    for bad in (1 << 256, -1, b"\x00" * 31):
        with pytest.raises(ValueError):
            R.seed_bytes(bad)
    d1, d2 = R.PartyGenerators([0, 1, 2], device=CPU), R.PartyGenerators([0, 1, 2], device=CPU)
    assert all(len(s) == 32 for s in d1.seeds.values())
    assert len(set(d1.seeds.values()) | set(d2.seeds.values())) == 6
    with pytest.raises(ValueError, match="not held"):
        g[1]
    assert ON.parse_private_seed("0x" + "ab" * 32) == int("ab" * 32, 16)
    assert ON.parse_private_seed(" 123 ") == 123
    assert ON.parse_private_seed(str(SEED_INT)) == SEED_INT
    with pytest.raises(ValueError, match="0x"):
        ON.parse_private_seed("ab" * 32)


@pytest.mark.parametrize("form", ["decimal", "hex"])
def test_cli_private_seed_is_the_int_run_takes(monkeypatch, form):
    """A seed of exactly 64 decimal digits, on the command line in decimal
    or as 0x and hex digits, keys the stream that the same int given to
    `online.run(private_seeds=)` keys."""
    seed = 10 ** 63 + 987654321
    text = str(seed) if form == "decimal" else hex(seed)
    assert len(str(seed)) == 64
    got = {}

    def run(*args, private_seeds=None, **kw):
        got["seeds"] = private_seeds
        return True
    monkeypatch.setattr(ON, "run", run)
    with pytest.raises(SystemExit) as done:
        ON.main(["inputs.json", "--device", "cpu", "--private-seed", f"{text},{seed}"])
    assert done.value.code == 0
    assert got["seeds"] == [seed, seed]
    words = [R.PartyGenerators([0, 1], s, CPU)[0].words(8) for s in (got["seeds"], [seed, 1])]
    assert np.array_equal(*words)


def test_no_torch_rng_on_a_private_path(monkeypatch):
    """With `PartyGenerators`, `rand_shared`, `king_share`, `bit_rand` and
    `input_share` call none of torch's random functions; a replicated
    torch.Generator still draws through them on the stacked transport."""
    real = {name: getattr(torch, name) for name in ("rand", "randint", "randn", "randperm")}

    def refuse(*a, **k):
        raise AssertionError("a torch random function on a private path")
    for name in real:
        monkeypatch.setattr(torch, name, refuse)
    t = StackedTransport(3, CPU)
    gens = R.PartyGenerators.for_transport(t, [SEED_INT, SEED_BYTES, 3])
    with mpc_scope(MpcContext(t, "semi")):
        vals = FpArray.from_int(FR, [4, 5], device=CPU)
        outs = [rand_shared(gens, FR, (2,)), king_share(vals, gens),
                B.bit_rand(gens, FR, (2,)), IN.input_share(vals, 2, gens, shape=(2,))]
        assert [int(v) for v in outs[1].reveal().to_ints()[0]] == [4, 5]
        assert [int(v) for v in outs[3].reveal().to_ints()[0]] == [4, 5]
        assert set(int(v) for v in outs[2].reveal().to_ints()[0]) <= {0, 1}
        for name, fn in real.items():
            monkeypatch.setattr(torch, name, fn)
        rand_shared(torch.Generator().manual_seed(1), FR, (2,))
