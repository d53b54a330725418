"""Pure-Python ChaCha keystream matching Rust's `rand_chacha` (v0.3), the
RNG behind both arkworks' `test_rng()` (rand 0.8 `StdRng` = ChaCha12, fixed
seed, `arkworks/std/src/rand_helper.rs:31-39`) and ark-marlin's
`FiatShamirRng` (`ChaChaRng` = ChaCha20 reseeded per absorb,
`arkworks/marlin/src/rng.rs:40-70`).

The port's copy of what it uses from ``zkmpc_tpu/compat/chacha.py``: the
stream that `compat.ark.fr_rand` draws the setups' toxic waste from, and
the Marlin transcript's.

Layout (djb's original ChaCha, as used by rand_chacha): state words 0-3 are
the "expand 32-byte k" constants, 4-11 the key (LE u32s), 12-13 a 64-bit
block counter starting at 0, 14-15 the 64-bit stream id (0 for SeedableRng).
The RNG buffers 4 blocks (64 u32 words) at a time and serves `next_u32` /
`next_u64` with rand_core `BlockRng` semantics -- the word-consumption
rules (a u64 straddling a buffer edge) are reproduced exactly so the
stream stays compatible.

`keystream_words` makes the same words in bulk with numpy, vectorised over
blocks: the parties' private streams (`mpc.rand.PartyGenerators`) draw
from it.
"""

from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK32


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha_block(state16, rounds: int = 20):
    """One ChaCha block: ``rounds`` rounds over a copy of the 16-word
    state, then the feed-forward addition.  Returns 16 output words."""
    x = list(state16)
    for _ in range(rounds // 2):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [(a + b) & _MASK32 for a, b in zip(x, state16)]


class ChaChaRng:
    """rand_chacha-compatible stream RNG: ``rounds=20`` is `ChaCha20Rng`
    (ark-marlin's FiatShamirRng core), ``rounds=12`` `ChaCha12Rng` (= rand
    0.8's `StdRng`, arkworks' test_rng)."""

    BUF_WORDS = 64          # rand_chacha generates 4 blocks per refill

    def __init__(self, seed: bytes, rounds: int = 20):
        assert len(seed) == 32
        assert rounds in (8, 12, 20)
        self.rounds = rounds
        self.key = [int.from_bytes(seed[i * 4:i * 4 + 4], "little")
                    for i in range(8)]
        self.counter = 0    # 64-bit block counter
        self.stream = 0     # 64-bit stream id (words 14-15)
        self.buf: list[int] = []
        self.index = self.BUF_WORDS

    def _refill(self):
        out = []
        for _ in range(4):
            st = list(_CONSTANTS) + self.key + [
                self.counter & _MASK32, (self.counter >> 32) & _MASK32,
                self.stream & _MASK32, (self.stream >> 32) & _MASK32]
            out.extend(chacha_block(st, self.rounds))
            self.counter = (self.counter + 1) & 0xFFFFFFFFFFFFFFFF
        self.buf = out

    def _generate_and_set(self, consumed: int):
        self._refill()
        self.index = consumed

    def next_u32(self) -> int:
        if self.index >= self.BUF_WORDS:
            self._generate_and_set(0)
        v = self.buf[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        # rand_core BlockRng::next_u64 edge-case semantics
        if self.index < self.BUF_WORDS - 1:
            lo, hi = self.buf[self.index], self.buf[self.index + 1]
            self.index += 2
            return (hi << 32) | lo
        if self.index >= self.BUF_WORDS:
            self._generate_and_set(2)
            return (self.buf[1] << 32) | self.buf[0]
        lo = self.buf[self.BUF_WORDS - 1]
        self._generate_and_set(1)
        return (self.buf[0] << 32) | lo


def _quarter_np(x, a, b, c, d):
    """`_quarter` on rows of a [16, n] uint32 array, in place."""
    x[a] += x[b]
    x[d] ^= x[a]
    x[d] = (x[d] << 16) | (x[d] >> 16)
    x[c] += x[d]
    x[b] ^= x[c]
    x[b] = (x[b] << 12) | (x[b] >> 20)
    x[a] += x[b]
    x[d] ^= x[a]
    x[d] = (x[d] << 8) | (x[d] >> 24)
    x[c] += x[d]
    x[b] ^= x[c]
    x[b] = (x[b] << 7) | (x[b] >> 25)


def chacha_blocks(seed: bytes, stream: int, first_block: int, n_blocks: int,
                  rounds: int = 20) -> np.ndarray:
    """Blocks ``first_block`` .. ``first_block + n_blocks - 1`` of the
    keystream keyed by the 32-byte ``seed`` with stream id ``stream``, in
    `ChaChaRng`'s state layout: [n_blocks, 16] uint32 words.  Every step
    is one numpy operation over all the blocks."""
    assert len(seed) == 32 and rounds in (8, 12, 20)
    key = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
    counters = np.arange(first_block, first_block + n_blocks, dtype=np.uint64)
    init = np.empty((16, n_blocks), dtype=np.uint32)
    init[0:4] = np.asarray(_CONSTANTS, dtype=np.uint32)[:, None]
    init[4:12] = key[:, None]
    init[12] = (counters & np.uint64(_MASK32)).astype(np.uint32)
    init[13] = (counters >> np.uint64(32)).astype(np.uint32)
    init[14] = stream & _MASK32
    init[15] = (stream >> 32) & _MASK32
    x = init.copy()
    for _ in range(rounds // 2):
        _quarter_np(x, 0, 4, 8, 12)
        _quarter_np(x, 1, 5, 9, 13)
        _quarter_np(x, 2, 6, 10, 14)
        _quarter_np(x, 3, 7, 11, 15)
        _quarter_np(x, 0, 5, 10, 15)
        _quarter_np(x, 1, 6, 11, 12)
        _quarter_np(x, 2, 7, 8, 13)
        _quarter_np(x, 3, 4, 9, 14)
    x += init
    return x.T


def keystream_words(seed: bytes, stream: int, start: int, n: int,
                    rounds: int = 20) -> np.ndarray:
    """Words ``start`` .. ``start + n - 1`` (uint32) of the keystream that
    `ChaChaRng` with this seed, ``rounds`` and stream id serves through
    `next_u32`: the blocks in counter order, 16 words a block."""
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    first, last = start // 16, (start + n - 1) // 16
    words = chacha_blocks(seed, stream, first, last - first + 1, rounds).reshape(-1)
    off = start - 16 * first
    return words[off:off + n]
