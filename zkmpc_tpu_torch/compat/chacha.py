"""Pure-Python ChaCha12 keystream matching Rust's `rand_chacha` (v0.3)
`ChaCha12Rng`, the RNG behind arkworks' `test_rng()` (rand 0.8 `StdRng` =
ChaCha12, fixed seed, `arkworks/std/src/rand_helper.rs:31-39`).

The port's copy of what it uses from ``zkmpc_tpu/compat/chacha.py``: the
stream that `compat.ark.fr_rand` draws the setup's toxic waste from.

Layout (djb's original ChaCha, as used by rand_chacha): state words 0-3 are
the "expand 32-byte k" constants, 4-11 the key (LE u32s), 12-13 a 64-bit
block counter starting at 0, 14-15 the 64-bit stream id (0 for SeedableRng).
The RNG buffers 4 blocks (64 u32 words) at a time and serves `next_u32` /
`next_u64` with rand_core `BlockRng` semantics -- the word-consumption
rules (a u64 straddling a buffer edge) are reproduced exactly so the
stream stays compatible.
"""

from __future__ import annotations

_MASK32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
ROUNDS = 12                 # StdRng is ChaCha12


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


def chacha_block(state16):
    """One ChaCha12 block: 12 rounds over a copy of the 16-word state, then
    the feed-forward addition.  Returns 16 output words."""
    x = list(state16)
    for _ in range(ROUNDS // 2):
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
    """rand_chacha-compatible `ChaCha12Rng` (= rand 0.8's `StdRng`)."""

    BUF_WORDS = 64          # rand_chacha generates 4 blocks per refill

    def __init__(self, seed: bytes):
        assert len(seed) == 32
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
            out.extend(chacha_block(st))
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
