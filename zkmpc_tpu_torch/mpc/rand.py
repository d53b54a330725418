"""Randomness helpers: batched uniform field elements from a party's
private ChaCha20 stream or a replicated torch.Generator.

Port of ``zkmpc_tpu/mpc/rand.py``.  JAX's threefry bits cannot be
reproduced in torch, so a test that needs the reference's field elements
injects them: ``uniform_fp(..., bits=(hi, lo))`` takes the two raw 32-bit
draws ``[..., nlimbs]`` the reference's ``_raw_half_range`` would draw.
`coin_toss` is the parties' commit-then-open toss for public randomness no
party can predict (the MAC checks' weights).

Private draws (a party's share of a random value, its random bits, the
masks it deals) take `PartyGenerators`: for each party the process plays,
the ChaCha20 keystream keyed by that party's own 256-bit seed (32 bytes
of `secrets` by default), as the reference's parties draw from
``StdRng::from_entropy``.  Each draw takes the next words of the stream
(`compat.chacha.keystream_words`, vectorised with numpy on the host, then
copied to the party's device): a raw limb is a word masked to 15 bits, a
bit is a keystream bit.  So party i's rows are the same whether one
process plays every party or party i runs alone on a socket or a mesh
rank.  A single replicated ``torch.Generator`` stands for a key every
party knows; only a transport that holds every row (one process playing
all parties) accepts it for a private draw.
"""

from __future__ import annotations

import hashlib
import operator
import secrets

import numpy as np
import torch

from ..compat.chacha import keystream_words
from ..ops.limbs import MASK, W, FieldSpec, FpArray

_I64 = torch.int64


def _raw_half_range(raw, spec: FieldSpec) -> FpArray:
    """Raw draws -> value uniform over [0, 2^b), b = 15*nlimbs - 1 (top bit
    cleared so the value is < R/2, inside every op's bound budget)."""
    limbs = raw & MASK
    limbs[..., -1] &= MASK >> 1
    return FpArray(limbs, spec, spec.mul_bound_budget).tighten()


class ChaChaStream:
    """One party's private stream: the ChaCha20 keystream keyed by its
    32-byte seed, with stream id ``stream`` (state words 14-15), read from
    word 0 on; ``device``: where its draws go."""

    def __init__(self, seed: bytes, stream: int = 0, device="cuda"):
        self.seed = seed
        self.stream = stream
        self.device = torch.device(device)
        self.position = 0

    def words(self, n: int) -> np.ndarray:
        """The next ``n`` keystream words (uint32, on the host)."""
        out = keystream_words(self.seed, self.stream, self.position, n)
        self.position += n
        return out

    def bits(self, shape) -> torch.Tensor:
        """The next keystream bits as a bool tensor [*shape] on the
        stream's device: bit b of word w is bit 32 w + b."""
        shape = tuple(shape)
        n = int(np.prod(shape, dtype=np.int64))
        words = self.words(-(-n // 32)).astype("<u4")
        flat = np.unpackbits(words.view(np.uint8), bitorder="little")[:n]
        return torch.from_numpy(flat.astype(bool).reshape(shape)).to(self.device)


def draw_bits(generator, spec: FieldSpec, shape):
    """Raw 15-bit limb draws [*shape, nlimbs], made on the generator's
    device: from a party's `ChaChaStream`, one keystream word a limb masked
    to 15 bits; from a replicated torch.Generator, its own draws."""
    shape = tuple(shape) + (spec.nlimbs,)
    if isinstance(generator, ChaChaStream):
        n = int(np.prod(shape, dtype=np.int64))
        words = generator.words(n).astype(np.int64) & MASK
        return torch.from_numpy(words.reshape(shape)).to(generator.device)
    return torch.randint(0, 1 << W, shape, generator=generator, dtype=_I64,
                         device=generator.device)


def uniform_fp(generator, spec: FieldSpec, shape=(), device="cuda",
               bits=None) -> FpArray:
    """Uniform field elements (Montgomery domain) with negligible bias.

    Double-width sampling: X = hi * 2^b + lo uniform over [0, 2^{2b}) with
    b = 15*nlimbs - 1 >= |p|, reduced mod p with one Montgomery multiply by
    repr(2^b).  ``bits``: optional injected (hi, lo) raw draws."""
    if bits is None:
        bits = (draw_bits(generator, spec, shape), draw_bits(generator, spec, shape))
    hi_raw, lo_raw = (torch.as_tensor(b, dtype=_I64).to(device).clone()
                      for b in bits)
    hi = _raw_half_range(hi_raw, spec)
    lo = _raw_half_range(lo_raw, spec)
    kconst = FpArray.from_int(spec, pow(2, W * spec.nlimbs - 1, spec.p),
                              device=device)
    return hi * kconst.broadcast_to(hi.shape) + lo


def seed_bytes(seed) -> bytes:
    """A private seed as its 32 bytes: ``bytes`` of length 32, or an int
    below 2^256 (32 little-endian bytes)."""
    if isinstance(seed, (bytes, bytearray)):
        if len(seed) != 32:
            raise ValueError(f"a private seed is 32 bytes, not {len(seed)}")
        return bytes(seed)
    v = operator.index(seed)
    if not 0 <= v < 1 << 256:
        raise ValueError(f"a private seed is an int in [0, 2^256), not {v}")
    return v.to_bytes(32, "little")


class PartyGenerators:
    """The private streams of the parties this process plays: party i's is
    the ChaCha20 keystream keyed by party i's own 256-bit seed and makes
    every private draw of party i's row.  ``seeds``: {party: seed}, or a
    sequence in the order of ``party_ids``, each 32 bytes or an int below
    2^256 (`seed_bytes`); by default each seed is 32 bytes of the
    process's own entropy (`secrets.token_bytes`), which no other process
    can know.  ``stream``: the stream id of every party's keystream."""

    def __init__(self, party_ids, seeds=None, device="cuda", stream: int = 0):
        ids = list(party_ids)
        if seeds is None:
            seeds = {i: secrets.token_bytes(32) for i in ids}
        elif not isinstance(seeds, dict):
            seeds = list(seeds)
            if len(seeds) != len(ids):
                raise ValueError(f"{len(seeds)} private seeds for the {len(ids)} parties "
                                 f"{ids}")
            seeds = dict(zip(ids, seeds))
        missing = [i for i in ids if i not in seeds]
        if missing:
            raise ValueError(f"no private seed for parties {missing}")
        self.device = torch.device(device)
        self.seeds = {i: seed_bytes(seeds[i]) for i in ids}
        self._streams = {i: ChaChaStream(s, stream, self.device) for i, s in self.seeds.items()}

    @classmethod
    def for_transport(cls, transport, seeds=None) -> "PartyGenerators":
        """The streams of ``transport``'s rows, on its device."""
        return cls(transport.row_ids, seeds, transport.device)

    @property
    def party_ids(self) -> list:
        return list(self._streams)

    def __getitem__(self, party: int) -> ChaChaStream:
        if party not in self._streams:
            raise ValueError(f"party {party}'s private stream is not held here "
                             f"(this process plays {self.party_ids})")
        return self._streams[party]

    def stream(self, k: int) -> "PartyGenerators":
        """Stream ``k`` of a run: every party's keystream under the same
        seed with stream id ``k``, read from its start."""
        return PartyGenerators(self.party_ids, self.seeds, self.device, stream=k)


def _is_private(generator, transport) -> bool:
    """Whether ``generator`` holds per-party generators (each row of
    ``transport`` must be among them); a replicated generator is taken only
    by a transport holding every row, since a socket party would otherwise
    draw, and so know, every party's private values."""
    if isinstance(generator, PartyGenerators):
        for i in transport.row_ids:
            generator[i]                    # raises for a party not held here
        return True
    if not transport.holds_all_rows:
        raise ValueError("a private draw on a transport that plays one party takes that "
                         "party's own generator (rand.PartyGenerators), not a replicated "
                         "torch.Generator: a replicated generator lets every process "
                         "recompute every party's draws")
    return False


def uniform_rows(generator, spec: FieldSpec, transport, shape=()) -> FpArray:
    """This process's rows [rows, *shape] of a private uniform draw made for
    every party: party i's row from its own generator, or, with a
    replicated generator (a transport holding every row), rows of one
    [P, *shape] draw."""
    shape = tuple(shape)
    dev = transport.device
    if not _is_private(generator, transport):
        return uniform_fp(generator, spec, (transport.n_parties,) + shape, device=dev)
    return FpArray.concat([uniform_fp(generator[i], spec, (1,) + shape, device=dev)
                           for i in transport.row_ids], axis=0)


def bit_rows(generator, transport, shape=()):
    """This process's rows [rows, *shape] of private uniform bits (bool),
    drawn as `uniform_rows` draws field elements."""
    shape = tuple(shape)
    if not _is_private(generator, transport):
        return torch.rand((transport.n_parties,) + shape, generator=generator,
                          device=generator.device) < 0.5
    return torch.stack([generator[i].bits(shape) for i in transport.row_ids], dim=0)


def dealer_draw(generator, spec: FieldSpec, transport, dealer: int, shape):
    """The uniform draw [*shape] that party ``dealer`` makes from its own
    generator to deal shares (None in a process that does not play it);
    a replicated generator draws in every process."""
    if not _is_private(generator, transport):
        return uniform_fp(generator, spec, tuple(shape), device=transport.device)
    if not transport.holds(dealer):
        return None
    return uniform_fp(generator[dealer], spec, tuple(shape), device=transport.device)


def _commitment(party: int, seed: bytes) -> bytes:
    return hashlib.sha256(bytes([party]) + seed).digest()


def coin_toss(transport, seeds=None, openings=None) -> int:
    """A public 63-bit seed no party can predict or bias alone: a
    commit-then-open coin toss.  Each party draws a private 32-byte seed
    from its own entropy source (``seeds``: injected, one per party) and
    broadcasts its hash commitment; once every commitment is in, each
    opens its seed (``openings``: what each party opens, by default its
    seed).  Every party checks every opening against its commitment, and
    the result is a hash of all the seeds.  One round of commitments and
    one of openings through the transport, so its `CommStats` counts
    them.  A process draws, commits and opens only the seeds of the parties
    it plays (its rows), on tensors [rows, P, 32]."""
    n = transport.n_parties
    ids = transport.row_ids
    if seeds is None:
        seeds = {i: secrets.token_bytes(32) for i in ids}
    openings = seeds if openings is None else openings

    def tensor(rows):
        return torch.tensor([list(r) for r in rows], dtype=torch.uint8,
                            device=transport.device)
    seen = transport.all_gather(tensor(_commitment(i, seeds[i]) for i in ids))
    opened = transport.all_gather(tensor(openings[i] for i in ids)).cpu().numpy()
    seen = seen.cpu().numpy()                                   # [holder, party, 32]
    for holder in range(len(ids)):
        for i in range(n):
            if _commitment(i, opened[holder, i].tobytes()) != seen[holder, i].tobytes():
                raise AssertionError(f"coin toss: party {i}'s opening does not match "
                                     f"its commitment")
    digest = hashlib.sha256(b"".join(opened[0, i].tobytes() for i in range(n))).digest()
    return int.from_bytes(digest[:8], "little") >> 1
