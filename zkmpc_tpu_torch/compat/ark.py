"""arkworks v0.3 compatibility: `test_rng` and `Fp::rand`.

The port's copy of what it uses from ``zkmpc_tpu/compat/ark.py``: the
seeded ChaCha12 stream and the field sampling that `snark.groth16` draws
its toxic waste from, so a setup from the same seed gives the reference's
key.

Parity targets (reference file:line):
- test_rng seed + StdRng=ChaCha12: `arkworks/std/src/rand_helper.rs:31-39`,
  `arkworks/std/Cargo.toml:16` (rand 0.8 -> ChaCha12 StdRng).
- Fp sampling (limb-wise, top-bits shaved, rejection, raw limbs ARE the
  Montgomery repr): `arkworks/algebra/ff/src/fields/arithmetic.rs:194-224`.
"""

from __future__ import annotations

import hashlib

from .chacha import ChaChaRng
from .. import params

FR_P = params.FR_MODULUS          # 253 bits, 4 limbs
FR_LIMBS, FR_BITS = 4, 253

#: the fixed 32-byte seed of `ark_std::test_rng()` (`rand_helper.rs:33-37`)
ARK_TEST_RNG_SEED = bytes([
    1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0])


def test_rng() -> ChaChaRng:
    """`ark_std::test_rng()`: rand 0.8 StdRng (ChaCha12) with the fixed
    seed."""
    return ChaChaRng(ARK_TEST_RNG_SEED)


def seeded_rng(seed: int) -> ChaChaRng:
    """StdRng-semantics ChaCha12 stream for an arbitrary integer seed.
    seed == 0 is EXACTLY `ark_std::test_rng()` so setups driven by the
    default seed replay the reference's test transcripts; other seeds use
    a Blake2s-derived 32-byte seed (`StdRng::from_seed` semantics)."""
    if seed == 0:
        return test_rng()
    return ChaChaRng(hashlib.blake2s(b"zkmpc-seed:%d" % seed).digest())


def fp_rand(rng: ChaChaRng, p: int, nlimbs: int, modulus_bits: int) -> int:
    """`Fp::rand`: sample nlimbs u64s (low limb first), shave the bits above
    modulus_bits off the top limb, reject if >= p.  The accepted limbs are
    the MONTGOMERY representation -- the field VALUE is limbs * R^-1 mod p
    (`arithmetic.rs:200-219`)."""
    shave = 64 * nlimbs - modulus_bits
    mask = (1 << (64 - shave)) - 1 if shave < 64 else 0
    r_inv = pow(pow(2, 64 * nlimbs, p), -1, p)
    while True:
        limbs = [rng.next_u64() for _ in range(nlimbs)]
        limbs[-1] &= mask
        tmp = sum(l << (64 * i) for i, l in enumerate(limbs))
        if tmp < p:
            return tmp * r_inv % p


def fr_rand(rng: ChaChaRng) -> int:
    return fp_rand(rng, FR_P, FR_LIMBS, FR_BITS)
