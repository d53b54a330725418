"""arkworks v0.3 compatibility: `test_rng`, `Fp::rand`, the Groth16 proof
blob and ark-marlin's Blake2s Fiat-Shamir RNG.

The port's copy of what it uses from ``zkmpc_tpu/compat/ark.py``: the
seeded ChaCha12 stream and the field sampling that `snark.groth16` and
`snark.kzg` draw their toxic waste from, so a setup from the same seed
gives the reference's key; the 192-byte compressed proof that the `main`
binary publishes; and the Marlin transcript (`FiatShamirRng`, the point
encodings it absorbs).  Unlike the reference's, the port's point
decompression rejects a point outside the prime-order subgroup.

Parity targets (reference file:line):
- test_rng seed + StdRng=ChaCha12: `arkworks/std/src/rand_helper.rs:31-39`,
  `arkworks/std/Cargo.toml:16` (rand 0.8 -> ChaCha12 StdRng).
- Fp sampling (limb-wise, top-bits shaved, rejection, raw limbs ARE the
  Montgomery repr): `arkworks/algebra/ff/src/fields/arithmetic.rs:194-224`.
- FiatShamirRng<Blake2s>: seed = H(bytes), absorb: seed = H(new || seed),
  ChaCha20 reseeded from the digest: `arkworks/marlin/src/rng.rs:40-70`.
- Marlin transcript init: H(b"MARLIN-2019" || index_vk || public_input)
  (`arkworks/marlin/src/lib.rs:76,163,346`).
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
    return ChaChaRng(ARK_TEST_RNG_SEED, rounds=12)


def seeded_rng(seed: int) -> ChaChaRng:
    """StdRng-semantics ChaCha12 stream for an arbitrary integer seed.
    seed == 0 is EXACTLY `ark_std::test_rng()` so setups driven by the
    default seed replay the reference's test transcripts; other seeds use
    a Blake2s-derived 32-byte seed (`StdRng::from_seed` semantics)."""
    if seed == 0:
        return test_rng()
    return ChaChaRng(hashlib.blake2s(b"zkmpc-seed:%d" % seed).digest(), rounds=12)


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


def fq_rand(rng: ChaChaRng) -> int:
    return fp_rand(rng, FQ_P, FQ_LIMBS, FQ_BITS)


# --- CanonicalSerialize of points and the Groth16 proof blob ----------------
# Parity targets: SWFlags (PositiveY = 1<<7, Infinity = 1<<6 in the top
# byte) `arkworks/algebra/serialize/src/flags.rs:63-130`; serialize_with_flags
# `algebra/ff/src/fields/macros.rs`; compressed affine points
# `algebra/ec/src/models/short_weierstrass_jacobian.rs:850-876`.

FQ_P = params.FQ_MODULUS          # 377 bits, 6 limbs
FQ_LIMBS, FQ_BITS = 6, 377
SW_INFINITY = 1 << 6
SW_POSITIVE_Y = 1 << 7
#: BLS12-377 Fq2 = Fq[u]/(u^2 - NR), NR = -5
FQ2_NONRESIDUE = FQ_P - 5


def _buffer_byte_size(bits: int) -> int:
    return (bits + 7) // 8


def fp_to_bytes(v: int, modulus_bits: int) -> bytes:
    """Fp CanonicalSerialize (no flags): canonical int, little-endian,
    ceil(modulus_bits/8) bytes.  BLS12-377: Fr -> 32, Fq -> 48."""
    return int(v).to_bytes(_buffer_byte_size(modulus_bits), "little")


def fp_serialize_with_flags(v: int, modulus_bits: int, flags: int) -> bytes:
    """Flag bits OR'd into the last byte of the
    ceil((modulus_bits + 2)/8)-byte buffer."""
    buf = bytearray(int(v).to_bytes(_buffer_byte_size(modulus_bits + 2), "little"))
    buf[-1] |= flags
    return bytes(buf)


def fp_from_bytes(b: bytes, strip_flags: bool = False) -> tuple[int, int]:
    """Inverse: (value, flags), flags the top two bits of the last byte
    when strip_flags is set."""
    flags = 0
    buf = bytearray(b)
    if strip_flags:
        flags = buf[-1] & 0xC0
        buf[-1] &= 0x3F
    return int.from_bytes(bytes(buf), "little"), flags


def fq2_to_bytes(c0: int, c1: int, flags: int | None = None) -> bytes:
    """QuadExtField: c0 then c1; flags (if any) ride on c1's last byte."""
    if flags is None:
        return fp_to_bytes(c0, FQ_BITS) + fp_to_bytes(c1, FQ_BITS)
    return fp_to_bytes(c0, FQ_BITS) + fp_serialize_with_flags(c1, FQ_BITS, flags)


def _y_is_positive(y: int, p: int) -> bool:
    """SWFlags::from_y_sign(y > -y): canonical-int comparison."""
    return y > (p - y) % p


def _fq2_y_is_positive(y0: int, y1: int) -> bool:
    """Fq2 Ord compares c1 first, then c0 (`quadratic_extension.rs:411-419`)."""
    return (y1, y0) > ((FQ_P - y1) % FQ_P, (FQ_P - y0) % FQ_P)


def g1_compressed(pt) -> bytes:
    """x with y-sign / infinity flags; 48 bytes.  pt: (x, y) ints or None."""
    if pt is None:
        return fp_serialize_with_flags(0, FQ_BITS, SW_INFINITY)
    x, y = pt
    flags = SW_POSITIVE_Y if _y_is_positive(y, FQ_P) else 0
    return fp_serialize_with_flags(x, FQ_BITS, flags)


def g2_compressed(pt) -> bytes:
    """x = (c0, c1) with flags on c1; 96 bytes.  pt: ((x0, x1), (y0, y1))
    or None."""
    if pt is None:
        return fq2_to_bytes(0, 0, SW_INFINITY)
    (x0, x1), (y0, y1) = pt
    return fq2_to_bytes(x0, x1, SW_POSITIVE_Y if _fq2_y_is_positive(y0, y1) else 0)


def g1_uncompressed(pt) -> bytes:
    """x (no flags) then y with flags (`short_weierstrass_jacobian.rs:
    865-876`); 96 bytes."""
    if pt is None:
        return fp_to_bytes(0, FQ_BITS) + fp_serialize_with_flags(0, FQ_BITS, SW_INFINITY)
    x, y = pt
    return fp_to_bytes(x, FQ_BITS) + fp_serialize_with_flags(y, FQ_BITS, 0)


def g2_uncompressed(pt) -> bytes:
    """x then y, each Fq2 (c0, c1), flags on y's c1; 192 bytes."""
    if pt is None:
        return fq2_to_bytes(0, 0) + fq2_to_bytes(0, 0, SW_INFINITY)
    (x0, x1), (y0, y1) = pt
    return fq2_to_bytes(x0, x1) + fq2_to_bytes(y0, y1, 0)


def g1_affine_to_bytes(pt) -> bytes:
    """ToBytes (the Fiat-Shamir absorb encoding, not CanonicalSerialize):
    full-width x || y || infinity byte (`short_weierstrass_jacobian.rs:
    315-322`): Fq writes 48 bytes, the bool one, 97 in all."""
    if pt is None:
        return bytes(48) + bytes(48) + b"\x01"
    x, y = pt
    return int(x).to_bytes(48, "little") + int(y).to_bytes(48, "little") + b"\x00"


def _sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks (BLS12-377 Fq has p = 1 mod 4, two-adicity 46)."""
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def _fq2_sqrt(a0: int, a1: int) -> tuple[int, int] | None:
    """A square root in Fq2 (the complex method), or None for a
    non-residue."""
    p = FQ_P
    if a1 == 0:
        r = _sqrt_mod(a0, p)
        if r is not None:
            return r, 0
        # a0 = NR * t^2 -> sqrt = t * u
        t = _sqrt_mod(a0 * pow(FQ2_NONRESIDUE, -1, p) % p, p)
        return None if t is None else (0, t)
    # the norm a0^2 - NR a1^2 must be a square in Fq
    n = _sqrt_mod((a0 * a0 - FQ2_NONRESIDUE * a1 % p * a1) % p, p)
    if n is None:
        return None
    inv2 = pow(2, -1, p)
    x0 = _sqrt_mod((a0 + n) * inv2 % p, p)
    if x0 is None:
        x0 = _sqrt_mod((a0 - n) % p * inv2 % p, p)
        if x0 is None:
            return None
    return x0, a1 * pow(2 * x0 % p, -1, p) % p


def _times_order(pt, add):
    """r * pt by double-and-add with the group law ``add`` (r the prime
    order of G1 and G2; no reduction of the scalar mod r)."""
    k, acc, base = params.FR_MODULUS, None, pt
    while k:
        if k & 1:
            acc = add(acc, base)
        base = add(base, base)
        k >>= 1
    return acc


def _in_subgroup(pt, add) -> bool:
    return _times_order(pt, add) is None


def g1_in_subgroup(pt) -> bool:
    """r * pt is infinity, for an affine point on G1's curve (y^2 = x^3 + 1):
    `_times_order` in Jacobian coordinates, with no inversion a step."""
    p = FQ_P
    x, y = pt

    def dbl(X, Y, Z):                            # dbl-2009-l; None: infinity
        if Y % p == 0:
            return None
        a, b = X * X % p, Y * Y % p
        c = b * b % p
        d = 2 * ((X + b) ** 2 - a - c) % p
        e = 3 * a % p
        X3 = (e * e - 2 * d) % p
        return X3, (e * (d - X3) - 8 * c) % p, 2 * Y * Z % p

    acc = None
    for bit in bin(params.FR_MODULUS)[2:]:
        if acc is not None:
            acc = dbl(*acc)
        if bit == "0":
            continue
        if acc is None:
            acc = (x, y, 1)
            continue
        X, Y, Z = acc                            # madd-2007-bl, pt affine
        z2 = Z * Z % p
        h = (x * z2 - X) % p
        r = 2 * (y * z2 * Z - Y) % p
        if h == 0:                               # acc = pt or -pt
            acc = None if r else dbl(x, y, 1)
            continue
        hh = h * h % p
        i = 4 * hh % p
        j = h * i % p
        v = X * i % p
        X3 = (r * r - j - 2 * v) % p
        acc = X3, (r * (v - X3) - 2 * Y * j) % p, ((Z + h) ** 2 - z2 - hh) % p
    return acc is None


def g1_decompress(b: bytes):
    """(x, y) or None from the 48-byte compressed form, on y^2 = x^3 + 1
    (BLS12-377 G1).  Raises ValueError for a point off the curve or outside
    the prime-order subgroup (G1's cofactor is not 1)."""
    from ..spec import curves as SC
    x, flags = fp_from_bytes(b, strip_flags=True)
    if flags & SW_INFINITY:
        return None
    if x >= FQ_P:
        raise ValueError("x is not a canonical field element")
    y = _sqrt_mod((pow(x, 3, FQ_P) + 1) % FQ_P, FQ_P)
    if y is None:
        raise ValueError("not on curve")
    if _y_is_positive(y, FQ_P) != bool(flags & SW_POSITIVE_Y):
        y = (FQ_P - y) % FQ_P
    if not g1_in_subgroup((x, y)):
        raise ValueError("not in the prime-order subgroup")
    return x, y


def g2_decompress(b: bytes):
    """(((x0, x1), (y0, y1)) or None) from the 96-byte compressed form, on
    y^2 = x^3 + b' over Fq2 (the D-type twist).  Raises ValueError for a
    point off the curve or outside the prime-order subgroup."""
    from ..spec import curves as SC
    x0, _ = fp_from_bytes(b[:48])
    x1, flags = fp_from_bytes(b[48:], strip_flags=True)
    if flags & SW_INFINITY:
        return None
    p = FQ_P
    if x0 >= p or x1 >= p:
        raise ValueError("x is not a canonical field element")
    x = (x0, x1)
    rhs = SC.fq2_add(SC.fq2_mul(SC.fq2_mul(x, x), x), (params.G2_B_C0, params.G2_B_C1))
    y = _fq2_sqrt(*rhs)
    if y is None:
        raise ValueError("not on curve")
    y0, y1 = y
    if _fq2_y_is_positive(y0, y1) != bool(flags & SW_POSITIVE_Y):
        y0, y1 = (p - y0) % p, (p - y1) % p
    pt = (x, (y0, y1))
    if not _in_subgroup(pt, SC.g2_add):
        raise ValueError("not in the prime-order subgroup")
    return pt


def groth16_proof_bytes(a_pt, b_pt, c_pt) -> bytes:
    """ark-groth16 `Proof::serialize` (field order a, b, c): compressed G1
    (48) + compressed G2 (96) + compressed G1 (48) = 192 bytes."""
    return g1_compressed(a_pt) + g2_compressed(b_pt) + g1_compressed(c_pt)


def groth16_proof_from_ints(proof_ints) -> bytes:
    """From `snark.groth16.proof_to_ints`' ((ax, ay), ((bx0, bx1),
    (by0, by1)), (cx, cy))."""
    a, b, c = proof_ints
    return groth16_proof_bytes(a, b, c)


def groth16_proof_from_bytes(blob: bytes):
    """Inverse of `groth16_proof_bytes`: the 192-byte blob back to
    ((ax, ay), ((bx0, bx1), (by0, by1)), (cx, cy)) host ints (None for a
    point at infinity).  Raises ValueError on a point off the curve or
    outside the prime-order subgroup."""
    if len(blob) != 192:
        raise ValueError(f"an ark Groth16 proof is 192 bytes, got {len(blob)}")
    return g1_decompress(blob[0:48]), g2_decompress(blob[48:144]), \
        g1_decompress(blob[144:192])


# --- Fiat-Shamir -----------------------------------------------------------

class FiatShamirRng:
    """ark-marlin `FiatShamirRng<Blake2s>` (`rng.rs:40-70`): seed =
    BLAKE2s-256(init bytes), a ChaCha20 stream keyed by the seed; absorb(new)
    re-seeds with BLAKE2s-256(new || seed)."""

    def __init__(self, seed_bytes: bytes):
        self.seed = hashlib.blake2s(seed_bytes).digest()
        self.r = ChaChaRng(self.seed, rounds=20)

    def absorb(self, material: bytes):
        self.seed = hashlib.blake2s(material + self.seed).digest()
        self.r = ChaChaRng(self.seed, rounds=20)

    def next_u32(self) -> int:
        return self.r.next_u32()

    def next_u64(self) -> int:
        return self.r.next_u64()

    def fr_challenge(self) -> int:
        """`F::rand(&mut fs_rng)`, what the Marlin verifier's rounds draw
        (`ahp/verifier.rs:59-98`)."""
        return fr_rand(self.r)


def marlin_fs_init(index_vk_bytes: bytes, public_input_ints) -> FiatShamirRng:
    """Transcript head: H(PROTOCOL_NAME || index_vk || public_input)
    (`marlin/src/lib.rs:163,346`); public inputs as full-width Fr limbs
    (ToBytes, 32 bytes little-endian each)."""
    buf = b"MARLIN-2019" + index_vk_bytes
    for v in public_input_ints:
        buf += int(v).to_bytes(32, "little")
    return FiatShamirRng(buf)
