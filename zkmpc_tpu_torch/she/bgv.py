"""BGV-style somewhat-homomorphic encryption (DPSZ11 §6 concrete scheme).

Port of ``zkmpc_tpu/she/bgv.py``: plaintext space R_p with p = BLS12-377
Fr (SIMD slots via CRT packing of X^N + 1), ciphertext space R_q with
q = MNT4-753 Fq (753-bit), keys b = a*s + p*e with gaussian s, e;
encryption (c0, c1) = (b*v + p*e0 + m, a*v + p*e1); degree-2 decryption
c0 - s*c1 - s^2*c2 followed by centered reduction mod p.

Everything is batched: a leading batch axis on any ciphertext component
encrypts or multiplies many ciphertexts at once.  Random draws come from
an explicit ``torch.Generator`` or are injected (``draws=``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..ops.limbs import FR, MNT4Q, FpArray
from ..ops.ntt import Domain
from ..spec import field as SF
from . import ring

P = FR.p


@dataclasses.dataclass
class SheParams:
    n: int                  # ring degree N (power of two); also slot count
    sigma: float = 3.2


@dataclasses.dataclass
class SecretKey:
    s: FpArray              # R_q element [n]

    def s_squared(self):
        return ring.negacyclic_mul(self.s, self.s)


@dataclasses.dataclass
class PublicKey:
    a: FpArray              # uniform R_q [n]
    b: FpArray              # a*s + p*e


@dataclasses.dataclass
class Ciphertext:
    """c0 - s*c1 - s^2*c2; fresh encryptions have c2 = 0."""
    c0: FpArray
    c1: FpArray
    c2: FpArray

    def __add__(self, other: "Ciphertext"):
        return Ciphertext(self.c0 + other.c0, self.c1 + other.c1,
                          self.c2 + other.c2)

    def __sub__(self, other: "Ciphertext"):
        return Ciphertext(self.c0 - other.c0, self.c1 - other.c1,
                          self.c2 - other.c2)

    def mul(self, other: "Ciphertext"):
        """Tensor multiply of two degree-1 ciphertexts
        (`src/she/ciphertext.rs:113-122`)."""
        m = ring.negacyclic_mul
        c0 = m(self.c0, other.c0)
        c1 = m(self.c0, other.c1) + m(self.c1, other.c0)
        c2 = -m(self.c1, other.c1)
        return Ciphertext(c0, c1, c2)

    def mul_plain(self, m_rq: FpArray) -> "Ciphertext":
        """Multiply by a public plaintext polynomial (degree-preserving)."""
        m = ring.negacyclic_mul
        return Ciphertext(m(self.c0, m_rq), m(self.c1, m_rq),
                          m(self.c2, m_rq))


@functools.lru_cache(maxsize=None)
def _p_in_q(device) -> FpArray:
    return FpArray.from_int(MNT4Q, np.asarray(P, dtype=object), device=device)


def keygen(params: SheParams, generator, device="cuda") -> tuple[SecretKey, PublicKey]:
    s = ring.gaussian_coeffs(generator, params.n, sigma=params.sigma, device=device)
    a = ring.uniform_rq(generator, params.n, device=device)
    e = ring.gaussian_coeffs(generator, params.n, sigma=params.sigma, device=device)
    b = ring.negacyclic_mul(a, s) + e * _p_in_q(a.device)
    return SecretKey(s), PublicKey(a, b)


@dataclasses.dataclass
class EncRandomness:
    v: FpArray
    e0: FpArray
    e1: FpArray


def sample_enc_randomness(params: SheParams, generator, shape=(), device="cuda",
                          draws=None) -> EncRandomness:
    """(v, e0, e1) gaussian in R_q, each [*shape, n].  ``draws``: optional
    injected gaussian integers (v, e0, e1), each [*shape, n]."""
    dv, d0, d1 = draws or (None, None, None)
    g = functools.partial(ring.gaussian_coeffs, generator, params.n, shape,
                          params.sigma, device)
    return EncRandomness(g(draws=dv), g(draws=d0), g(draws=d1))


def encrypt_rq(pk: PublicKey, m_rq: FpArray, r: EncRandomness) -> Ciphertext:
    """Encrypt an already-lifted R_q message polynomial [..., n]."""
    p = _p_in_q(m_rq.device)
    c0 = ring.negacyclic_mul(pk.b, r.v) + r.e0 * p + m_rq
    c1 = ring.negacyclic_mul(pk.a, r.v) + r.e1 * p
    return Ciphertext(c0, c1, FpArray.zeros(MNT4Q, c0.shape, c0.device))


def decrypt_rq(sk: SecretKey, ct: Ciphertext) -> FpArray:
    """-> centered R_q representative of the plaintext polynomial mod p."""
    t = ct.c0 - ring.negacyclic_mul(sk.s, ct.c1)
    s2 = sk.s_squared()
    t = t - ring.negacyclic_mul(s2, ct.c2)
    return t


# ---------------------------------------------------------- slot packing


@functools.lru_cache(maxsize=None)
def _slot_tables(n: int, device):
    """Fr-side twist vectors for evaluating at the 2n-th roots (CRT slots)."""
    psi = SF.root_of_unity(P, FR.generator, FR.two_adicity, 2 * n)
    psi_inv = pow(psi, -1, P)
    fwd = FpArray.from_int(
        FR, np.asarray([pow(psi, j, P) for j in range(n)], dtype=object), device=device)
    inv = FpArray.from_int(
        FR, np.asarray([pow(psi_inv, j, P) for j in range(n)], dtype=object),
        device=device)
    return fwd, inv


def encode(slots: FpArray) -> FpArray:
    """Fr slots [..., n] -> Fr coefficient polynomial with m(psi^(2i+1)) =
    slot_i (an inverse twisted NTT)."""
    n = slots.shape[-1]
    if n == 1:
        return slots
    _, inv = _slot_tables(n, slots.device)
    return Domain(FR, n, slots.device).ifft(slots) * inv


def decode(coeffs: FpArray) -> FpArray:
    n = coeffs.shape[-1]
    if n == 1:
        return coeffs
    fwd, _ = _slot_tables(n, coeffs.device)
    return Domain(FR, n, coeffs.device).fft(coeffs * fwd)


def encrypt_slots(pk: PublicKey, params: SheParams, slots: FpArray,
                  r: EncRandomness) -> Ciphertext:
    m_rq = ring.lift_centered_p_to_q(encode(slots))
    return encrypt_rq(pk, m_rq, r)


def decrypt_slots(sk: SecretKey, ct: Ciphertext) -> FpArray:
    t = decrypt_rq(sk, ct)
    coeffs = ring.reduce_centered_q_to_p(t)
    return decode(coeffs)
