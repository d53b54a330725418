"""Ciphertext ring R_q = Z_q[X]/(X^N + 1) with q = MNT4-753's 753-bit prime.

Port of ``zkmpc_tpu/she/ring.py``.  A product in R_q is a negacyclic NTT
multiply over the same modulus: psi-twist, size-N NTT (`ops.ntt.Domain`
over MNT4Q), pointwise product, inverse NTT, inverse twist.  Every
Montgomery product is K1 at 51 limbs on a CUDA tensor.  Batched limb
tensors: a leading batch axis multiplies many ciphertexts at once.

Also the cross-field conversion: plaintext polynomials over Fr (the
BLS12-377 scalar field, the SPDZ modulus p) lift centered into R_q, and R_q
results reduce centered back mod p.

Random draws come from an explicit ``torch.Generator`` (made on the
generator's device), or are injected: JAX's threefry draws cannot be
reproduced in torch, so ``uniform_rq(bits=...)`` takes the raw limb draws
and ``gaussian_coeffs(draws=...)`` the rounded gaussian integers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..mpc import rand as R
from ..ops.limbs import (FR, MNT4Q, W, FieldSpec, FpArray, _mont_mul_limbs,
                         _resolve2, fp_from_u32, fp_geq_const, int_to_limbs)
from ..ops.ntt import Domain
from ..spec import field as SF

Q = MNT4Q.p
P = FR.p

_I64 = torch.int64


@functools.lru_cache(maxsize=None)
def _twist_tables(spec: FieldSpec, n: int, device):
    """(psi, psi^j, psi^-j) for the negacyclic wrap: the twist vectors as
    FpArrays on ``device``.  psi is a 2n-th root of unity, so 2n must divide
    q - 1: n <= 2^14 for MNT4Q (2-adicity 15)."""
    p = spec.p
    psi = SF.root_of_unity(p, spec.generator, spec.two_adicity, 2 * n)
    psi_inv = pow(psi, -1, p)
    fwd = FpArray.from_int(spec, np.asarray([pow(psi, j, p) for j in range(n)],
                                            dtype=object), device=device)
    inv = FpArray.from_int(spec, np.asarray([pow(psi_inv, j, p) for j in range(n)],
                                            dtype=object), device=device)
    return psi, fwd, inv


def _tables(a: FpArray):
    return _twist_tables(a.spec, a.shape[-1], a.device)


def negacyclic_mul(a: FpArray, b: FpArray) -> FpArray:
    """[..., N] x [..., N] -> [..., N] product mod X^N + 1 (same spec)."""
    n = a.shape[-1]
    if n == 1:
        return a * b
    _, fwd, inv = _tables(a)
    dom = Domain(a.spec, n, a.device)
    fa = dom.fft(a * fwd)
    fb = dom.fft(b * fwd)
    return dom.ifft(fa * fb) * inv


def negacyclic_ntt(a: FpArray) -> FpArray:
    _, fwd, _ = _tables(a)
    return Domain(a.spec, a.shape[-1], a.device).fft(a * fwd)


def negacyclic_intt(fa: FpArray) -> FpArray:
    _, _, inv = _tables(fa)
    return Domain(fa.spec, fa.shape[-1], fa.device).ifft(fa) * inv


# --------------------------------------------------------------- sampling


def uniform_rq(generator, n: int, shape=(), device="cuda", bits=None) -> FpArray:
    """Uniform R_q elements [*shape, n] (`mpc.rand.uniform_fp` over MNT4Q;
    ``bits``: its injected (hi, lo) raw draws)."""
    return R.uniform_fp(generator, MNT4Q, tuple(shape) + (n,), device=device, bits=bits)


def gaussian_draws(generator, n: int, shape=(), sigma: float = 3.2) -> torch.Tensor:
    """Rounded normals with standard deviation sigma, int64 [*shape, n], on
    the generator's device (the reference's sampler, `src/she.rs:93-113`)."""
    g = torch.randn(tuple(shape) + (n,), generator=generator,
                    device=generator.device) * sigma
    return torch.round(g).to(_I64)


def gaussian_coeffs(generator, n: int, shape=(), sigma: float = 3.2,
                    device="cuda", draws=None) -> FpArray:
    """Discrete-gaussian-ish coefficients embedded in R_q: |v| through
    `fp_from_u32`, negated where v < 0.  ``draws``: injected integers
    [*shape, n] in place of `gaussian_draws`."""
    if draws is None:
        draws = gaussian_draws(generator, n, shape, sigma)
    v = torch.as_tensor(np.asarray(draws) if not isinstance(draws, torch.Tensor)
                        else draws).to(device=device, dtype=_I64)
    mag = fp_from_u32(MNT4Q, v.abs())
    return FpArray.select(v < 0, -mag, mag)


def small_u32_rq(vals) -> FpArray:
    return fp_from_u32(MNT4Q, vals)


# ------------------------------------------------- cross-field conversion


def lift_centered_p_to_q(x: FpArray) -> FpArray:
    """Fr (mod-p) coefficients -> R_q coefficients via centered lift:
    v <= p/2 maps to v, else to q - (p - v)."""
    assert x.spec is FR
    ints = x.int_limbs()                       # [..., 18] canonical
    is_neg = fp_geq_const(ints, FR, (P >> 1) + 1)
    nl = MNT4Q.nlimbs
    raw = torch.nn.functional.pad(ints, (0, nl - ints.shape[-1]))
    # add (q - p) where negative
    qp = torch.as_tensor(int_to_limbs(Q - P, nl), device=x.device)
    cols = raw + torch.where(is_neg[..., None], qp, torch.zeros_like(qp))
    raw2 = _resolve2(cols)[..., :nl]
    out = _mont_mul_limbs(MNT4Q, raw2, MNT4Q.const("r2_limbs", x.device))
    return FpArray(out, MNT4Q, 2)


@functools.lru_cache(maxsize=None)
def _limb_pows_mod_p(device):
    """Montgomery consts 2^(15*i) mod p for i <= MNT4Q.nlimbs, as one FpArray."""
    vals = [pow(1 << W, i, P) for i in range(MNT4Q.nlimbs + 1)]
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=device)


@functools.lru_cache(maxsize=None)
def _q_mod_p(device):
    return FpArray.from_int(FR, np.asarray(Q % P, dtype=object), device=device)


def reduce_centered_q_to_p(x: FpArray) -> FpArray:
    """R_q coefficients -> Fr via centered reduction:
    t = v if v <= q/2 else v - q; result = t mod p."""
    assert x.spec is MNT4Q
    ints = x.int_limbs()                        # [..., 51] canonical
    is_neg = fp_geq_const(ints, MNT4Q, (Q >> 1) + 1)
    pows = _limb_pows_mod_p(x.device)           # [52] Fr consts
    # m = sum_i limb_i * 2^(15 i) mod p, via scalar lift of each limb
    limbs_fr = fp_from_u32(FR, ints)            # [..., 51] Fr elements
    terms = limbs_fr * FpArray(pows.limbs[:MNT4Q.nlimbs], FR, 1)
    m = _fold_sum(terms)
    # negative case: subtract q mod p
    m_neg = m - _q_mod_p(x.device)
    return FpArray.select(is_neg, m_neg.tighten(), m.tighten())


def _fold_sum(x: FpArray) -> FpArray:
    """Sum over the last batch axis with pairwise folds."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        a = FpArray(x.limbs[..., :half, :], x.spec, x.bound)
        b = FpArray(x.limbs[..., half:2 * half, :], x.spec, x.bound)
        s = a + b
        if n % 2:
            rest = FpArray(x.limbs[..., 2 * half:, :], x.spec, x.bound)
            s = FpArray(torch.cat([s.limbs, rest.limbs], dim=-2),
                        x.spec, max(s.bound, rest.bound))
        x = s
    return FpArray(x.limbs[..., 0, :], x.spec, x.bound)
