"""Radix-2 NTT and polynomial evaluation domains.

Port of ``zkmpc_tpu/ops/ntt.py`` with arkworks ``Radix2EvaluationDomain``
semantics: ``fft(coeffs)[i] = f(omega^i)``, ``ifft`` inverts it, and the
coset variants evaluate over g*H with g the field's multiplicative
generator.  The butterfly network is a per-stage Python loop; each of the
log2(n) stages is one batched Montgomery multiply plus lazy add/sub over
the whole array.  Shares are additively linear, so the same NTT runs on
secret-shared tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..spec import field as specfield
from .limbs import FieldSpec, FpArray


@functools.lru_cache(maxsize=None)
def _domain_tables(spec: FieldSpec, n: int):
    """Host-precomputed integer tables for a size-n domain."""
    assert n & (n - 1) == 0 and n >= 1
    log_n = n.bit_length() - 1
    assert spec.two_adicity is not None and log_n <= spec.two_adicity, (
        f"domain size 2^{log_n} exceeds 2-adicity of {spec.name}")
    p = spec.p
    omega = specfield.root_of_unity(p, spec.generator, spec.two_adicity, n)
    omega_inv = pow(omega, -1, p) if n > 1 else 1
    n_inv = pow(n, -1, p)
    g = spec.generator % p
    g_inv = pow(g, -1, p)
    i = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return omega, omega_inv, n_inv, g, g_inv, rev


def _powers(w: int, count: int, p: int):
    out, acc = [], 1
    for _ in range(count):
        out.append(acc)
        acc = acc * w % p
    return out


class Domain:
    """Radix-2 evaluation domain over ``spec`` of power-of-two size ``n``,
    with its tables on ``device``."""

    _cache: dict = {}

    def __new__(cls, spec: FieldSpec, n: int, device="cuda"):
        key = (spec, n, str(torch.device(device)))
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        cls._cache[key] = self
        self._init(spec, n, torch.device(device))
        return self

    def _init(self, spec, n, device):
        self.spec = spec
        self.n = n
        self.device = device
        self.log_n = n.bit_length() - 1
        omega, omega_inv, n_inv, g, g_inv, rev = _domain_tables(spec, n)
        self.omega, self.omega_inv, self.n_inv = omega, omega_inv, n_inv
        self.coset_gen = g
        self._rev = torch.as_tensor(rev, device=device)
        p = spec.p

        def fp(ints):
            return FpArray.from_int(spec, np.asarray(ints, dtype=object),
                                    device=device)

        # stage s has block size m = 2^(s+1) and twiddles w^0..w^(m/2-1)
        # for w = omega^(n/m)
        self._tw_fwd, self._tw_inv = [], []
        for s in range(self.log_n):
            m = 1 << (s + 1)
            self._tw_fwd.append(fp(_powers(pow(omega, n // m, p), m // 2, p)))
            self._tw_inv.append(fp(_powers(pow(omega_inv, n // m, p), m // 2, p)))
        self._coset_pows = fp(_powers(g, n, p))
        self._coset_inv_pows_scaled = fp(
            [x * n_inv % p for x in _powers(g_inv, n, p)])
        self._n_inv_fp = fp(n_inv)
        # (g^n - 1)^-1: constant value of 1/Z_H on the coset
        self.vanishing_on_coset_inv = pow(pow(g, n, p) - 1, -1, p)
        self._vanish_inv_fp = fp(self.vanishing_on_coset_inv)

    # ---------------------------------------------------------------- kernels

    def _butterflies(self, x: FpArray, twiddles) -> FpArray:
        """Iterative DIT NTT given bit-reversed input. x: [..., n]."""
        n = self.n
        batch = x.shape[:-1]
        for s in range(self.log_n):
            m = 1 << (s + 1)
            half = m // 2
            y = x.reshape(batch + (n // m, m))
            even = FpArray(y.limbs[..., :half, :], y.spec, y.bound)
            odd = FpArray(y.limbs[..., half:, :], y.spec, y.bound)
            t = odd * twiddles[s]
            hi = even + t
            lo = even - t
            x = FpArray(torch.cat([hi.limbs, lo.limbs], dim=-2), y.spec,
                        max(hi.bound, lo.bound))
            x = x.reshape(batch + (n,))
        return x

    def _permute(self, x: FpArray) -> FpArray:
        return FpArray(x.limbs.index_select(-2, self._rev), x.spec, x.bound)

    def fft(self, coeffs: FpArray) -> FpArray:
        """coeffs [..., n] -> evaluations f(omega^i), i in 0..n-1."""
        assert coeffs.shape[-1] == self.n
        return self._butterflies(self._permute(coeffs), self._tw_fwd)

    def ifft(self, evals: FpArray) -> FpArray:
        assert evals.shape[-1] == self.n
        out = self._butterflies(self._permute(evals), self._tw_inv)
        return out * self._n_inv_fp

    def coset_fft(self, coeffs: FpArray) -> FpArray:
        """Evaluate over g*H: scale coeff j by g^j, then fft."""
        return self.fft(coeffs * self._coset_pows)

    def coset_ifft(self, evals: FpArray) -> FpArray:
        out = self._butterflies(self._permute(evals), self._tw_inv)
        return out * self._coset_inv_pows_scaled

    def divide_by_vanishing_poly_on_coset(self, evals: FpArray) -> FpArray:
        """Pointwise multiply coset evaluations by 1/(g^n - 1)."""
        return evals * self._vanish_inv_fp
