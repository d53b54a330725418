"""Vectorized big-integer modular arithmetic: the field compute core.

Port of ``zkmpc_tpu/ops/limbs.py``.  A field element batch is an ``int64``
tensor ``[..., nlimbs]`` of 15-bit limbs (base ``B = 2**15``) in Montgomery
form ``x·R mod p`` with ``R = B**nlimbs``.  Relaxed limbs go up to ``B + 1``
so every limb product fits 31 bits and every convolution column 26 bits:
the same headroom facts as the reference, so the same limb algorithm gives
the same limbs.  ``FpArray.bound`` is static host metadata (value <
bound·p) and decides where ``tighten`` runs, exactly as in the reference.

The Montgomery multiply (`_mont_mul_limbs`) routes to the CUDA kernel
(`cuda_fp.mont_mul`) for CUDA tensors and to its plain twin for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import params as _P

W = 15
B = 1 << W
MASK = B - 1

_I64 = torch.int64


def int_to_limbs(x: int, nlimbs: int) -> np.ndarray:
    out = np.zeros(nlimbs, dtype=np.int64)
    for i in range(nlimbs):
        out[i] = x & MASK
        x >>= W
    assert x == 0, "value does not fit in nlimbs"
    return out


def limbs_to_int(limbs) -> int:
    x = 0
    for i, l in enumerate(np.asarray(limbs, dtype=np.int64).tolist()):
        x += int(l) << (W * i)
    return x


def ints_to_limbs(ints, nlimbs: int) -> np.ndarray:
    """Nonnegative python ints -> int64 limbs [len, nlimbs], in one numpy
    pass over their little-endian 64-bit words."""
    ints = [int(x) for x in ints]
    assert all(0 <= x and x.bit_length() <= W * nlimbs for x in ints), \
        "value does not fit in nlimbs"
    if not ints:
        return np.zeros((0, nlimbs), dtype=np.int64)
    nwords = (W * nlimbs + 63) // 64 + 1
    buf = b"".join(x.to_bytes(8 * nwords, "little") for x in ints)
    words = np.frombuffer(buf, dtype="<u8").reshape(len(ints), nwords)
    starts = np.arange(nlimbs) * W
    wi = starts // 64
    sh = (starts % 64).astype(np.uint64)
    lo = words[:, wi] >> sh
    hi = (words[:, wi + 1] << ((np.uint64(64) - sh) & np.uint64(63))) * \
        (sh != 0).astype(np.uint64)
    # row-major, as the kernels read limbs (the fancy index above is not)
    return ((lo | hi) & np.uint64(MASK)).astype(np.int64, order="C")


def limbs_to_ints(limbs) -> list:
    """int64 limbs [N, n] (relaxed limbs allowed) -> python ints."""
    arr = np.asarray(limbs, dtype=np.int64)
    n = arr.shape[-1]
    weights = np.asarray([1 << (W * i) for i in range(n)], dtype=object)
    return list(arr.reshape(-1, n).astype(object) @ weights)


class FieldSpec:
    """Static (hashable) parameters + precomputed limb tables for one prime
    field.  Same limb count, tables and bound budget as the reference's
    ``FieldSpec`` (`zkmpc_tpu/ops/limbs.py:58-143`)."""

    _cache: dict = {}

    def __new__(cls, name: str, modulus: int, generator: int | None = None,
                two_adicity: int | None = None):
        key = (name, modulus)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        cls._cache[key] = self
        self._init(name, modulus, generator, two_adicity)
        return self

    def _init(self, name, p, generator, two_adicity):
        self.name = name
        self.p = p
        self.generator = generator
        self.two_adicity = two_adicity
        bits = p.bit_length()
        # minimal limb count, plus one headroom limb if B**n / p leaves too
        # little room for lazy accumulation (bound budget >= 16)
        n = -(-bits // W)
        if (B ** n) // p < 256:
            n += 1
        self.nlimbs = n
        self.R = B ** n
        assert 4 * p < self.R, (name, bits, n)
        self.r_mod_p = self.R % p
        self.r2 = self.R * self.R % p
        self.rinv = pow(self.R, -1, p)
        self.pprime = (-pow(p, -1, self.R)) % self.R

        self.p_limbs = int_to_limbs(p, n)
        self.pprime_limbs = int_to_limbs(self.pprime, n)
        self.one_limbs = int_to_limbs(self.r_mod_p, n)   # Montgomery 1
        self.int_one_limbs = int_to_limbs(1, n)          # raw integer 1
        self.r2_limbs = int_to_limbs(self.r2, n)

        # bound_a * bound_b * p <= R/2 keeps a REDC output below 2p
        self.mul_bound_budget = self.R // (2 * p)
        assert self.mul_bound_budget >= 4, (name, self.mul_bound_budget)
        self.max_bound = self.R // p
        self._dev = {}

    def __repr__(self):
        return f"FieldSpec({self.name}, {self.nlimbs} limbs)"

    def __hash__(self):
        return hash((self.name, self.p))

    def __eq__(self, other):
        return self is other

    @functools.lru_cache(maxsize=None)
    def sub_digits(self, bound_b: int):
        """Borrow-free digit decomposition of k·p used for subtraction.

        Returns (digits int64 [nlimbs], k) with sum(d_j B^j) = k*p and every
        d_j above the largest limb a tensor of bound ``bound_b`` can hold, so
        ``d - b`` never goes negative."""
        n, p = self.nlimbs, self.p
        top_max = (bound_b * p) // (B ** (n - 1)) + 2
        k = max(bound_b, 1)
        while (k * p) // (B ** (n - 1)) < top_max + 3:
            k += 1
        if k * p >= self.R:
            raise ValueError(
                f"sub_digits: bound {bound_b} too large for field {self.name}")
        d = int_to_limbs(k * p, n)
        d[0] += 2 * B
        d[1:n - 1] += 2 * B - 2
        d[n - 1] -= 2
        assert (d >= 0).all() and limbs_to_int(d) == k * p
        assert d[n - 1] >= top_max + 1, (d[n - 1], top_max)
        assert (d[:n - 1] >= B + 2).all()
        return d, k

    def const(self, name: str, device) -> torch.Tensor:
        """A limb table (``p_limbs``, ``one_limbs``, ...) as an int64 tensor
        on ``device``, cached per device."""
        key = (name, str(torch.device(device)))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, name), dtype=_I64, device=device)
            self._dev[key] = t
        return t

    def sub_digits_tensor(self, bound_b: int, device) -> torch.Tensor:
        key = (("sub", bound_b), str(torch.device(device)))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(self.sub_digits(bound_b)[0], dtype=_I64,
                                device=device)
            self._dev[key] = t
        return t


# Concrete field specs -------------------------------------------------------

FR = FieldSpec("bls12_377_fr", _P.FR_MODULUS, _P.FR_GENERATOR, _P.FR_TWO_ADICITY)
FQ = FieldSpec("bls12_377_fq", _P.FQ_MODULUS, _P.FQ_GENERATOR % _P.FQ_MODULUS,
               _P.FQ_TWO_ADICITY)
EDFR = FieldSpec("ed_bls12_377_fr", _P.ED_FR_MODULUS, _P.ED_FR_GENERATOR, 1)
MNT4Q = FieldSpec("mnt4_753_fq", _P.MNT4753_FQ_MODULUS, _P.MNT4753_FQ_GENERATOR,
                  _P.MNT4753_FQ_TWO_ADICITY)


# ---------------------------------------------------------------------------
# Low-level limb operations (int64 limb tensors)
# ---------------------------------------------------------------------------


def _resolve2(cols):
    """Two relaxed carry passes: columns < 2**26 -> limbs <= B (length+1)."""
    c = cols >> W
    y = torch.cat([cols & MASK, torch.zeros_like(cols[..., :1])], dim=-1)
    y[..., 1:] += c
    c2 = y >> W
    z = y & MASK
    z[..., 1:] += c2[..., :-1]
    return z


def _conv_cols(a, b, nout=None):
    """Column sums of the limb convolution of a [..., na] and b [..., nb].

    Each product a_i·b_j splits into its low 15 bits (column i+j) and its
    high part (column i+j+1), the same column representation as the
    reference's ``_conv_cols`` and Pallas ``_conv_horner``, so the relaxed
    carries downstream give identical limbs.  ``nout`` keeps the low
    ``nout`` columns (mod-R half products).

    The anti-diagonal sums use a skew view: the split products sit in rows
    of width na+nb+1 (lo at j, hi at j+1, zeros after); re-cutting the flat
    buffer with row stride na+nb shifts row i right by i, so plain column
    sums are the convolution columns."""
    na, nb = a.shape[-1], b.shape[-1]
    total = na + nb if nout is None else nout
    # products < 2^31 fit int32; the split parts (< 2^17) and every column
    # sum (< 2^23 for na, nb <= 64) are integers float32 holds exactly, in
    # any summation order
    outer = a.to(torch.int32)[..., :, None] * b.to(torch.int32)[..., None, :]
    batch = outer.shape[:-2]
    width = na + nb + 1
    buf = torch.zeros(batch + (na, width), dtype=torch.float32, device=outer.device)
    buf[..., :nb] = outer & MASK
    buf[..., 1:nb + 1] += outer >> W
    skew = buf.reshape(batch + (na * width,))[..., :na * (width - 1)]
    cols = skew.reshape(batch + (na, width - 1)).sum(dim=-2)
    return cols[..., :total].to(_I64)


def _mont_mul_limbs(spec: FieldSpec, a, b):
    """REDC(a*b): inputs value < c1*p, c2*p with c1*c2*p <= R/2; output < 2p.

    CUDA tensors go to kernel K1 (`cuda_fp.mont_mul`), CPU tensors to its
    plain twin (`cuda_fp.mont_mul_plain`)."""
    from . import cuda_fp
    return cuda_fp.mont_mul(spec, a, b)


def _full_resolve(x, passes=None):
    """Exact carry propagation (nonnegative limbs): repeat single-limb passes."""
    m = x.shape[-1]
    passes = passes if passes is not None else m + 2
    y = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
    for _ in range(passes):
        c = y >> W
        y = y & MASK
        y[..., 1:] += c[..., :-1]
    return y


def _canonicalize_lt2p(spec: FieldSpec, limbs):
    """Exact canonical limbs (< B, value < p) for a value known < 2p.
    Signed limbs go through arithmetic ``>>`` (int64 keeps it arithmetic)."""
    n = spec.nlimbs
    y = _full_resolve(limbs)[..., :n + 1]
    p_ext = torch.nn.functional.pad(spec.const("p_limbs", y.device), (0, 1))
    ge = _geq(y, p_ext)
    yi = y - torch.where(ge[..., None], p_ext, torch.zeros_like(p_ext))
    for _ in range(n + 2):
        c = yi >> W
        yi = yi & MASK
        yi[..., 1:] += c[..., :-1]
    return yi[..., :n]


def _geq(a, b):
    """Lexicographic a >= b for canonical-limb tensors of equal length
    (at most 62 limbs): the sign of sum_i sign(a_i - b_i)·2^i is the sign
    of the most significant differing limb."""
    n = a.shape[-1]
    assert n <= 62
    d = (a > b).to(_I64) - (a < b).to(_I64)
    w = torch.pow(2, torch.arange(n, device=a.device, dtype=_I64))
    return (d * w).sum(dim=-1) >= 0


# ---------------------------------------------------------------------------
# FpArray: batched field elements
# ---------------------------------------------------------------------------


class FpArray:
    """A batch of field elements in Montgomery form: int64 limbs [..., n].

    ``bound`` is static host metadata: value < bound * p.
    """

    __slots__ = ("limbs", "spec", "bound")

    def __init__(self, limbs, spec: FieldSpec, bound: int = 2):
        self.limbs = limbs
        self.spec = spec
        self.bound = bound

    # ------------------------------------------------------------- properties

    @property
    def shape(self):
        return tuple(self.limbs.shape[:-1])

    @property
    def ndim(self):
        return self.limbs.dim() - 1

    @property
    def device(self):
        return self.limbs.device

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return FpArray(self.limbs[idx + (slice(None),)], self.spec, self.bound)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return FpArray(self.limbs.reshape(tuple(shape) + (self.spec.nlimbs,)),
                       self.spec, self.bound)

    def broadcast_to(self, shape):
        return FpArray(self.limbs.expand(tuple(shape) + (self.spec.nlimbs,)),
                       self.spec, self.bound)

    def to(self, device):
        return FpArray(self.limbs.to(device), self.spec, self.bound)

    # ------------------------------------------------------------ constructors

    @classmethod
    def from_int(cls, spec: FieldSpec, values, shape=None, device="cuda"):
        """Host ints -> Montgomery-form FpArray (bound 1) on ``device``."""
        arr = np.asarray(values, dtype=object)
        if shape is not None:
            arr = arr.reshape(shape)
        p, r = spec.p, spec.r_mod_p
        mont = [int(v) % p * r % p for v in arr.reshape(-1)]
        limbs = ints_to_limbs(mont, spec.nlimbs)
        t = torch.from_numpy(limbs.reshape(arr.shape + (spec.nlimbs,)))
        return cls(t.to(device), spec, 1)

    @classmethod
    def zeros(cls, spec: FieldSpec, shape=(), device="cuda"):
        return cls(torch.zeros(tuple(shape) + (spec.nlimbs,), dtype=_I64,
                               device=device), spec, 1)

    @classmethod
    def ones(cls, spec: FieldSpec, shape=(), device="cuda"):
        limbs = spec.const("one_limbs", device).expand(
            tuple(shape) + (spec.nlimbs,))
        return cls(limbs, spec, 1)

    def to_ints(self):
        """Host-side: -> numpy object array of canonical python ints."""
        flat = self.limbs.detach().cpu().numpy().reshape(-1, self.spec.nlimbs)
        rinv, p = self.spec.rinv, self.spec.p
        out = np.empty(flat.shape[0], dtype=object)
        for i, v in enumerate(limbs_to_ints(flat)):
            out[i] = int(v) * rinv % p
        return out.reshape(self.shape)

    # --------------------------------------------------------------- core ops

    def tighten(self):
        """Reduce value to [0, 2p) with one Montgomery multiply by repr(1)."""
        if self.bound <= 2:
            return self
        spec = self.spec
        assert self.bound <= spec.mul_bound_budget, self.bound
        out = _mont_mul_limbs(spec, self.limbs,
                              spec.const("one_limbs", self.device))
        return FpArray(out, spec, 2)

    def __add__(self, other):
        other = self._coerce(other)
        spec = self.spec
        a, b = self, other
        if a.bound + b.bound > spec.mul_bound_budget:
            if a.bound >= b.bound:
                a = a.tighten()
            else:
                b = b.tighten()
            if a.bound + b.bound > spec.mul_bound_budget:
                a, b = a.tighten(), b.tighten()
        out = _resolve2(a.limbs + b.limbs)[..., :spec.nlimbs]
        return FpArray(out, spec, a.bound + b.bound)

    def __sub__(self, other):
        other = self._coerce(other)
        spec = self.spec
        a, b = self, other
        if b.bound > 16:
            b = b.tighten()
        _, k = spec.sub_digits(b.bound)
        if a.bound + k > spec.mul_bound_budget:
            a = a.tighten()
            if a.bound + k > spec.mul_bound_budget:
                raise ValueError(
                    f"sub bound overflow in {spec.name}: {a.bound}+{k}")
        digits = spec.sub_digits_tensor(b.bound, b.device)
        out = _resolve2(a.limbs + (digits - b.limbs))[..., :spec.nlimbs]
        return FpArray(out, spec, a.bound + k)

    def __neg__(self):
        return FpArray.zeros(self.spec, (), self.device) - self

    def __mul__(self, other):
        other = self._coerce(other)
        spec = self.spec
        a, b = self, other
        if a.bound * b.bound > spec.mul_bound_budget:
            if a.bound >= b.bound:
                a = a.tighten()
            else:
                b = b.tighten()
            if a.bound * b.bound > spec.mul_bound_budget:
                a, b = a.tighten(), b.tighten()
        out = _mont_mul_limbs(spec, a.limbs, b.limbs)
        return FpArray(out, spec, 2)

    def smul(self, k: int):
        """Multiply by a small nonnegative integer constant (k < 2**8)."""
        assert 0 <= k < 256
        if k == 0:
            return FpArray.zeros(self.spec, self.shape, self.device)
        if k == 1:
            return self
        spec = self.spec
        a = self
        if a.bound * k > spec.mul_bound_budget:
            a = a.tighten()
            assert a.bound * k <= spec.mul_bound_budget, (k, spec.name)
        out = _resolve2(a.limbs * k)[..., :spec.nlimbs]
        return FpArray(out, spec, a.bound * k)

    def double(self):
        return self.smul(2)

    def square(self):
        return self * self

    def pow_const(self, e: int):
        """Raise to a static integer power.

        Small exponents unroll square-and-multiply from the first set bit;
        large exponents start from repr(1) at bound 2 and walk every bit, the
        same multiply sequence as the reference's scanned form."""
        assert e >= 0
        if e == 0:
            return FpArray.ones(self.spec, self.shape, self.device)
        if e.bit_length() <= 16:
            result = None
            base = self
            for bit in bin(e)[2:]:
                if result is not None:
                    result = result.square()
                if bit == "1":
                    result = base if result is None else result * base
            return result
        base = self.tighten()
        res = FpArray(self.spec.const("one_limbs", self.device).expand(
            self.shape + (self.spec.nlimbs,)), self.spec, 2)
        for bit in bin(e)[2:]:
            res = res.square()
            if bit == "1":
                res = res * base
        return res

    def inv(self):
        """Batched modular inverse via Fermat (x^(p-2)); 0 maps to 0."""
        return self.pow_const(self.spec.p - 2)

    # --------------------------------------------------------- canonicalization

    def canon_limbs(self):
        """Exact canonical limbs of the Montgomery representative (< p)."""
        return _canonicalize_lt2p(self.spec, self.tighten().limbs)

    def int_limbs(self):
        """Exact canonical limbs of the integer value (de-Montgomerized)."""
        spec = self.spec
        x = self if self.bound <= spec.mul_bound_budget else self.tighten()
        raw = _mont_mul_limbs(spec, x.limbs,
                              spec.const("int_one_limbs", self.device))
        return _canonicalize_lt2p(spec, raw)

    def is_zero(self):
        return (self.canon_limbs() == 0).all(dim=-1)

    # ------------------------------------------------------------------ misc

    def _coerce(self, other):
        if isinstance(other, FpArray):
            assert other.spec is self.spec, (other.spec, self.spec)
            return other
        if isinstance(other, int):
            return FpArray.from_int(self.spec, other, device=self.device)
        raise TypeError(type(other))

    @staticmethod
    def select(cond, a: "FpArray", b: "FpArray"):
        """Elementwise where(cond, a, b); cond has the batch shape."""
        assert a.spec is b.spec
        limbs = torch.where(cond[..., None], a.limbs, b.limbs)
        return FpArray(limbs, a.spec, max(a.bound, b.bound))

    @staticmethod
    def concat(arrays, axis=0):
        spec = arrays[0].spec
        bound = max(a.bound for a in arrays)
        return FpArray(torch.cat([a.limbs for a in arrays], dim=axis),
                       spec, bound)

    @staticmethod
    def stack(arrays, axis=0):
        spec = arrays[0].spec
        bound = max(a.bound for a in arrays)
        return FpArray(torch.stack([a.limbs for a in arrays], dim=axis),
                       spec, bound)

    def __repr__(self):
        return f"FpArray({self.spec.name}, shape={self.shape}, bound={self.bound})"
