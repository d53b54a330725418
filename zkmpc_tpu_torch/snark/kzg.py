"""KZG10 polynomial commitments over BLS12-377 (the Marlin backbone).

Port of ``zkmpc_tpu/snark/kzg.py`` (the reference's vendored ark
poly-commit KZG10, `arkworks/poly-commit/src/kzg10/mod.rs:142,295`):
commitments are MSMs of the SRS powers with polynomial coefficients, run
over shared coefficients, and an opening proof is the commitment of the
witness polynomial (p(X) - p(z)) / (X - z), computed by pointwise division
on a coset (one NTT, a batched inverse, one inverse NTT) so shared
polynomials stay batched tensors.

- `setup` draws tau with ark's `Fp::rand` on the seeded ChaCha12 stream,
  as the reference does, but redraws while tau is 0 (the reference can
  return a zero trapdoor); the powers tau^i are host ints and the points
  come from one batched fixed-base comb on the device.
- Under SPDZ every coefficient tensor carries MAC shares; the layout maps
  (`_place`, `_pad_to`, `_slice`, `_broadcast_scalar`) and the NTTs run on
  value and MAC shares stacked on the party axis, one launch for both.
- Verification is host-side, on the jax-free pairing (`spec.pairing`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import params
from ..compat import ark as A_
from ..mpc.group import MpcSWPoint, mpc_msm_many
from ..mpc.share import MpcFp, _sum_last_axis
from ..ops.curve import SWPoint
from ..ops.limbs import FQ, FR, FpArray
from ..ops.msm import sw_msm
from ..ops.ntt import Domain
from ..spec import curves as SC
from ..spec import pairing as SP
from ..utils.serialize import field_to_hex, hex_to_field
from .groth16 import _fixed_base_muls

R = params.FR_MODULUS


@dataclasses.dataclass
class KzgSrs:
    powers: list                    # [(x, y)] G1 powers of tau, length d+1
    g2: tuple                       # h
    beta_g2: tuple                  # tau * h
    _device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def device(self, device="cuda") -> "DeviceKzgSrs":
        """The powers as a point batch on ``device`` (made once per device)."""
        key = str(torch.device(device))
        if key not in self._device:
            self._device[key] = DeviceKzgSrs(self, device)
        return self._device[key]


class DeviceKzgSrs:
    def __init__(self, srs: KzgSrs, device="cuda", powers: SWPoint | None = None):
        self.srs = srs
        self.powers = powers if powers is not None else \
            SWPoint.g1_from_affine_ints(srs.powers, device)


def _draw_tau(seed: int) -> int:
    """tau = ark `Fp::rand` on the seeded ChaCha12 stream, redrawn from the
    same stream while it is 0; with a nonzero first draw it is the
    reference's."""
    rng = A_.seeded_rng(seed)
    while True:
        tau = A_.fr_rand(rng)
        if tau:
            return tau


def setup(max_degree: int, seed: int = 0, device="cuda") -> KzgSrs:
    """KZG universal setup of degree ``max_degree``: tau^i on the host, the
    points tau^i * G on ``device`` in one batched fixed-base comb."""
    tau = _draw_tau(seed)
    scalars, acc = [], 1
    for _ in range(max_degree + 1):
        scalars.append(acc)
        acc = acc * tau % R
    pts = _fixed_base_muls(SC.G1_GEN, False, scalars, device)
    srs = KzgSrs(pts.to_affine_ints(), SC.G2_GEN, SC.g2_mul(SC.G2_GEN, tau))
    srs._device[str(torch.device(device))] = DeviceKzgSrs(srs, device, pts)
    return srs


def save_srs(srs: KzgSrs, path: str) -> None:
    """The SRS as 0x-hex JSON, the JAX package's format (the reference's
    Marlin SRS save/load, `src/marlin.rs:371-376,456-478`)."""
    def hx(v):
        return field_to_hex(int(v), FQ)
    doc = {"powers": [[hx(x), hx(y)] for (x, y) in srs.powers],
           "g2": [[hx(c) for c in co] for co in srs.g2],
           "beta_g2": [[hx(c) for c in co] for co in srs.beta_g2]}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)


def load_srs(path: str) -> KzgSrs:
    with open(path) as f:
        doc = json.load(f)
    powers = [(hex_to_field(x), hex_to_field(y)) for x, y in doc["powers"]]
    g2 = tuple(tuple(hex_to_field(c) for c in co) for co in doc["g2"])
    beta_g2 = tuple(tuple(hex_to_field(c) for c in co) for co in doc["beta_g2"])
    return KzgSrs(powers, g2, beta_g2)


def commit(srs: DeviceKzgSrs, coeffs: MpcFp) -> MpcSWPoint:
    """coeffs: [..., d] (shared or public) -> commitment point(s)."""
    return commit_many(srs, [(coeffs, 0)])[0]


def commit_shifted(srs: DeviceKzgSrs, coeffs: MpcFp, shift: int) -> MpcSWPoint:
    """Commitment to X^shift * p(X): MSM against powers[shift:shift+d], the
    degree-bound device (marlin_pc `shifted_comm`,
    `arkworks/poly-commit/src/lib.rs:178`): against an SRS of degree D, a
    p of degree above D - shift has no such commitment."""
    return commit_many(srs, [(coeffs, shift)])[0]


def commit_many(srs: DeviceKzgSrs, items) -> list:
    """[(coeffs MpcFp, shift)] -> one commitment each (X^shift * p), every
    MSM in one fused call (`mpc.group.mpc_msm_many`)."""
    for c, s in items:
        assert s + c.shape[-1] <= len(srs.srs.powers), "shifted poly exceeds SRS"
    return mpc_msm_many([srs.powers[s:s + c.shape[-1]] for c, s in items],
                        [c for c, _ in items])


def evaluate(coeffs: MpcFp, z: FpArray) -> MpcFp:
    """p(z) for public z, shared coeffs: powers of z dot coeffs (local)."""
    scaled = coeffs * MpcFp.from_public(_pow_vector(z, coeffs.shape[-1]))
    return MpcFp(_sum_last_axis(scaled.value), scaled.visibility,
                 None if scaled.mac is None else _sum_last_axis(scaled.mac))


def _pow_vector(z: FpArray, d: int) -> FpArray:
    """[1, z, z^2, ..., z^(d-1)] via log-depth doubling products."""
    out = FpArray.ones(z.spec, (1,), z.device)
    cur = z.reshape((1,))
    while out.shape[0] < d:
        out = FpArray.concat([out, out * cur], axis=0)
        cur = cur * cur
    return out[:d]


def _coset_den_inv(dom: Domain, z: FpArray) -> FpArray:
    """1 / (x - z) at the points x = g * omega^i of the coset g*H."""
    xs, acc = [], dom.coset_gen % R
    for _ in range(dom.n):
        xs.append(acc)
        acc = acc * dom.omega % R
    pts = FpArray.from_int(FR, np.asarray(xs, dtype=object), device=z.device)
    return (pts - z.reshape(())).inv()


def _witness_coeffs(comb, value, z: FpArray, n: int, d: int):
    """The first d coefficients of (comb(X) - value) / (X - z): evaluations
    on a coset of size n, divided pointwise, interpolated.  ``comb``,
    ``value``: MpcFp, or plain FpArray for public data."""
    dom = Domain(FR, n, z.device)
    num = _apply(_pad_to(comb, n), dom.coset_fft) - _broadcast_scalar(value, n)
    den = _coset_den_inv(dom, z)
    if isinstance(num, FpArray):
        return dom.coset_ifft(num * den)[:d]
    return _slice(_apply(num * MpcFp.from_public(den), dom.coset_ifft), d)


def _commit_any(srs: DeviceKzgSrs, coeffs):
    """An MpcFp's commitment (MpcSWPoint), or a plain FpArray's (SWPoint)."""
    if isinstance(coeffs, FpArray):
        return sw_msm(srs.powers[0:coeffs.shape[-1]], coeffs)
    return commit(srs, coeffs)


def open_at(srs: DeviceKzgSrs, coeffs: MpcFp, z: FpArray, domain_n: int | None = None):
    """Opening proof at public z: (witness commitment, claimed value p(z)).
    The division runs on the coset g*H of a power-of-two domain of size
    >= deg + 1, so z on H itself never hits a zero denominator."""
    d = coeffs.shape[-1]
    v = evaluate(coeffs, z)
    return commit(srs, _witness_coeffs(coeffs, v, z, domain_n or _next_pow2(d), d)), v


def batch_open_at(srs: DeviceKzgSrs, items, z: FpArray, xi: int,
                  domain_n: int | None = None):
    """One opening witness for sum_i xi^i * X^shift_i * p_i(X) at public z
    (reference `open_combinations`, `poly-commit/src/lib.rs:315`).

    items: [(coeffs MpcFp, shift int, value MpcFp == p_i(z))], or all plain
    FpArrays for public polynomials (then the witness is an SWPoint)."""
    return _commit_any(srs, batch_open_coeffs(items, z, xi, domain_n))


def batch_open_coeffs(items, z: FpArray, xi: int, domain_n: int | None = None):
    """The coefficients `batch_open_at` commits to."""
    L = max(s + c.shape[-1] for c, s, _ in items)
    z_int = int(z.to_ints().reshape(-1)[0])
    comb = vcomb = None
    xi_pow = 1
    for coeffs, shift, v in items:
        term = _scale_pub_int(_place(coeffs, shift, L), xi_pow)
        comb = term if comb is None else comb + term
        vt = _scale_pub_int(v, xi_pow * pow(z_int, shift, R) % R)
        vcomb = vt if vcomb is None else vcomb + vt
        xi_pow = xi_pow * xi % R
    n = domain_n or _next_pow2(L)
    assert n >= L
    return _witness_coeffs(comb, vcomb, z, n, max(1, L - 1))


def verify_open(srs: KzgSrs, commitment, z_int: int, v_int: int, proof) -> bool:
    """Host pairing check: e(C - v g, h) == e(W, beta h - z h)."""
    c_minus_v = SC.g1_add(commitment, SC.g1_neg(SC.g1_mul(SC.G1_GEN, v_int)))
    rhs_g2 = SC.g2_add(srs.beta_g2, SC.g2_neg(SC.g2_mul(srs.g2, z_int)))
    return SP.product_pairing_is_one([(c_minus_v, srs.g2), (SC.g1_neg(proof), rhs_g2)])


def verify_batch_open(srs: KzgSrs, coms, values, z_int: int, xi: int, proof_pt) -> bool:
    """Host check of a batched opening: C = sum xi^i C_i, v = sum xi^i v_i,
    then one pairing product.  For a shifted entry the caller passes
    z^shift * value."""
    acc, v, xi_pow = None, 0, 1
    for c_pt, v_int in zip(coms, values):
        acc = SC.g1_add(acc, SC.g1_mul(c_pt, xi_pow) if c_pt else None)
        v = (v + xi_pow * v_int) % R
        xi_pow = xi_pow * xi % R
    return verify_open(srs, acc, z_int, v, proof_pt)


# ------------------------------------------------------------------ helpers


def _next_pow2(d):
    n = 1
    while n < d:
        n <<= 1
    return n


def _apply(x, fn):
    """``fn`` (FpArray -> FpArray, batch-agnostic) on the value and, under
    SPDZ, the MAC shares, stacked on the party axis so both go through one
    call (a plain FpArray: ``fn`` on it)."""
    if isinstance(x, FpArray):
        return fn(x)
    if x.mac is None:
        return MpcFp(fn(x.value), x.visibility)
    p = x.value.shape[0]
    both = fn(FpArray.concat([x.value, x.mac], axis=0))
    return MpcFp(both[:p], x.visibility, both[p:])


def _scale_pub_int(x, k: int):
    c = FpArray.from_int(FR, k % R, device=(x if isinstance(x, FpArray) else x.value).device)
    return _apply(x, lambda f: f * c)


def _zeros_rows(fp: FpArray, k: int) -> torch.Tensor:
    return torch.zeros(fp.limbs.shape[:-2] + (k, fp.limbs.shape[-1]),
                       dtype=fp.limbs.dtype, device=fp.limbs.device)


def _place(x, shift: int, total: int):
    """Coefficients of X^shift * p, zero-padded to ``total`` (p an MpcFp or
    a plain FpArray, as in `_apply`)."""
    d = x.shape[-1]

    def f(fp: FpArray):
        return FpArray(torch.cat([_zeros_rows(fp, shift), fp.limbs,
                                  _zeros_rows(fp, total - shift - d)], dim=-2),
                       fp.spec, fp.bound)
    return _apply(x, f)


def _pad_to(x, n: int):
    d = x.shape[-1]
    return x if d == n else _place(x, 0, n)


def _slice(x: MpcFp, d: int) -> MpcFp:
    return _apply(x, lambda fp: FpArray(fp.limbs[..., :d, :], fp.spec, fp.bound))


def _broadcast_scalar(v: MpcFp, n: int) -> MpcFp:
    def f(fp: FpArray):
        shape = fp.limbs.shape
        return FpArray(fp.limbs[..., None, :].expand(shape[:-1] + (n, shape[-1])),
                       fp.spec, fp.bound)
    return _apply(v, f)
