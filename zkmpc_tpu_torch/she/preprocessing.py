"""SPDZ preprocessing: Beaver triples and pairs via SHE (DPSZ11 §5-§6).

Port of ``zkmpc_tpu/she/preprocessing.py``: a single-process simulation of
all parties (the reference holds the joint secret key locally and never
networks the preprocessing, `preprocessing.rs:447-538`), for any party
count, batched: one call makes whole tensors of triples.

- ``reshare``: mask a ciphertext with encrypted party randomness, decrypt
  the masked value, re-distribute additive shares (and optionally a fresh
  ciphertext) (`preprocessing.rs:467-538`).  Leading batch axes of the
  ciphertext are kept: `bracket` reshares all key owners in one call.
- ``angle``: SPDZ <.> sharing with alpha-MACs (`preprocessing.rs:540-611`).
- ``bracket``: [.] sharing with per-party MAC keys (`:613-721`).
- ``initialize``: alpha and beta key shares, their encryptions under a
  ZKPoPK each, and bracket(alpha) (`:732-809`).
- ``pair`` / ``inv_pair`` / ``triple``: random pairs, inverse pairs and
  multiplication triples (`:823-974`).
- ``zkpopk_prove`` / ``zkpopk_verify``: proof of plaintext knowledge
  (DPSZ11 Fig. 10) with a blake2b Fiat-Shamir hash over the canonical limbs.
- ``SheTripleSource``: the triple source of the MPC context, served from
  `triple`, `inv_pair` and `pair` batches, with their MAC shares under the
  SPDZ backend.

Random draws come from an explicit ``torch.Generator``; the masks f of
`reshare` and the ZKPoPK's y and s can be injected.  Every tensor lives on
the dealer's device; the Fiat-Shamir hash is the one host step, one copy
of the canonical limbs per ZKPoPK batch.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..mpc import rand as R
from ..mpc.share import SHARED, MpcFp, spdz_in_scope
from ..ops.limbs import FR, MNT4Q, FpArray, int_to_limbs
from . import bgv, ring

P = FR.p

#: soundness bits per ZKPoPK run (the reference uses sec = 1)
SEC = 8
#: response bounds of the verifier (DPSZ11 Fig. 10): honest z = y + e*m
#: with both centered <= TAU; honest t = s + e*r with gaussian coefficients
#: (sigma = 3.2, tail < 10 sigma), RHO = 2 x that tail per summand
TAU = (FR.p - 1) // 2
RHO = 64


@dataclasses.dataclass
class DealerContext:
    """Single-process preprocessing state (trusted-dealer-style simulation,
    like the reference; the sk exists only inside this context)."""
    params: bgv.SheParams
    n_parties: int
    sk: bgv.SecretKey
    pk: bgv.PublicKey
    alpha_shares: FpArray | None = None     # [P] Fr
    e_alpha: bgv.Ciphertext | None = None   # Enc(diag(alpha))
    beta: FpArray | None = None             # [P] per-party bracket MAC keys
    e_beta: list | None = None              # per-party Enc(diag(beta_j))
    alpha_bracket: tuple | None = None      # bracket(alpha) from initialize

    @property
    def device(self):
        return self.pk.a.device


def make_dealer(params: bgv.SheParams, n_parties: int, generator,
                device="cuda") -> DealerContext:
    sk, pk = bgv.keygen(params, generator, device=device)
    return DealerContext(params, n_parties, sk, pk)


def _n2q(f: FpArray) -> FpArray:
    """Tightened to value < 2p, labelled bound 2."""
    f = f.tighten()
    return f if f.bound == 2 else FpArray(f.limbs, f.spec, 2)


def _n2q_ct(ct: bgv.Ciphertext) -> bgv.Ciphertext:
    return bgv.Ciphertext(_n2q(ct.c0), _n2q(ct.c1), _n2q(ct.c2))


# ---------------------------------------------------------- state carried across
# The JAX package's ``dealer_to_host`` layout: nodes ("fp", spec name, bound,
# uint32 limbs), ("ct", c0, c1, c2), ("seq", is_tuple, items) or None.

_SPEC_BY_NAME = {FR.name: FR, MNT4Q.name: MNT4Q}


def _enc_node(x):
    if x is None:
        return None
    if isinstance(x, FpArray):
        x = _n2q(x)
        return ("fp", x.spec.name, int(x.bound),
                x.limbs.detach().cpu().numpy().astype(np.uint32))
    if isinstance(x, bgv.Ciphertext):
        return ("ct", _enc_node(x.c0), _enc_node(x.c1), _enc_node(x.c2))
    if isinstance(x, (list, tuple)):
        return ("seq", isinstance(x, tuple), [_enc_node(v) for v in x])
    raise TypeError(f"unserializable dealer field: {type(x)}")


def _dec_node(d, device):
    if d is None:
        return None
    tag = d[0]
    if tag == "fp":
        _, name, bound, limbs = d
        t = torch.as_tensor(np.asarray(limbs).astype(np.int64), device=device)
        return FpArray(t, _SPEC_BY_NAME[name], int(bound))
    if tag == "ct":
        return bgv.Ciphertext(*(_dec_node(c, device) for c in d[1:4]))
    _, is_tuple, items = d
    seq = [_dec_node(v, device) for v in items]
    return tuple(seq) if is_tuple else seq


def dealer_to_host(ctx: DealerContext) -> dict:
    """The dealer as host data, in the JAX package's ``dealer_to_host``
    layout (limbs as numpy uint32, tightened to bound 2)."""
    return {
        "n": ctx.params.n, "sigma": ctx.params.sigma,
        "n_parties": ctx.n_parties,
        "sk": _enc_node(ctx.sk.s),
        "pk_a": _enc_node(ctx.pk.a), "pk_b": _enc_node(ctx.pk.b),
        "alpha_shares": _enc_node(ctx.alpha_shares),
        "e_alpha": _enc_node(ctx.e_alpha),
        "beta": _enc_node(ctx.beta),
        "e_beta": _enc_node(ctx.e_beta),
        "alpha_bracket": _enc_node(ctx.alpha_bracket),
    }


def dealer_from_host(doc: dict, device="cuda") -> DealerContext:
    """The port's DealerContext on ``device`` from ``dealer_to_host``'s
    layout (the JAX package's or the port's)."""
    params = bgv.SheParams(int(doc["n"]), float(doc["sigma"]))
    dec = lambda key: _dec_node(doc[key], device)  # noqa: E731
    ctx = DealerContext(params, int(doc["n_parties"]), bgv.SecretKey(dec("sk")),
                        bgv.PublicKey(dec("pk_a"), dec("pk_b")))
    ctx.alpha_shares = dec("alpha_shares")
    ctx.e_alpha = dec("e_alpha")
    ctx.beta = dec("beta")
    ctx.e_beta = dec("e_beta")
    ctx.alpha_bracket = dec("alpha_bracket")
    return ctx


# ------------------------------------------------------------------ protocols


def _sum_ct(cts):
    acc = cts[0]
    for c in cts[1:]:
        acc = acc + c
    return acc


def _ct_sum_parties(ct: bgv.Ciphertext) -> bgv.Ciphertext:
    """Fold a batched ciphertext's party axis (the one before the ring
    axis): the sum of the per-party ciphertexts."""
    def s(f: FpArray):
        acc = FpArray(f.limbs[..., 0, :, :], f.spec, f.bound)
        for i in range(1, f.limbs.shape[-3]):
            acc = acc + FpArray(f.limbs[..., i, :, :], f.spec, f.bound)
        return acc
    return bgv.Ciphertext(s(ct.c0), s(ct.c1), s(ct.c2))


def _encrypt_party_slots(ctx: DealerContext, slots_P: FpArray, generator):
    """slots_P: [..., P, n] Fr -> one batched ciphertext of the same
    leading shape (all parties encrypt in one batch)."""
    r = bgv.sample_enc_randomness(ctx.params, generator, slots_P.shape[:-1],
                                  device=ctx.device)
    return bgv.encrypt_slots(ctx.pk, ctx.params, slots_P, r)


def reshare(ctx: DealerContext, e_m: bgv.Ciphertext, generator,
            new_ciphertext: bool = False, f: FpArray | None = None):
    """-> (shares [..., P, n] Fr, optional fresh Enc(m) [..., n]).

    Each party masks with f_i, the masked value opens, the leader keeps
    (m + sum f) - f_0, the others -f_i (`preprocessing.rs:467-538`).  e_m
    [..., n]: leading axes reshare independent ciphertexts in one batch.
    ``f``: injected masks [..., P, n] in place of the generator's."""
    n = ctx.params.n
    lead = e_m.c0.shape[:-1]
    if f is None:
        f = R.uniform_fp(generator, FR, lead + (ctx.n_parties, n), device=ctx.device)
    e_f_sum = _ct_sum_parties(_encrypt_party_slots(ctx, f, generator))
    mf = bgv.decrypt_slots(ctx.sk, e_m + e_f_sum)        # m + sum f  [..., n]
    shares = -f
    lead_share = mf - f[(Ellipsis, 0, slice(None))]
    limbs = shares.limbs.clone()
    limbs[..., 0, :, :] = lead_share.limbs
    shares = FpArray(limbs, FR, max(shares.bound, lead_share.bound))
    fresh = None
    if new_ciphertext:
        r = bgv.sample_enc_randomness(ctx.params, generator, lead, device=ctx.device)
        fresh = bgv.encrypt_slots(ctx.pk, ctx.params, mf, r) - e_f_sum
    return shares, fresh


def angle(ctx: DealerContext, shares: FpArray, e_m: bgv.Ciphertext, generator):
    """SPDZ <m>: (shares [P, n], mac shares [P, n]) with mac = alpha * m
    (`preprocessing.rs:540-611`): Enc(alpha) * Enc(m), reshared."""
    e_gamma = ctx.e_alpha.mul(_n2q_ct(e_m))
    mac_shares, _ = reshare(ctx, e_gamma, generator)
    return shares, _n2q(mac_shares)


def bracket(ctx: DealerContext, shares: FpArray, e_m: bgv.Ciphertext, generator):
    """SPDZ [m]: per-party MAC keys.  Returns (shares [P, n],
    macs [P_keys, P_holders, n]) with sum_i macs[j, i] == beta_j * m for
    every key owner j (`preprocessing.rs:613-721`).  The owners' ciphertext
    products and reshares run as one batch over a leading owner axis."""
    assert ctx.e_beta is not None, "initialize() first"
    e_b = bgv.Ciphertext(*(FpArray.stack([_n2q(getattr(c, k)) for c in ctx.e_beta])
                           for k in ("c0", "c1", "c2")))       # [P_keys, n]
    macs, _ = reshare(ctx, e_b.mul(_n2q_ct(e_m)), generator)
    return shares, _n2q(macs)


def initialize(ctx: DealerContext, generator):
    """Generate alpha and per-party bracket keys beta_j, encrypt each
    diag-encoded key share under a ZKPoPK, store Enc(alpha), and produce
    [alpha] (`preprocessing.rs:732-809`).  Raises if a ZKPoPK is rejected."""
    P_ = ctx.n_parties
    alpha_i = R.uniform_fp(generator, FR, (P_,), device=ctx.device)
    beta_i = R.uniform_fp(generator, FR, (P_,), device=ctx.device)
    cts = _diag_encrypt_with_popk(ctx, alpha_i, generator)
    ctx.alpha_shares = alpha_i
    ctx.e_alpha = _sum_ct(cts)
    ctx.beta = beta_i
    ctx.e_beta = _diag_encrypt_with_popk(ctx, beta_i, generator)
    # bracket(alpha): alpha_i is one scalar per party -> replicated across
    # the slots so the MAC ciphertext algebra is uniform
    n = ctx.params.n
    a_slots = FpArray(alpha_i.limbs[:, None, :].expand(P_, n, FR.nlimbs), FR,
                      alpha_i.bound)
    ctx.alpha_bracket = bracket(ctx, a_slots, ctx.e_alpha, generator)
    return alpha_i


def pair(ctx: DealerContext, generator):
    """Random r in both representations (`preprocessing.rs:823-878`):
    ((r_shares, r_mac_shares), (r_shares, r_bracket_macs))."""
    r_i, e_r, macs = _random_angle(ctx, generator, (ctx.n_parties, ctx.params.n))
    br = bracket(ctx, r_i, e_r, generator) if ctx.e_beta is not None else None
    return (r_i, macs), br


def _random_angle(ctx: DealerContext, generator, shape):
    """Random shares r_i of ``shape`` [..., P, n], Enc(r) and <r>'s MAC
    shares: `pair`'s first representation."""
    r_i = R.uniform_fp(generator, FR, shape, device=ctx.device)
    e_r = _ct_sum_parties(_encrypt_party_slots(ctx, r_i, generator))
    _, macs = angle(ctx, r_i, e_r, generator)
    return r_i, e_r, macs


def rand_kernel(ctx: DealerContext, generator, ciphertexts: int = 1):
    """One batch of authenticated random shares <r> of ``ciphertexts``
    ciphertexts (the first representation of `pair`, without its bracket):
    (r, mac_r), each FpArray [P, ciphertexts * n], tightened."""
    shape = (ctx.n_parties, ctx.params.n)
    if ciphertexts > 1:
        shape = (ciphertexts,) + shape
    r_i, _, macs = _random_angle(ctx, generator, shape)
    return _by_party(ctx, (r_i, macs), ciphertexts)


def inv_pair(ctx: DealerContext, generator):
    """Random (r, r^-1) in <.> representation: sample r, s, open w = r*s via
    SHE multiply + decrypt, set r^-1 shares = s_i * w^-1 (w public)."""
    shape = (ctx.n_parties, ctx.params.n)
    r_i = R.uniform_fp(generator, FR, shape, device=ctx.device)
    s_i = R.uniform_fp(generator, FR, shape, device=ctx.device)
    e_r = _ct_sum_parties(_encrypt_party_slots(ctx, r_i, generator))
    e_s = _ct_sum_parties(_encrypt_party_slots(ctx, s_i, generator))
    w = bgv.decrypt_slots(ctx.sk, e_r.mul(e_s))         # [n] public
    w_inv = w.inv()
    rinv_i = s_i * w_inv.broadcast_to(s_i.shape)        # scale by public
    # a fresh low-noise ciphertext of r^-1 for its MAC (a dealer-side
    # re-encryption, the trust model of `reshare`): Enc(s) times the lifted
    # encode(w^-1) would overflow the noise budget of q, the lifted
    # coefficients being ~p/2
    rinv_slots = bgv.decrypt_slots(ctx.sk, e_s) * w_inv
    re = bgv.sample_enc_randomness(ctx.params, generator, device=ctx.device)
    e_rinv = bgv.encrypt_slots(ctx.pk, ctx.params, rinv_slots, re)
    _, mac_r = angle(ctx, r_i, e_r, generator)
    _, mac_rinv = angle(ctx, rinv_i, e_rinv, generator)
    return (r_i, mac_r), (rinv_i, mac_rinv)


def triple(ctx: DealerContext, generator, ciphertexts: int = 1):
    """Beaver triples: ((a, mac_a), (b, mac_b), (c, mac_c)), each [P, n]
    (`preprocessing.rs:892-974`); with ``ciphertexts`` = k > 1, k
    ciphertexts' worth in one batch, each [k, P, n]."""
    shape = (ctx.n_parties, ctx.params.n)
    if ciphertexts > 1:
        shape = (ciphertexts,) + shape
    a_i = R.uniform_fp(generator, FR, shape, device=ctx.device)
    b_i = R.uniform_fp(generator, FR, shape, device=ctx.device)
    e_a = _ct_sum_parties(_encrypt_party_slots(ctx, a_i, generator))
    e_b = _ct_sum_parties(_encrypt_party_slots(ctx, b_i, generator))
    e_c = e_a.mul(e_b)
    c_i, e_c_fresh = reshare(ctx, e_c, generator, new_ciphertext=True)
    _, mac_a = angle(ctx, a_i, e_a, generator)
    _, mac_b = angle(ctx, b_i, e_b, generator)
    _, mac_c = angle(ctx, c_i, e_c_fresh, generator)
    return (a_i, mac_a), (b_i, mac_b), (c_i, mac_c)


def triple_kernel(ctx: DealerContext, generator, ciphertexts: int = 1):
    """One triple batch of ``ciphertexts`` ciphertexts, every output
    tightened (bound 2): (a, mac_a, b, mac_b, c, mac_c), each FpArray
    [P, ciphertexts * n]."""
    outs = [x for shares_macs in triple(ctx, generator, ciphertexts) for x in shares_macs]
    return _by_party(ctx, outs, ciphertexts)


def _by_party(ctx: DealerContext, outs, ciphertexts: int) -> tuple:
    """[ciphertexts, P, n] batch outputs -> [P, ciphertexts * n], tightened."""
    if ciphertexts == 1:
        return tuple(_n2q(x) for x in outs)
    return tuple(_n2q(FpArray(x.limbs.movedim(1, 0).reshape(
        ctx.n_parties, -1, x.spec.nlimbs), x.spec, x.bound)) for x in outs)


# ---------------------------------------------------------------------------
# ZKPoPK (DPSZ11 Fig. 10) with a blake2b Fiat-Shamir hash
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ZkPoPK:
    """Proof for ciphertexts ct [..., n]: V = SEC commitments a_k
    (Ciphertext [..., V, n]), the challenge (32 bytes a ciphertext: bytes,
    or a list of them in row-major order of the leading axes), the response
    plaintexts z [..., V, n] in the lifted R_q domain and the response
    randomness t (EncRandomness [..., V, n])."""
    commitments: bgv.Ciphertext
    challenge: bytes | list
    z: FpArray
    t: bgv.EncRandomness


def _hash_fs(ct: bgv.Ciphertext, comms: bgv.Ciphertext) -> list:
    """blake2b-256 of each ciphertext and its V commitments over canonical
    limbs as little-endian uint32: ct.c0 || ct.c1 || ct.c2, then for each k
    cm.c0[k] || cm.c1[k] || cm.c2[k].  ct [..., n], comms [..., V, n];
    returns one digest per ciphertext (row-major), after one host copy."""
    lead = ct.c0.shape[:-1]
    n = ct.c0.shape[-1]
    parts = [x.canon_limbs().reshape(lead + (-1, n, MNT4Q.nlimbs))
             for x in (ct.c0, ct.c1, ct.c2)]
    cparts = [x.canon_limbs() for x in (comms.c0, comms.c1, comms.c2)]
    rows = torch.cat(parts + [torch.stack(cparts, dim=-3).flatten(-4, -3)], dim=-3)
    # [..., 3 + 3V, n, 51]: ct.c0, ct.c1, ct.c2, then (c0, c1, c2) per k
    host = rows.to(torch.int32).cpu().numpy().astype("<u4")
    host = host.reshape((-1,) + host.shape[-3:])
    out = []
    for row in host:
        h = hashlib.blake2b(digest_size=32)
        h.update(row.tobytes())
        out.append(h.digest())
    return out


def challenge_bits(digest: bytes, v: int = SEC) -> list:
    """The first v bits of a Fiat-Shamir digest, least significant first."""
    return [(digest[k // 8] >> (k % 8)) & 1 for k in range(v)]


def _ebits(digests, lead, device):
    e = torch.as_tensor([challenge_bits(d) for d in digests], dtype=torch.bool,
                        device=device)
    return e.reshape(tuple(lead) + (SEC,))


def _where(sel, a: FpArray, b: FpArray) -> FpArray:
    """sel [..., V] picks a, else b, over [..., V, n] elements."""
    return FpArray(torch.where(sel[..., None, None], a.limbs, b.limbs), a.spec, 2)


def zkpopk_prove(ctx: DealerContext, slots: FpArray, r: bgv.EncRandomness,
                 ct: bgv.Ciphertext, generator, y: FpArray | None = None,
                 s: bgv.EncRandomness | None = None) -> ZkPoPK:
    """Prove knowledge of (m, r) for ct = Enc(m, r), m the encoded slots
    [..., n].  The response z lives in the lifted R_q message domain, where
    encryption is exactly linear (the centered lift is not additive mod p).
    ``y`` (Fr [..., V, n]) and ``s`` (EncRandomness [..., V, n]): injected
    masks in place of the generator's."""
    n = ctx.params.n
    lead = slots.shape[:-1]
    m_rq = _n2q(ring.lift_centered_p_to_q(bgv.encode(slots)))
    if y is None:
        y = R.uniform_fp(generator, FR, lead + (SEC, n), device=ctx.device)
    y_rq = _n2q(ring.lift_centered_p_to_q(bgv.encode(y)))
    if s is None:
        s = bgv.sample_enc_randomness(ctx.params, generator, lead + (SEC,),
                                      device=ctx.device)
    s = bgv.EncRandomness(_n2q(s.v), _n2q(s.e0), _n2q(s.e1))
    # every tensor is tightened to bound 2 (`_n2q`): encrypt outputs reach
    # bound ~6, and the verifier's equality checks canonicalize
    cm = _n2q_ct(bgv.encrypt_rq(ctx.pk, y_rq, s))
    digests = _hash_fs(ct, cm)
    e = _ebits(digests, lead, ctx.device)
    z = _where(e, _n2q(y_rq + _unsq(m_rq)), y_rq)
    t = bgv.EncRandomness(*(_where(e, _n2q(sk + _unsq(_n2q(rk))), sk)
                            for sk, rk in ((s.v, r.v), (s.e0, r.e0), (s.e1, r.e1))))
    return ZkPoPK(cm, digests[0] if not lead else digests, z, t)


def _unsq(x: FpArray) -> FpArray:
    """[..., n] -> [..., 1, n] (broadcast over the V commitments)."""
    return FpArray(x.limbs.unsqueeze(-3), x.spec, x.bound)


def _limbs_gt_const(canon, c: int, spec):
    """Elementwise (value > c) for canonical little-endian limb tensors, on
    the device (lexicographic from the most significant limb)."""
    cl = torch.as_tensor(int_to_limbs(c, spec.nlimbs), device=canon.device)
    gt = canon > cl
    eq = (canon == cl).to(torch.int64)
    # value > c iff some limb j has limb_j > c_j and the limbs above j equal
    eq_above = torch.flip(torch.cumprod(torch.flip(eq, (-1,)), dim=-1), (-1,))
    eq_above = torch.cat([eq_above[..., 1:], torch.ones_like(eq_above[..., :1])], dim=-1)
    return (gt & (eq_above > 0)).any(dim=-1)


def _norm_violation(x: FpArray, thr: int):
    """Device bool: any coefficient with |centered lift| > thr."""
    q = x.spec.p
    limbs = x.int_limbs()
    viol = _limbs_gt_const(limbs, thr, x.spec) & \
        ~_limbs_gt_const(limbs, q - thr - 1, x.spec)
    return viol.any()


def _inf_norm_exceeds(x: FpArray, thr: int) -> bool:
    """max |centered lift| > thr, evaluated on the device in one pass."""
    return bool(_norm_violation(x, thr))


def _responses_ok(ctx: DealerContext, ct: bgv.Ciphertext, proof: ZkPoPK, e):
    """Device bool: Enc_rq(z_k, t_k) == a_k + e_k * ct for every k, and the
    norm bounds of z and t (e: challenge bits [..., V])."""
    lhs = bgv.encrypt_rq(ctx.pk, proof.z, proof.t)
    ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    for lc, cs, c in ((lhs.c0, proof.commitments.c0, ct.c0),
                      (lhs.c1, proof.commitments.c1, ct.c1)):
        rhs = _where(e, _n2q(_n2q(cs) + _unsq(_n2q(c))), _n2q(cs))
        ok = ok & (lc.canon_limbs() == rhs.canon_limbs()).all()
    t_all = FpArray.stack([proof.t.v, proof.t.e0, proof.t.e1])
    return ok & ~_norm_violation(proof.z, 2 * TAU) & ~_norm_violation(t_all, 2 * RHO)


def zkpopk_verify(ctx: DealerContext, ct: bgv.Ciphertext, proof: ZkPoPK) -> bool:
    """Recompute the challenge, then check the re-encryption equality
    Enc_rq(z_k, t_k) == a_k + e_k * ct AND the DPSZ Fig. 10 infinity-norm
    bounds on the responses (which the reference leaves out,
    `preprocessing.rs:258-328`)."""
    lead = ct.c0.shape[:-1]
    digests = _hash_fs(ct, proof.commitments)
    if digests != (proof.challenge if lead else [proof.challenge]):
        return False
    return bool(_responses_ok(ctx, ct, proof, _ebits(digests, lead, ctx.device)))


def _diag_encrypt_with_popk(ctx: DealerContext, vals: FpArray, generator):
    """Encrypt diag(vals_j) per party with a ZKPoPK each; -> list of cts.

    Batched over the parties: one encryption, one proof (one host copy for
    the Fiat-Shamir hashes) and one check of the responses, with the
    challenge bits the prover hashed."""
    P_, n = ctx.n_parties, ctx.params.n
    d = FpArray(vals.limbs[:, None, :].expand(P_, n, FR.nlimbs), FR, vals.bound)
    r = bgv.sample_enc_randomness(ctx.params, generator, (P_,), device=ctx.device)
    ct = _n2q_ct(bgv.encrypt_slots(ctx.pk, ctx.params, d, r))
    proof = zkpopk_prove(ctx, d, r, ct, generator)
    e = _ebits(proof.challenge, (P_,), ctx.device)
    if not bool(_responses_ok(ctx, ct, proof, e)):
        raise AssertionError("ZKPoPK rejected")
    zero = FpArray.zeros(MNT4Q, (n,), ctx.device)
    return [bgv.Ciphertext(ct.c0[i], ct.c1[i], zero) for i in range(P_)]


# ---------------------------------------------------------------------------
# Triple source backed by preprocessing (closing the loop the reference
# leaves open: its online phase uses dummy triples, `wire/field.rs:44-63`)
# ---------------------------------------------------------------------------


class _Pool:
    """Slots of preprocessed batches not yet served: a tuple of FpArrays
    [P, k] each, refilled a whole batch at a time.  Counts the batches run
    and the slots served."""

    def __init__(self, make):
        self.make = make
        self.items = None
        self.batches = 0
        self.served = 0

    def take(self, total: int):
        self.served += total
        while self.items is None or self.items[0].shape[1] < total:
            new = self.make()
            self.batches += 1
            self.items = new if self.items is None else tuple(
                FpArray.concat([a, b], axis=1) for a, b in zip(self.items, new))
        out = tuple(FpArray(x.limbs[:, :total], x.spec, x.bound) for x in self.items)
        self.items = tuple(FpArray(x.limbs[:, total:], x.spec, x.bound)
                           for x in self.items)
        return out


def _shaped(x: FpArray, mac: FpArray, shape) -> MpcFp:
    """Pool slots [P, k] -> a shared wire of batch ``shape``, with its MAC
    shares when an SPDZ context is in scope."""
    def f(v: FpArray) -> FpArray:
        return v.reshape((v.shape[0],) + tuple(shape))
    return MpcFp(f(x), SHARED, f(mac) if spdz_in_scope() else None)


class SheTripleSource:
    """Serves Beaver triples, inverse pairs and random shares from
    preprocessing batches (`triple`, `inv_pair`, `pair`), with their MAC
    shares under the SPDZ backend (the values alone under the semi-honest
    one).

    Every slot of a batch is served once: a request takes the unused slots
    of earlier batches first and runs a new batch only for the rest (the
    JAX package runs at least one whole batch per request and drops the
    unused slots); a slot's MAC shares travel with its value.  A triple
    batch and a batch of <r> shares cover ``ciphertexts`` ciphertexts of n
    slots (the JAX package's cover one; its <r> batches also compute the
    [r] representation, which no wire uses).  ``batches`` counts the
    batches run and ``served`` the slots served, per kind."""

    def __init__(self, ctx: DealerContext, generator, ciphertexts: int = 1):
        self.ctx = ctx
        self.generator = generator
        # pool items: (value, mac) pairs, in the order of the batch outputs
        self._triples = _Pool(lambda: triple_kernel(ctx, generator, ciphertexts))
        self._inv = _Pool(lambda: tuple(_n2q(x) for pair_ in inv_pair(ctx, generator)
                                        for x in pair_))
        self._rand = _Pool(lambda: rand_kernel(ctx, generator, ciphertexts))

    def _pools(self):
        return {"triple": self._triples, "inv_pair": self._inv, "pair": self._rand}

    @property
    def batches(self) -> dict:
        """Preprocessing batches run, by kind."""
        return {k: p.batches for k, p in self._pools().items()}

    @property
    def served(self) -> dict:
        """Slots served, by kind (a group triple takes one field triple)."""
        return {k: p.served for k, p in self._pools().items()}

    @staticmethod
    def _total(shape) -> int:
        return int(np.prod(shape, dtype=np.int64)) if shape else 1

    def _take(self, pool: _Pool, shape) -> tuple:
        got = pool.take(self._total(shape))
        return tuple(_shaped(got[i], got[i + 1], shape) for i in range(0, len(got), 2))

    def field_triples(self, spec, shape):
        assert spec is FR
        return self._take(self._triples, shape)

    def inv_pairs(self, spec, shape):
        """(r, r^-1); the MAC of r^-1 is that of its own encryption."""
        assert spec is FR
        return self._take(self._inv, shape)

    def group_triples(self, P, scalar_spec):
        """Group Beaver triple (a, B, C = a*B) for scaling a shared point by
        a shared scalar (`share/group.rs:72-111`), from a field triple by the
        linearity of s -> s*G: each party maps its shares of b and c = a*b
        through the fixed-base product with the group generator, and under
        SPDZ its MAC shares the same way (sum_i mac_b_i * G = alpha * B)."""
        from ..mpc.group import MpcSWPoint
        from ..ops.curve import SWPoint, sw_scalar_mul
        from ..ops.fp2 import Fp2Array
        from ..spec import curves as SC

        a, b, c = self.field_triples(scalar_spec, P.shape)
        if isinstance(P.point.x, Fp2Array):
            gen = SWPoint.g2_from_affine_ints([SC.G2_GEN], b.value.device)
        else:
            gen = SWPoint.g1_from_affine_ints([SC.G1_GEN], b.value.device)
        scal = [b.value, c.value] + ([b.mac, c.mac] if b.mac is not None else [])
        # every scalar through one batched ladder on the shared generator
        pts = sw_scalar_mul(gen[0], FpArray.stack(scal))
        macs = (pts[2], pts[3]) if b.mac is not None else (None, None)
        return a, MpcSWPoint(pts[0], SHARED, macs[0]), MpcSWPoint(pts[1], SHARED, macs[1])

    def rand_shares(self, spec, shape):
        """Random shared values from the <r> pair batches
        (`preprocessing.rs:823-878`), with their MAC shares under SPDZ."""
        assert spec is FR
        (r,) = self._take(self._rand, shape)
        return r
