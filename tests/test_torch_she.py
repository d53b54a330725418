"""The port's SHE layer and SPDZ preprocessing (`zkmpc_tpu_torch.she`)
against the JAX package, at 8 slots and 3 parties.

XLA:CPU compiles of the JAX package's 51-limb graphs take minutes, so its
results come from a committed fixture (`fixtures/make_torch_she_fixture.py`;
a `slow` test regenerates it live).  Exact everywhere:

- the negacyclic product, encode/decode, the centered lift and reduction,
  and the samplers with injected draws give the JAX package's limbs;
- the JAX dealer carried across (`dealer_from_host`) decrypts the JAX
  ciphertext, and the port's encryption under the JAX randomness equals it;
- the port's Fiat-Shamir challenge, and its ZKPoPK under the JAX masks,
  equal JAX's; the port's verifier accepts the JAX proof and rejects it
  with one response coefficient changed;
- the port's initialize, pair, inv_pair and triple on the carried dealer
  open to consistent values: sums of shares, a*b = c, mac = alpha*value,
  r*r^-1 = 1, bracket macs = beta_j*value.
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_she_fixture as SF
from torch_parity import CPU
from zkmpc_tpu_torch.ops import cuda_fp
from zkmpc_tpu_torch.ops.limbs import FR, MNT4Q, FpArray
from zkmpc_tpu_torch.she import bgv, ring
from zkmpc_tpu_torch.she import preprocessing as PP

torch.set_num_threads(1)

P, Q = FR.p, MNT4Q.p
N = SF.N_SLOTS
NP = SF.N_PARTIES
SPECS = {FR.name: FR, MNT4Q.name: MNT4Q}


@pytest.fixture(scope="module")
def fx():
    return SF.load(np.load(SF.PATH))


@pytest.fixture(scope="module")
def dealer(fx):
    return PP.dealer_from_host(SF.dealer_doc(fx), CPU)


def fp(fx, name) -> FpArray:
    """A fixture array as the port's FpArray (same limbs, spec and bound)."""
    meta = fx["json"]["meta"][name]
    return FpArray(torch.as_tensor(fx["arrays"][name].astype(np.int64)),
                   SPECS[meta["spec"]], meta["bound"])


def ins(fx, name, spec, shape=None):
    vals = np.asarray(fx["json"]["ring_inputs"][name], dtype=object)
    return FpArray.from_int(spec, vals.reshape(shape or vals.shape), device=CPU)


def assert_limbs(got: FpArray, want: FpArray):
    assert got.bound == want.bound
    np.testing.assert_array_equal(got.limbs.numpy(), want.limbs.numpy())


def assert_values(got: FpArray, want: FpArray):
    """Equal values: the canonical limbs of the two Montgomery forms."""
    assert got.shape == want.shape
    assert torch.equal(got.canon_limbs(), want.canon_limbs())


def ct_of(fx, prefix) -> bgv.Ciphertext:
    return bgv.Ciphertext(*(fp(fx, f"{prefix}.{k}") for k in ("c0", "c1", "c2")))


def rand_of(fx, prefix) -> bgv.EncRandomness:
    return bgv.EncRandomness(*(fp(fx, f"{prefix}.{k}") for k in ("v", "e0", "e1")))


def opened(x: FpArray) -> list:
    """Host ints of additive shares [P, ...]: the sums over the party axis."""
    v = x.to_ints()
    return [int(s) % P for s in np.sum(v, axis=0).reshape(-1)]


def test_ring_product_and_slot_packing_match_reference(fx):
    a, b = ins(fx, "mul_a", MNT4Q, (2, N)), ins(fx, "mul_b", MNT4Q, (2, N))
    got = ring.negacyclic_mul(a, b)
    assert_limbs(got, fp(fx, "mul"))
    # and the schoolbook product mod X^N + 1
    ai, bi = a.to_ints(), b.to_ints()
    for row in range(2):
        want = [0] * N
        for i in range(N):
            for j in range(N):
                sgn = 1 if i + j < N else -1
                want[(i + j) % N] = (want[(i + j) % N] + sgn * ai[row][i] * bi[row][j]) % Q
        assert got.to_ints()[row].tolist() == want
    slots = ins(fx, "enc_slots", FR, (2, N))
    enc = bgv.encode(slots)
    assert_limbs(enc, fp(fx, "encode"))
    assert_limbs(bgv.decode(ins(fx, "dec_coeffs", FR, (2, N))), fp(fx, "decode"))
    assert bgv.decode(enc).to_ints().tolist() == slots.to_ints().tolist()
    assert torch.equal(ring.negacyclic_intt(ring.negacyclic_ntt(a)).canon_limbs(),
                       a.canon_limbs())


def test_lift_and_reduce_match_reference(fx):
    x = ins(fx, "lift", FR)
    lifted = ring.lift_centered_p_to_q(x)
    assert_limbs(lifted, fp(fx, "lift"))
    h = (P - 1) // 2
    assert lifted.to_ints().tolist() == [v if v <= h else Q - (P - v)
                                         for v in x.to_ints().tolist()]
    y = ins(fx, "reduce", MNT4Q)
    assert_limbs(ring.reduce_centered_q_to_p(y), fp(fx, "reduce"))
    assert ring.reduce_centered_q_to_p(lifted).to_ints().tolist() == x.to_ints().tolist()


def test_samplers_with_injected_draws_match_reference(fx):
    arr = fx["arrays"]
    assert_limbs(ring.gaussian_coeffs(None, N, (2,), device=CPU, draws=arr["gauss_draws"]),
                 fp(fx, "gauss"))
    bits = [arr["uniform_hi"].astype(np.int64), arr["uniform_lo"].astype(np.int64)]
    assert_limbs(ring.uniform_rq(None, N, (2,), device=CPU, bits=bits), fp(fx, "uniform"))
    # the port's own draws: rounded normals of deviation 3.2, uniform elements
    g = torch.Generator().manual_seed(1)
    d = ring.gaussian_draws(g, 4096)
    assert d.abs().max() < 32 and 2.8 < float(d.double().std()) < 3.6
    e = ring.gaussian_coeffs(g, 8, device=CPU, draws=np.asarray([-3, 0, 2, -1, 5, 0, 0, -7]))
    assert e.to_ints().tolist() == [Q - 3, 0, 2, Q - 1, 5, 0, 0, Q - 7]
    u = ring.uniform_rq(g, 8, device=CPU).to_ints().tolist()
    assert len(set(u)) == 8 and all(0 <= v < Q for v in u)
    # encryption randomness from injected draws: one gaussian sample each
    d = [np.arange(-8, 8).reshape(2, 8) * k for k in (1, 2, 3)]
    r = bgv.sample_enc_randomness(bgv.SheParams(N), None, (2,), device=CPU, draws=d)
    for got, want in zip((r.v, r.e0, r.e1), d):
        assert_limbs(got, ring.gaussian_coeffs(None, N, (2,), device=CPU, draws=want))


def test_dealer_carried_across_decrypts_and_encrypts_like_reference(fx, dealer):
    params = dealer.params
    assert (params.n, dealer.n_parties) == (N, NP)
    slots = ins(fx, "ct_slots", FR)
    ct = ct_of(fx, "ct")
    assert bgv.decrypt_slots(dealer.sk, ct).to_ints().tolist() == slots.to_ints().tolist()
    mine = bgv.encrypt_slots(dealer.pk, params, slots, rand_of(fx, "ct_r"))
    for k in ("c0", "c1", "c2"):
        assert_values(getattr(mine, k), getattr(ct, k))
    # the layout goes back unchanged
    back = PP.dealer_to_host(dealer)
    doc = SF.dealer_doc(fx)

    def same(a, b):
        if a is None or b is None:
            assert a is b
        elif a[0] == "fp":
            assert a[:3] == b[:3]
            np.testing.assert_array_equal(a[3], b[3])
        elif a[0] == "ct":
            for x, y in zip(a[1:], b[1:]):
                same(x, y)
        else:
            assert a[1] == b[1] and len(a[2]) == len(b[2])
            for x, y in zip(a[2], b[2]):
                same(x, y)
    for k, v in doc.items():
        if isinstance(v, tuple):
            same(back[k], v)
        else:
            assert back[k] == v, k
    # the ciphertexts of initialize decrypt to the key shares in every slot
    alpha = sum(dealer.alpha_shares.to_ints().tolist()) % P
    assert bgv.decrypt_slots(dealer.sk, dealer.e_alpha).to_ints().tolist() == [alpha] * N
    beta = dealer.beta.to_ints().tolist()
    for j in range(NP):
        assert bgv.decrypt_slots(dealer.sk, dealer.e_beta[j]).to_ints().tolist() == [beta[j]] * N


def _popk_of(fx) -> PP.ZkPoPK:
    return PP.ZkPoPK(ct_of(fx, "popk_cm"), fx["arrays"]["popk_challenge"].tobytes(),
                     fp(fx, "popk_z"), rand_of(fx, "popk_t"))


def test_fiat_shamir_challenge_matches_reference(fx):
    proof = _popk_of(fx)
    (digest,) = PP._hash_fs(ct_of(fx, "ct"), proof.commitments)
    assert digest == proof.challenge
    bits = PP.challenge_bits(digest)
    assert bits == [(proof.challenge[0] >> k) & 1 for k in range(PP.SEC)]
    # the bytes are the canonical limbs as little-endian uint32, not the
    # int64 limb buffer: a different ciphertext gives a different digest
    other = ct_of(fx, "ct")
    other = bgv.Ciphertext(other.c1, other.c0, other.c2)
    assert PP._hash_fs(other, proof.commitments)[0] != digest


def test_zkpopk_with_injected_masks_matches_reference(fx, dealer):
    want = _popk_of(fx)
    got = PP.zkpopk_prove(dealer, ins(fx, "ct_slots", FR), rand_of(fx, "ct_r"),
                          ct_of(fx, "ct"), None, y=fp(fx, "popk_y"),
                          s=rand_of(fx, "popk_s"))
    assert got.challenge == want.challenge
    for k in ("c0", "c1", "c2"):
        assert_values(getattr(got.commitments, k), getattr(want.commitments, k))
    assert_values(got.z, want.z)
    for k in ("v", "e0", "e1"):
        assert_values(getattr(got.t, k), getattr(want.t, k))


def test_zkpopk_verify_accepts_reference_proof_and_rejects_tampered(fx, dealer):
    ct, proof = ct_of(fx, "ct"), _popk_of(fx)
    assert PP.zkpopk_verify(dealer, ct, proof)

    def bumped(x: FpArray, k, i):
        ints = x.to_ints()
        ints[k, i] = (ints[k, i] + 1) % x.spec.p
        return FpArray.from_int(x.spec, ints, device=CPU)
    bad_z = PP.ZkPoPK(proof.commitments, proof.challenge, bumped(proof.z, 3, 5), proof.t)
    assert not PP.zkpopk_verify(dealer, ct, bad_z)
    t = proof.t
    bad_t = PP.ZkPoPK(proof.commitments, proof.challenge, proof.z,
                      bgv.EncRandomness(t.v, bumped(t.e0, 0, 2), t.e1))
    assert not PP.zkpopk_verify(dealer, ct, bad_t)
    flipped = bytes([proof.challenge[0] ^ 1]) + proof.challenge[1:]
    assert not PP.zkpopk_verify(dealer, ct, PP.ZkPoPK(proof.commitments, flipped,
                                                      proof.z, proof.t))
    # a response within the re-encryption equation but beyond the norm
    # bound: an honest proof of a ciphertext with randomness of norm 3 * RHO
    far = rand_of(fx, "ct_r")
    big = FpArray.from_int(MNT4Q, np.asarray([3 * PP.RHO] + [0] * (N - 1), dtype=object),
                           device=CPU)
    far = bgv.EncRandomness(far.v + big, far.e0, far.e1)
    slots = ins(fx, "ct_slots", FR)
    ct_far = PP._n2q_ct(bgv.encrypt_slots(dealer.pk, dealer.params, slots, far))
    loud = PP.zkpopk_prove(dealer, slots, far, ct_far, torch.Generator().manual_seed(3))
    assert not PP._inf_norm_exceeds(loud.z, 2 * PP.TAU)
    assert PP.zkpopk_verify(dealer, ct_far, loud) == (not any(PP.challenge_bits(loud.challenge)))


def test_preprocessing_on_carried_dealer_opens_consistently(fx, dealer):
    g = torch.Generator().manual_seed(5)
    alpha = sum(dealer.alpha_shares.to_ints().tolist()) % P
    beta = dealer.beta.to_ints().tolist()

    def macs_ok(vals, macs, key=alpha):
        assert opened(macs) == [key * v % P for v in opened(vals)]

    # the JAX triple batch, and bracket(alpha), under the carried key
    ta, tma, tb, tmb, tc, tmc = (fp(fx, f"triple.{k}") for k in ("a", "ma", "b", "mb", "c", "mc"))
    assert all(x * y % P == z for x, y, z in zip(opened(ta), opened(tb), opened(tc)))
    for v, m in ((ta, tma), (tb, tmb), (tc, tmc)):
        macs_ok(v, m)
    shares, bmacs = dealer.alpha_bracket
    assert opened(shares) == [alpha] * N
    for j in range(NP):
        macs_ok(shares, bmacs[j], beta[j])

    # the port's own batches on the JAX keys
    (a, ma), (b, mb), (c, mc) = PP.triple(dealer, g)
    assert all(x * y % P == z for x, y, z in zip(opened(a), opened(b), opened(c)))
    for v, m in ((a, ma), (b, mb), (c, mc)):
        macs_ok(v, m)
    (r, mr), (ri, mri) = PP.inv_pair(dealer, g)
    assert all(x * y % P == 1 for x, y in zip(opened(r), opened(ri)))
    macs_ok(r, mr)
    macs_ok(ri, mri)
    (pr, pm), (pr2, pb) = PP.pair(dealer, g)
    assert pr2 is pr
    macs_ok(pr, pm)
    for j in range(NP):
        macs_ok(pr, pb[j], beta[j])
    # reshare with injected masks: the other parties keep -f
    f = FpArray.from_int(FR, np.arange(1, NP * N + 1, dtype=object).reshape(NP, N), device=CPU)
    shares, fresh = PP.reshare(dealer, dealer.e_alpha, g, new_ciphertext=True, f=f)
    assert opened(shares) == [alpha] * N
    assert [v.tolist() for v in shares[1:].to_ints()] == \
        [[(-(i * N + k + 1)) % P for k in range(N)] for i in range(1, NP)]
    assert bgv.decrypt_slots(dealer.sk, fresh).to_ints().tolist() == [alpha] * N


def test_initialize_on_carried_keys_and_triple_kernel(fx):
    """The port's initialize (ZKPoPKs accepted) replaces the key shares, and
    its triples carry MACs under the new alpha."""
    ctx = PP.dealer_from_host(SF.dealer_doc(fx), CPU)
    g = torch.Generator().manual_seed(6)
    alpha_i = PP.initialize(ctx, g)
    alpha = sum(alpha_i.to_ints().tolist()) % P
    assert bgv.decrypt_slots(ctx.sk, ctx.e_alpha).to_ints().tolist() == [alpha] * N
    shares, bmacs = ctx.alpha_bracket
    beta = ctx.beta.to_ints().tolist()
    for j in range(NP):
        assert opened(bmacs[j]) == [beta[j] * alpha % P] * N
    a, ma, b, mb, c, mc = PP.triple_kernel(ctx, g)
    assert all(x.bound == 2 for x in (a, ma, b, mb, c, mc))
    assert all(x * y % P == z for x, y, z in zip(opened(a), opened(b), opened(c)))
    assert opened(mc) == [alpha * v % P for v in opened(c)]
    # two ciphertexts in one batch: [P, 2n] triples
    a, ma, b, mb, c, mc = PP.triple_kernel(ctx, g, ciphertexts=2)
    assert a.shape == mc.shape == (NP, 2 * N)
    assert all(x * y % P == z for x, y, z in zip(opened(a), opened(b), opened(c)))
    for v, m in ((a, ma), (b, mb), (c, mc)):
        assert opened(m) == [alpha * x % P for x in opened(v)]


def test_own_dealer_round_trip_and_k1_routing():
    """A dealer from the port's own key generation: encryption round trip,
    a homomorphic product, and every 51-limb product of a negacyclic
    multiply on CPU tensors goes to K1's plain version (the card's route is
    counted by the `gpu` test in `test_torch_cuda.py`)."""
    g = torch.Generator().manual_seed(2)
    ctx = PP.make_dealer(bgv.SheParams(N), NP, g, device=CPU)
    slots = FpArray.from_int(FR, np.arange(3, 3 + N, dtype=object), device=CPU)
    r = bgv.sample_enc_randomness(ctx.params, g, device=CPU)
    ct = bgv.encrypt_slots(ctx.pk, ctx.params, slots, r)
    assert bgv.decrypt_slots(ctx.sk, ct).to_ints().tolist() == list(range(3, 3 + N))
    assert bgv.decrypt_slots(ctx.sk, ct.mul(ct)).to_ints().tolist() == \
        [v * v for v in range(3, 3 + N)]
    w = FpArray.from_int(FR, np.arange(1, 1 + N, dtype=object), device=CPU)
    scaled = ct.mul_plain(ring.lift_centered_p_to_q(bgv.encode(w)))
    assert bgv.decrypt_slots(ctx.sk, scaled).to_ints().tolist() == \
        [v * (v - 2) for v in range(3, 3 + N)]
    calls = []
    orig = cuda_fp.mont_mul_plain

    def counted(spec, a, b):
        calls.append(spec.nlimbs)
        return orig(spec, a, b)
    cuda_fp.mont_mul_plain = counted
    try:
        ring.negacyclic_mul(ct.c0, ct.c1)
    finally:
        cuda_fp.mont_mul_plain = orig
    assert calls and set(calls) == {MNT4Q.nlimbs}


@pytest.mark.slow
def test_she_fixture_against_live_reference():
    """Regenerates the fixture with the JAX package (tens of minutes on a
    CPU) and requires the committed file's deterministic parts."""
    live = SF.load(SF.generate())
    committed = SF.load(np.load(SF.PATH))
    for name, arr in committed["arrays"].items():
        np.testing.assert_array_equal(live["arrays"][name], arr, err_msg=name)
    assert live["json"] == committed["json"]
