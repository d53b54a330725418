"""The port's KZG and collaborative Marlin against the JAX package.

The JAX side is read from ``fixtures/torch_marlin_3p.npz``
(`fixtures/make_torch_marlin_fixture.py`: the JAX package's prove of
``tests/test_marlin.py``'s 2-gate circuit at 3 parties, some 13 minutes of
eager dispatch on a CPU), which a `slow` test regenerates; the share draws
of ``king_share`` and the five ``rand_shared`` draws are injected, so the
port's proof must equal the JAX package's value for value, down to the
transcript digest ``tests/test_marlin.py`` pins.

- ChaCha20 words, the Fiat-Shamir RNG and the point encodings it absorbs.
- The SRS from the same seed; an SRS file the JAX package wrote loads, and
  the index on it commits to the JAX index's points; a zero tau is redrawn.
- The proof; and the verifier rejects a wrong instance, a tampered
  evaluation or witness, a forged degree bound, and returns False (does not
  raise) on malformed proofs.
- `slow`: the prove on the SPDZ backend (MAC checks pass, a tampered
  commitment share fails), and the live regeneration.
"""

import copy

import numpy as np
import pytest
import torch

from fixtures import make_torch_marlin_fixture as MF
from torch_parity import CPU
from zkmpc_tpu_torch.compat import ark as TA
from zkmpc_tpu_torch.compat import chacha as TCH
from zkmpc_tpu_torch.mpc import rand as R
from zkmpc_tpu_torch.mpc.share import (DummyTripleSource, MpcContext, MpcFp, king_share,
                                       mpc_scope)
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.snark import kzg, marlin
from zkmpc_tpu_torch.snark.r1cs import LC, ConstraintSystem
from zkmpc_tpu_torch.spec import curves as SC

torch.set_num_threads(1)

P = FR.p
DIGEST = "651a4b6a4b317724ab0ba1d2084e99c5607d554349a6b3ac034ae7dff485a057"


def _fr(vals):
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=CPU)


def _fa(pair):
    return FpArray(torch.as_tensor(pair[0]), FR, pair[1])


def _build(cs, king=None, generator=None):
    """``test_marlin._build``: a = [3, 4], b = [5, 6] dealt, c = a * b public;
    ``king``: the JAX share draws, else drawn from ``generator``."""
    a, b = (king_share(_fr(v), generator, shares=None if king is None else _fa(k))
            for v, k in zip((MF.A_VALS, MF.B_VALS), king or (None, None)))
    a_vars, b_vars = cs.new_witness_vec(a), cs.new_witness_vec(b)
    c_vars = cs.new_instance_vec(MpcFp.const(FR, [x * y for x, y in zip(MF.A_VALS, MF.B_VALS)]))
    for i in range(2):
        cs.enforce(LC.of(a_vars[i]), LC.of(b_vars[i]), LC.of(c_vars[i]))


@pytest.fixture(scope="module")
def fx():
    return MF.load(np.load(MF.PATH))


@pytest.fixture(scope="module")
def proved(fx, tmp_path_factory):
    """The port's index on the SRS file the JAX package wrote, its index
    from the fixture's commitments, and its proof on the JAX draws."""
    from zkmpc_tpu.snark import kzg as JK
    jsrs = JK.setup(fx["index"]["degree"], seed=MF.SRS_SEED)
    path = str(tmp_path_factory.mktemp("srs") / "srs.json")
    JK.save_srs(jsrs, path)
    with mpc_scope(MpcContext(StackedTransport(MF.N_PARTIES, CPU), "semi")):
        cs = ConstraintSystem(FR)
        _build(cs, fx["king"])
        srs = kzg.load_srs(path)
        index = marlin.index_with_srs(srs, cs, CPU)
        host = marlin.index_from_host(srs, cs, fx["index"]["comms"], CPU)
        proof = marlin.prove(host, cs, masks=[_fa(r) for r in fx["rand"]])
        instance = cs.instance_ints()
    return dict(jsrs=jsrs, srs=srs, index=index, host=host, proof=proof,
                instance=instance, cs=cs)


def test_chacha20_and_fiat_shamir_match_reference():
    from zkmpc_tpu.compat import ark as JA
    from zkmpc_tpu.compat import chacha as JCH
    seed = bytes(range(32))
    for rounds in (8, 12, 20):
        t, j = TCH.ChaChaRng(seed, rounds), JCH.ChaChaRng(seed, rounds)
        # across a 64-word buffer edge, u32 and u64 interleaved
        assert [t.next_u32() if i % 3 else t.next_u64() for i in range(90)] == \
            [j.next_u32() if i % 3 else j.next_u64() for i in range(90)]
    assert TCH.chacha_block(list(range(16))) == JCH.chacha_block(list(range(16)))
    assert TCH.chacha_block(list(range(16)), 12) == JCH.chacha_block(list(range(16)), 12)
    t, j = TA.marlin_fs_init(b"vk", [1, 15, 24]), JA.marlin_fs_init(b"vk", [1, 15, 24])
    assert t.seed == j.seed
    for material in (b"", b"x" * 97, bytes(range(200))):
        t.absorb(material)
        j.absorb(material)
        # fr_rand's rejection loop must use the reference's words exactly
        assert [t.fr_challenge() for _ in range(4)] == [j.fr_challenge() for _ in range(4)]
        assert (t.next_u32(), t.next_u64()) == (j.next_u32(), j.next_u64())
    assert TA.fq_rand(TA.seeded_rng(5)) == JA.fq_rand(JA.seeded_rng(5))
    pts = [None, SC.G1_GEN, SC.g1_mul(SC.G1_GEN, 7)]
    for f in ("g1_uncompressed", "g1_affine_to_bytes"):
        assert [getattr(TA, f)(p) for p in pts] == [getattr(JA, f)(p) for p in pts]
    assert len(TA.g1_affine_to_bytes(pts[2])) == 97
    for p in (None, SC.G2_GEN, SC.g2_mul(SC.G2_GEN, 3)):
        assert TA.g2_uncompressed(p) == JA.g2_uncompressed(p)


def test_srs_and_index_match_reference(fx, proved, tmp_path, monkeypatch):
    from zkmpc_tpu.compat import ark as JA
    from zkmpc_tpu.snark import kzg as JK
    jsrs, srs = proved["jsrs"], proved["srs"]
    # the JAX package's SRS file loads, and the port's own setup is equal
    assert (srs.powers, srs.g2, srs.beta_g2) == (jsrs.powers, jsrs.g2, jsrs.beta_g2)
    mine = kzg.setup(fx["index"]["degree"], seed=MF.SRS_SEED, device=CPU)
    assert (mine.powers, mine.g2, mine.beta_g2) == (jsrs.powers, jsrs.g2, jsrs.beta_g2)
    kzg.save_srs(mine, str(tmp_path / "srs.json"))
    back = JK.load_srs(str(tmp_path / "srs.json"))
    assert (back.powers, back.g2, back.beta_g2) == (jsrs.powers, jsrs.g2, jsrs.beta_g2)
    # the index on it: sizes, layout and matrix commitments of the JAX index
    want = fx["index"]
    for index in (proved["index"], proved["host"]):
        assert (index.domain_n, index.nx, index.num_instance, index.num_witness) == \
            (want["domain_n"], want["nx"], want["num_instance"], want["num_witness"])
        assert [int(v) for v in index.perm] == want["perm"]
        assert [dict(k=m.k_size, row=m.com_row, col=m.com_col, val=m.com_val)
                for m in index.index_comms] == want["comms"]
    for a, b in zip(proved["index"].index_comms, proved["host"].index_comms):
        for name in ("row_poly", "col_poly", "val_poly"):
            assert torch.equal(getattr(a, name).limbs, getattr(b, name).limbs)
    assert marlin.srs_degree_for(proved["cs"]) == want["degree"]
    # tau is the reference's first draw for a normal seed, and a zero draw
    # is redrawn from the same stream
    for seed in (0, 1, MF.SRS_SEED):
        assert kzg._draw_tau(seed) == JA.fr_rand(JA.seeded_rng(seed))
    stream = iter([0, 0, 12345])
    monkeypatch.setattr(kzg.A_, "fr_rand", lambda rng: next(stream))
    assert kzg._draw_tau(MF.SRS_SEED) == 12345 and next(stream, None) is None


def test_kzg_commit_and_open(proved):
    """`commit_many` (plain and shifted) and `open_at` over shared
    coefficients: the commitments are sum_i c_i tau^(i+shift) G, the
    opening verifies, a wrong value does not."""
    srs = proved["srs"]
    coeffs = [5, P - 7, 11, 2 ** 200 + 3]
    z, shift = 0x1234567, 4
    gen = torch.Generator().manual_seed(8)
    with mpc_scope(MpcContext(StackedTransport(MF.N_PARTIES, CPU), "semi")):
        dsrs = srs.device(CPU)
        shared = king_share(_fr(coeffs), gen)
        com, com_s = (c.reveal()[0].to_affine_ints()[0] for c in
                      kzg.commit_many(dsrs, [(shared, 0), (shared, shift)]))
        w, v = kzg.open_at(dsrs, shared, _fr(z))
        w = w.reveal()[0].to_affine_ints()[0]
        v = int(v.reveal().to_ints()[0])
    for got, s in ((com, 0), (com_s, shift)):
        want = None
        for i, c in enumerate(coeffs):
            want = SC.g1_add(want, SC.g1_mul(srs.powers[i + s], c))
        assert got == want
    assert v == sum(c * pow(z, i, P) for i, c in enumerate(coeffs)) % P
    assert kzg.verify_open(srs, com, z, v, w)
    assert not kzg.verify_open(srs, com, z, (v + 1) % P, w)


def test_proof_matches_reference(fx, proved):
    proof, want = proved["proof"], fx["proof"]
    assert want["fs_digest"] == DIGEST
    assert set(proof) == set(want)
    for key in want:
        assert proof[key] == want[key], key
    assert marlin.verify(proved["host"], proved["instance"], proof)
    assert marlin.verify(proved["index"], proved["instance"], proof)


def _malformed(proof, index):
    """Proofs of the wrong shape, each of which the shape check itself (not
    only the transcript replay) must reject."""
    out = [None, [], {}, dict(proof, coms=None)]
    for key in ("coms", "evals", "w_beta", "eta", "mat_proofs"):
        p = copy.deepcopy(proof)
        del p[key]
        out.append(p)
    p = copy.deepcopy(proof)
    del p["coms"]["za"]
    out.append(p)
    p = copy.deepcopy(proof)
    p["coms"]["w"] = "garbage"
    out.append(p)
    p = copy.deepcopy(proof)
    p["coms"]["zb"] = (1, 2)                       # off the curve
    out.append(p)
    p = copy.deepcopy(proof)
    p["w_beta"] = (SC.P, 0)                        # not a field element
    out.append(p)
    p = copy.deepcopy(proof)
    p["evals"]["zc"] = None
    out.append(p)
    p = copy.deepcopy(proof)
    p["evals"]["m"] = P                            # not canonical
    out.append(p)
    p = copy.deepcopy(proof)
    p["eta"] = p["eta"][:2]
    out.append(p)
    p = copy.deepcopy(proof)
    p["mat_proofs"][0]["k"] = index.index_comms[0].k_size * 2
    out.append(p)
    p = copy.deepcopy(proof)
    del p["mat_proofs"][1]["evals"]["h3"]
    out.append(p)
    p = copy.deepcopy(proof)
    p["mat_proofs"] = p["mat_proofs"][:2]
    out.append(p)
    out.append(dict(proof, mat_proofs=[]))             # no round 3 at all
    out.append(dict(proof, mat_proofs=None))
    p = copy.deepcopy(proof)
    del p["w_beta3"]
    out.append(p)
    p = copy.deepcopy(proof)
    p["mat_proofs"][2]["sigma"] = "1"
    out.append(p)
    return out


def test_prove_needs_a_generator_or_masks(proved):
    """No mask is drawn from a fixed seed: the masks make the proof
    zero-knowledge."""
    with pytest.raises(ValueError, match="generator or injected masks"):
        marlin.prove(proved["host"], None)


@pytest.mark.parametrize("case", ["wrong_instance", "tampered_eval", "tampered_witness",
                                  "forged_degree_bound", "malformed"])
def test_verify_rejects(case, proved):
    index, proof, instance = proved["host"], proved["proof"], proved["instance"]
    if case == "wrong_instance":
        assert not marlin.verify(index, [1, 16, 24], proof)
        assert not marlin.verify(index, [1, 15], proof)
        assert not marlin.verify(index, [2, 15, 24], proof)
        return
    if case == "malformed":
        for bad in _malformed(proof, index):
            assert not marlin._well_formed(index, instance, bad)
            assert marlin.verify(index, instance, bad) is False
        assert marlin.verify(index, None, proof) is False
        assert marlin.verify(index, [1, "15", 24], proof) is False
        return
    p = copy.deepcopy(proof)
    if case == "tampered_eval":
        p["evals"]["za"] = (p["evals"]["za"] + 1) % P
    elif case == "tampered_witness":
        p["w_beta"] = index.srs.powers[1]
        p3 = copy.deepcopy(proof)
        p3["w_beta3"] = index.srs.powers[2]
        assert not marlin.verify(index, instance, p3)
    else:
        # the degree-bound commitment replaced by the unshifted one: the
        # batched opening at beta no longer holds
        p["coms"]["g_shift"] = p["coms"]["g"]
        p3 = copy.deepcopy(proof)
        p3["mat_proofs"][0]["com_g3_shift"] = p3["mat_proofs"][0]["com_g3"]
        assert not marlin.verify(index, instance, p3)
    assert not marlin.verify(index, instance, p)


@pytest.mark.slow
def test_spdz_prove_on_the_cpu(fx, proved):
    """The prove on the SPDZ backend: masks from the <r> pool with MACs,
    every commitment opened into the G1 MAC queue; the proof verifies and
    both MAC checks pass."""
    gen = torch.Generator().manual_seed(9)
    alpha = R.uniform_fp(gen, FR, (MF.N_PARTIES,), device=CPU)
    ctx = MpcContext(StackedTransport(MF.N_PARTIES, CPU), "spdz", DummyTripleSource(gen),
                     alpha_share=alpha)
    with mpc_scope(ctx):
        cs = ConstraintSystem(FR)
        _build(cs, generator=gen)
        proof = marlin.prove(proved["host"], cs, gen)
        assert ctx.group_mac_residue_counts == {"G1": 3}
        assert ctx.assert_field_macs(require_nonempty=True)
        assert ctx.assert_group_macs(require_nonempty=True)
        assert marlin.verify(proved["host"], cs.instance_ints(), proof)
        assert not marlin.verify(proved["host"], [1, 16, 24], proof)


@pytest.mark.slow
def test_against_live_reference(proved):
    """Regenerates the fixture with the JAX package (some 13 minutes on a
    CPU) and holds the port's proof against it."""
    live = MF.load(MF.generate())
    assert live["proof"] == proved["proof"]
