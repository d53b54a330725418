"""The port's `main` binary and its pieces against the JAX package: the run
configuration, the hex-JSON files, the ark proof blob, the committed-input
circuit and `cli.main`, and the slice end to end at a size a CPU can
afford: SHE preprocessing at 8 slots on the JAX dealer carried across feeds
`SheTripleSource`, which serves the Beaver triples, group triples and
inverse pairs of the port's 3-party Groth16 prove of the 4-gate wide-mul
circuit.  With the reference's proving key and r/s shares
(`fixtures/make_torch_slice_fixture.py`) that prove must give the
reference's proof exactly: triples change no opened value.

The committed-input circuit takes a 253-bit decomposition and two
comparisons through the MPC, minutes on a CPU (and its prove on SHE
triples about an hour and a half on eight CPU threads), so its comparison
with the JAX package's (`fixtures/make_torch_she_fixture.py`) and a CPU
run of `cli.main` are `slow`; `chip_smoke.py` phase 6 runs the whole
binary on the card.
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_torch_she_fixture as SF
from fixtures import make_torch_slice_fixture as MK
from torch_parity import CPU, check_circuit
from zkmpc_tpu.compat import ark as JA
from zkmpc_tpu.utils import serialize as JSER
from zkmpc_tpu_torch import config as CFG
from zkmpc_tpu_torch.cli import main as CLI
from zkmpc_tpu_torch.compat import ark as TA
from zkmpc_tpu_torch.mpc.share import (SHARED, DummyTripleSource, MpcFp, beaver_inv,
                                       king_share, mpc_scope)
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.she import preprocessing as PP
from zkmpc_tpu_torch.snark import driver, groth16
from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem
from zkmpc_tpu_torch.spec import curves as SC
from zkmpc_tpu_torch.utils import serialize as SER

torch.set_num_threads(1)

P = FR.p
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, "inputs", "inputs-template.json")


def _dealer():
    return PP.dealer_from_host(SF.dealer_doc(SF.load(np.load(SF.PATH))), CPU)


def test_run_config_and_context():
    cfg = CFG.RunConfig(n_parties=4, zksnark="marlin", slots=16, seed=7, srs_size=4096,
                        zkpopk=CFG.ZkPoPKParams(sec=16))
    assert CFG.RunConfig.from_json(cfg.to_json()) == cfg
    with pytest.raises(AssertionError):
        CFG.RunConfig(backend="bogus")
    t = StackedTransport(3, CPU)
    assert isinstance(CFG.build_mpc_context(CFG.RunConfig(), t).triple_source,
                      DummyTripleSource)
    src = CFG.build_mpc_context(CFG.RunConfig(), t, dealer=_dealer()).triple_source
    assert isinstance(src, PP.SheTripleSource) and src.generator.device == t.device
    # the SPDZ backend: the dealer's alpha shares and a MAC-serving source
    dealer = _dealer()
    ctx = CFG.build_mpc_context(CFG.RunConfig(backend="spdz"), t, dealer=dealer)
    assert ctx.backend == "spdz" and isinstance(ctx.triple_source, PP.SheTripleSource)
    assert ctx.alpha_share.to_ints().tolist() == dealer.alpha_shares.to_ints().tolist()
    alpha = sum(dealer.alpha_shares.to_ints().tolist()) % P
    with mpc_scope(ctx):
        for w in ctx.triple_source.field_triples(FR, (3,)) + \
                (ctx.triple_source.rand_shares(FR, (2,)),):
            vals, macs = (np.sum(x.to_ints(), axis=0) for x in (w.value, w.mac))
            assert [int(m) % P for m in macs] == [alpha * int(v) % P for v in vals]
        a, b, c = (np.sum(w.value.to_ints(), axis=0) for w in
                   ctx.triple_source.field_triples(FR, (2,)))
        assert all(int(x) * int(y) % P == int(z) % P for x, y, z in zip(a, b, c))
    # under the semi-honest backend the same source serves values alone
    with mpc_scope(CFG.build_mpc_context(CFG.RunConfig(), t, dealer=dealer)) as semi:
        assert semi.triple_source.field_triples(FR, (2,))[0].mac is None
    with pytest.raises(AssertionError, match="initialize"):
        CFG.build_mpc_context(CFG.RunConfig(backend="spdz"), t)
    # both proof systems are ported: only an unknown one exits at once
    with pytest.raises(SystemExit, match="unknown zksnark"):
        CLI.run("plonk", INPUTS, device=CPU)


def test_online_setup_files_are_read_by_the_reference(tmp_path):
    shares = FpArray.from_int(FR, np.asarray([[5, 0, P - 1]], dtype=object), device=CPU)[0]
    hexes = SER.fparray_to_hex(shares)
    assert hexes[0] == "0x05" + "00" * 31 and hexes == [JSER.field_to_hex(v, _jfr())
                                                       for v in (5, 0, P - 1)]
    assert [SER.hex_to_field(h) for h in hexes] == [5, 0, P - 1]
    path = str(tmp_path / "1" / "online_setup.json")
    SER.write_online_setup(path, 1, hexes, hexes[::-1], r_bracket_hex=[hexes, hexes[:1]],
                           beta_hex=SER.field_to_hex(9, FR))
    assert JSER.read_online_setup(path) == SER.read_online_setup(path) == \
        (1, [5, 0, P - 1], [P - 1, 0, 5])
    assert JSER.read_online_setup_bracket(path) == SER.read_online_setup_bracket(path) == \
        (9, [[5, 0, P - 1], [5]])
    SER.write_online_setup(path, 1, hexes)
    assert SER.read_online_setup_bracket(path) == (None, None)


def _jfr():
    from zkmpc_tpu.ops.limbs import FR as JFR
    return JFR


def _off_subgroup_points():
    """A G1 and a G2 point on the curve but outside the prime-order
    subgroup (the cofactors are large: the first x with a square right-hand
    side gives one)."""
    p = TA.FQ_P
    x = 1
    while TA._sqrt_mod((x ** 3 + 1) % p, p) is None:
        x += 1
    g1 = (x, TA._sqrt_mod((x ** 3 + 1) % p, p))
    b2 = (TA.params.G2_B_C0, TA.params.G2_B_C1)
    x2 = (1, 1)
    while True:
        rhs = SC.fq2_add(SC.fq2_mul(SC.fq2_mul(x2, x2), x2), b2)
        y2 = TA._fq2_sqrt(*rhs)
        if y2 is not None:
            break
        x2 = (x2[0] + 1, 1)
    return g1, (x2, y2)


def test_proof_blob_round_trip_and_subgroup_check():
    g1 = SC.g1_mul(SC.G1_GEN, 123456789)
    g2 = SC.g2_mul(SC.G2_GEN, 987654321)
    proof = (g1, g2, SC.g1_neg(g1))
    blob = TA.groth16_proof_from_ints(proof)
    assert blob == JA.groth16_proof_from_ints(proof) and len(blob) == 192
    assert TA.groth16_proof_from_bytes(blob) == JA.groth16_proof_from_bytes(blob) == proof
    assert TA.g1_decompress(TA.g1_compressed(None)) is None
    assert TA.g2_decompress(TA.g2_compressed(None)) is None
    bad1, bad2 = _off_subgroup_points()
    assert SC.sw_add(bad1, bad1, SC._FqOps) is not None
    # the reference decompresses them (its fault, ROADMAP Queue 3); the port refuses
    assert JA.g1_decompress(TA.g1_compressed(bad1)) in (bad1, SC.g1_neg(bad1))
    with pytest.raises(ValueError, match="subgroup"):
        TA.g1_decompress(TA.g1_compressed(bad1))
    with pytest.raises(ValueError, match="subgroup"):
        TA.g2_decompress(TA.g2_compressed(bad2))
    with pytest.raises(ValueError, match="subgroup"):
        TA.groth16_proof_from_bytes(TA.g1_compressed(bad1) + blob[48:])
    with pytest.raises(ValueError, match="192"):
        TA.groth16_proof_from_bytes(blob[:-1])


def test_she_triples_feed_the_wide_mul_prove(tmp_path):
    """Preprocessing at 8 slots serves the 4-gate prove's Beaver triples,
    group triples and an inverse pair: the proof is the reference's, it
    verifies, and its ark blob parses, verifies and is read by the JAX
    package."""
    fx = MK.load(np.load(MK.PATH))
    dpk = driver.dpk_from_host(fx["doc"], CPU)
    mats = groth16.device_matrices_from_pk(dpk.pk, CPU)
    _, (a_l, b_l, _) = driver.make_prove_fn(dpk, MK.N_PARTIES)

    def share(name):
        limbs, bound = fx[name]
        return FpArray(torch.as_tensor(limbs.astype(np.int64)), FR, bound)
    t = StackedTransport(MK.N_PARTIES, CPU)
    ctx = CFG.build_mpc_context(CFG.RunConfig(slots=SF.N_SLOTS), t, dealer=_dealer(),
                                generator=torch.Generator().manual_seed(4))
    src = ctx.triple_source
    with mpc_scope(ctx):
        cs = ConstraintSystem(FR)
        driver.build_wide_mul_circuit(cs, MpcFp(FpArray(a_l, FR, 2), SHARED),
                                      MpcFp(FpArray(b_l, FR, 2), SHARED))
        before = dict(src.batches)
        proof = groth16.proof_to_ints(groth16.prove(dpk, cs, None, matrices=mats,
                                                    r=share("r"), s=share("s")))
        used = {k: v - before[k] for k, v in src.batches.items()}
        # an inverse pair: the shared inverse of a dealt value
        x = king_share(FpArray.from_int(FR, np.asarray([3, 7], dtype=object), device=CPU),
                       torch.Generator().manual_seed(5))
        inv = beaver_inv(x).reveal().to_ints()[0].tolist()
    assert proof == fx["proof"]
    assert used["triple"] >= 1 and src.batches["inv_pair"] == 1
    assert inv == [pow(3, -1, P), pow(7, -1, P)]
    inst = driver.expected_instance(MK.N_GATES)
    blob = TA.groth16_proof_from_ints(proof)
    (tmp_path / "proof.bin").write_bytes(blob)
    parsed = TA.groth16_proof_from_bytes((tmp_path / "proof.bin").read_bytes())
    assert parsed == proof == JA.groth16_proof_from_bytes(blob)
    assert groth16.verify(dpk.pk.vk, inst, parsed)
    assert not groth16.verify(dpk.pk.vk, [1, (inst[1] + 1) % P], parsed)


@pytest.mark.parametrize("ciphertexts", [1, 2])
def test_triple_source_serves_each_slot_once(ciphertexts):
    """Requests take the unused slots of earlier batches first; every slot
    served is a valid triple and none is served twice; a triple batch and
    a batch of <r> shares cover ``ciphertexts`` ciphertexts of 8 slots."""
    src = PP.SheTripleSource(_dealer(), torch.Generator().manual_seed(8), ciphertexts)
    got = [src.field_triples(FR, shape) for shape in ((3,), (2, 2), (), (4,))]
    # 3 + 4 + 1 + 4 = 12 slots: of 16 in two batches, or of 16 in one
    assert src.batches["triple"] == 3 - ciphertexts
    assert src.served["triple"] == 12
    seen = set()
    for a, b, c in got:
        av, bv, cv = (np.atleast_1d(np.sum(w.value.to_ints(), axis=0)).reshape(-1)
                      for w in (a, b, c))
        assert a.shape == b.shape == c.shape
        assert all(int(x) * int(y) % P == int(z) % P for x, y, z in zip(av, bv, cv))
        for x in av:
            assert int(x) % P not in seen
            seen.add(int(x) % P)
    assert len(seen) == 12
    # random shares from the <r> batches, of as many ciphertexts
    r = src.rand_shares(FR, (3,))
    assert r.shape == (3,) and src.batches["pair"] == 1 and src.served["pair"] == 3
    src.rand_shares(FR, (8 * ciphertexts - 3,))
    assert src.batches["pair"] == 1


def _port_input_cs(fx):
    fj = fx["json"]["input"]
    from zkmpc_tpu_torch.circuits import input_circuit
    from zkmpc_tpu_torch.crypto import pedersen
    pp = pedersen.PedersenParams.sample(SF.PEDERSEN_SEED)
    com = pedersen.commit_public_ints(pp, SF.X_INT, SF.R_INT)
    assert [int(v) for v in com] == fj["commitment"]
    gen = torch.Generator().manual_seed(1)
    with mpc_scope(CFG.build_mpc_context(CFG.RunConfig(), StackedTransport(SF.N_PARTIES, CPU))):
        cs = ConstraintSystem(FR)
        x = king_share(FpArray.from_int(FR, np.asarray([SF.X_INT], dtype=object), device=CPU),
                       gen)
        x = MpcFp(FpArray(x.value.limbs[..., 0, :], FR, x.value.bound), SHARED)
        rb = king_share(FpArray.from_int(FR, np.asarray(
            [(SF.R_INT >> i) & 1 for i in range(SF.N_R_BITS)], dtype=object), device=CPU), gen)
        input_circuit.build(cs, x, rb, com, pp, SF.LOWER, SF.UPPER, gen, n_r_bits=SF.N_R_BITS)
    return cs


@pytest.mark.slow
def test_input_circuit_matches_reference():
    """The committed-input circuit's matrices, instance and opened
    assignment equal the JAX package's (minutes on a CPU)."""
    fx = SF.load(np.load(SF.PATH))
    check_circuit(_port_input_cs(fx), fx["json"]["input"])


@pytest.mark.slow
def test_main_runs_on_the_cpu(tmp_path):
    """`cli.main.run` at 8 slots on the CPU: preprocessing, the committed
    input's proof verifies from its parsed blob, a wrong instance is
    rejected, and the files are written and read back (by the JAX package
    too).  The circuit's synthesis takes some 494,000 SHE triples
    (`chip_smoke.py` phase 6 counts them on the card), and a CPU core makes
    about 26 a second at 8 slots, so this run takes every core: about an
    hour and a half on eight."""
    report = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    try:
        assert CLI.run("groth16", INPUTS, n_parties=3, outdir=str(tmp_path), slots=8,
                       device="cpu", report=report)
    finally:
        torch.set_num_threads(threads)
    assert report["verified"] and report["wrong_instance_rejected"]
    assert report["prove_openings"] > 0 and report["batches"]["triple"] >= 1
    for i in range(3):
        path = str(tmp_path / str(i) / "online_setup.json")
        assert JSER.read_online_setup(path) == SER.read_online_setup(path)
        assert len(SER.read_online_setup(path)[1]) == 8
    blob = (tmp_path / "proof.bin").read_bytes()
    assert JA.groth16_proof_from_bytes(blob) == TA.groth16_proof_from_bytes(blob)
    with open(tmp_path / "commitment.json") as f:
        assert set(json.load(f)) == {"x", "y"}
