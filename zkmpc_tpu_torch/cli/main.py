"""Preprocessing + committed-input proof binary.

Port of ``zkmpc_tpu/cli/main.py`` (the reference's `cargo run --bin main
{groth16|marlin} inputs.json`, `src/main.rs:71-237`):

1. SPDZ preprocessing over the SHE layer: key generation, ``initialize``
   (alpha and beta key shares under ZKPoPKs), ``pair`` and ``triple``,
   batched across ``--slots`` SIMD slots.
2. ``MySecretInputCircuit`` from the JSON input x (range [3, 7) and a
   Pedersen commitment to x under 16 random bits), synthesized and proved
   at ``--parties`` parties with Groth16 or Marlin, every Beaver triple,
   inverse pair, group triple and random share served from preprocessing
   (`she.preprocessing.SheTripleSource`).  A Groth16 proof is published as
   ark's 192-byte blob and the parsed blob verified; a Marlin proof (a
   universal KZG setup and the circuit's index, `snark.marlin`) is
   verified as it was opened; either way a wrong instance must be
   rejected.  ``--backend semi`` is the reference's `honest` feature;
   ``--backend spdz`` its `malicious` one: every field and group share
   carries MAC shares under the preprocessed key alpha, and after the
   prove both batched MAC checks must pass, neither of them vacuous (the
   group queue must hold residues of each group the prove opens: G1 and G2
   for Groth16, G1 for Marlin, whose G2 work is the host verifier's).
3. Per-party ``<outdir>/<i>/online_setup.json`` r-shares in the
   reference's 0x-hex JSON format (`src/serialize.rs:101-147`) and
   ``<outdir>/commitment.json``.

Usage: python -m zkmpc_tpu_torch.cli.main {groth16|marlin} inputs.json
       [--parties 3] [--outdir outputs] [--slots 8] [--seed 0]
       [--backend semi|spdz] [--device cuda]

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..circuits import input_circuit
from ..compat import ark as ARK
from ..config import RunConfig, build_mpc_context
from ..crypto import pedersen
from ..mpc.share import MpcFp, _sum_axis0, king_share, mpc_scope
from ..ops.limbs import FR, FpArray
from ..parallel.transport import StackedTransport
from ..she import bgv
from ..she import preprocessing as PP
from ..snark import groth16, marlin
from ..snark.r1cs import ConstraintSystem
from ..utils import serialize as SER

#: slots of a triple batch of the online phase's source: a batch costs about
#: the same ~33,600 kernel launches at any ring degree, and on an H100 the
#: launches, not the slots, set its time (1,024 slots a batch ran 483
#: batches in 318.6 s of synthesis, 16,384 ran 31 in 25.7-31.7 s), so the
#: source runs this many slots' worth of ciphertexts at once on any device
TRIPLE_BATCH_SLOTS = 16384

# the generator streams of a run, each seeded from (seed, stream)
_STREAMS = ("preprocessing", "share", "r", "prove", "triples")


def _generators(seed: int, device) -> dict:
    return {name: torch.Generator(device).manual_seed((seed << 8) | k)
            for k, name in enumerate(_STREAMS)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(zksnark: str, inputs_path: str, n_parties: int = 3,
        outdir: str = "outputs", slots: int = 8, seed: int = 0,
        backend: str = "semi", device="cuda", report: dict | None = None) -> bool:
    """The `main` binary's run; True if the proof verifies and a wrong
    instance is rejected.  ``report``: a dict that receives the phases'
    wall-clock (seconds, to a device synchronize: setup or, for Marlin,
    index, then prove, check and verify), the circuit's size (and Marlin's
    SRS degree, domains and index sizes), the preprocessing batches run and
    slots served during synthesis and prove, the openings and, under SPDZ,
    the MAC residue counts and check time."""
    if zksnark not in ("groth16", "marlin"):
        raise SystemExit(f"unknown zksnark {zksnark!r}")
    cfg = RunConfig(n_parties=n_parties, backend=backend, zksnark=zksnark,
                    slots=slots, seed=seed, outdir=outdir)
    dev = torch.device(device)
    rep = report if report is not None else {}
    gens = _generators(seed, dev)
    with open(inputs_path) as f:
        x_int = int(json.load(f)["x"])

    def lap(name, t0):
        _sync(dev)
        rep[name] = time.time() - t0
        return time.time()

    # ---- offline phase (`main.rs:99-131`)
    t0 = t = time.time()
    params = bgv.SheParams(slots)
    ctx = PP.make_dealer(params, n_parties, gens["preprocessing"], device=dev)
    t = lap("make_dealer_s", t)
    PP.initialize(ctx, gens["preprocessing"])           # raises on a rejected ZKPoPK
    t = lap("initialize_s", t)
    (r_shares, r_macs), r_bracket = PP.pair(ctx, gens["preprocessing"])
    t = lap("pair_s", t)
    (a, _), (b, _), (c, _) = PP.triple(ctx, gens["preprocessing"])
    lap("triple_s", t)
    # the reference's triple test: a*b == c in every slot
    p = FR.p
    av, bv, cv = (_sum_axis0(x).to_ints() for x in (a, b, c))
    if not all(int(x) * int(y) % p == int(z) for x, y, z in zip(av, bv, cv)):
        raise AssertionError("preprocessing triple a*b != c")
    print(f"preprocessing: {time.time() - t0:.3f}s ({slots} slots x {n_parties} parties)")

    # ---- per-party online setup files (`serialize.rs:101-147`): <r> (share
    # and alpha-MAC share) and [r] (MAC shares under every key, own beta)
    _, br_macs = r_bracket                              # [P_keys, P_holders, n]
    beta = ctx.beta.to_ints().reshape(-1)
    for i in range(n_parties):
        SER.write_online_setup(
            os.path.join(outdir, str(i), "online_setup.json"), i,
            SER.fparray_to_hex(r_shares[i]), SER.fparray_to_hex(r_macs[i]),
            r_bracket_hex=[SER.fparray_to_hex(br_macs[j, i]) for j in range(n_parties)],
            beta_hex=SER.field_to_hex(int(beta[i]), FR))

    # ---- online: the committed-input circuit (`main.rs:140-237`)
    pp = pedersen.PedersenParams.sample(seed)
    r_int = int(torch.randint(0, 1 << 16, (), generator=gens["r"], device=dev))
    commitment = pedersen.commit_public_ints(pp, x_int, r_int)
    transport = StackedTransport(n_parties, dev)
    per_batch = max(1, TRIPLE_BATCH_SLOTS // slots)
    mctx = build_mpc_context(cfg, transport, dealer=ctx, generator=gens["triples"],
                             ciphertexts=per_batch)
    src = mctx.triple_source
    with mpc_scope(mctx):
        t = time.time()
        cs = ConstraintSystem(FR)
        x = _scalar(king_share(_fr([x_int], dev), gens["share"]))
        r_bits = king_share(_fr([(r_int >> i) & 1 for i in range(16)], dev), gens["share"])
        input_circuit.build(cs, x, r_bits, commitment, pp, lower=3, upper=7,
                            generator=gens["prove"])
        t = lap("synthesis_s", t)
        rep.update(constraints=len(cs.constraints), variables=cs.num_vars,
                   synthesis_batches=dict(src.batches), synthesis_served=dict(src.served),
                   synthesis_openings=transport.stats.rounds)
        if not cs.is_satisfied_ints():
            raise AssertionError("circuit unsatisfied")
        print(f"constraints: {len(cs.constraints)}")
        t = time.time()
        if zksnark == "groth16":
            dpk = groth16.device_setup(cs, seed=seed + 1, device=dev)
            t = lap("setup_s", t)
        else:
            index = marlin.setup_and_index(cs, seed=seed + 1, device=dev)
            t = lap("index_s", t)
            rep.update(srs_degree=len(index.srs.powers) - 1, domain_n=index.domain_n,
                       nx=index.nx, k=[m.k_size for m in index.index_comms])
        batches, served, rounds = dict(src.batches), dict(src.served), transport.stats.rounds
        if zksnark == "groth16":
            pints = groth16.proof_to_ints(groth16.prove(dpk, cs, gens["prove"]))
        else:
            proof = marlin.prove(index, cs, gens["prove"])
        lap("prove_s", t)
        rep.update(prove_batches={k: v - batches[k] for k, v in src.batches.items()},
                   prove_served={k: v - served[k] for k, v in src.served.items()},
                   prove_openings=transport.stats.rounds - rounds)
        instance = cs.instance_ints()
        if backend == "spdz":
            # the batched MAC checks over every value opened in the run,
            # required non-vacuous: the field queue and the queue of each
            # group the prove opens must hold residues
            need = ("G1", "G2") if zksnark == "groth16" else ("G1",)
            counts = mctx.group_mac_residue_counts
            rep.update(field_mac_residues=mctx.mac_residue_count,
                       group_mac_residues=mctx.group_mac_residue_count,
                       group_mac_residues_by_group=counts, group_mac_groups_required=need)
            t = time.time()
            mctx.assert_field_macs(require_nonempty=True)
            if any(counts.get(g, 0) == 0 for g in need):
                raise AssertionError(f"SPDZ group MAC queue empty for a group of {need} "
                                     f"({counts})")
            mctx.assert_group_macs(require_nonempty=True)
            lap("mac_check_s", t)
            print(f"spdz MAC checks passed ({rep['field_mac_residues']} field and "
                  f"{rep['group_mac_residues']} group openings checked, {counts})")
    bad = list(instance)
    bad[1] = (bad[1] + 1) % p
    t = time.time()
    if zksnark == "groth16":
        # publish the proof in ark's `Proof::serialize` format and verify
        # the PARSED blob: the round trip is the interop contract with the
        # reference's serialized proofs
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "proof.bin"), "wb") as f:
            f.write(ARK.groth16_proof_from_ints(pints))
        with open(os.path.join(outdir, "proof.bin"), "rb") as f:
            parsed = ARK.groth16_proof_from_bytes(f.read())
        ok = groth16.verify(dpk.pk.vk, instance, parsed)
        neg = not groth16.verify(dpk.pk.vk, bad, parsed)
    else:
        ok = marlin.verify(index, instance, proof)
        neg = not marlin.verify(index, bad, proof)
    lap("verify_s", t)
    rep.update(verified=ok, wrong_instance_rejected=neg, instance=instance,
               triple_batch_slots=per_batch * slots,
               openings=transport.stats.rounds, batches=dict(src.batches))
    print(f"prove+verify: {rep['prove_s']:.3f}s ok={ok} negative={neg}")
    # the commitment, published like the reference's commitment.json
    with open(os.path.join(outdir, "commitment.json"), "w") as f:
        json.dump({"x": SER.field_to_hex(commitment[0], FR),
                   "y": SER.field_to_hex(commitment[1], FR)}, f, indent=1)
    return ok and neg


def _fr(vals, device):
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=device)


def _scalar(x: MpcFp) -> MpcFp:
    """[1]-shaped wire -> scalar shape ()."""
    return x.map(lambda v: FpArray(v.limbs[..., 0, :], v.spec, v.bound))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("zksnark", choices=["groth16", "marlin"])
    ap.add_argument("inputs", help="JSON file with {'x': int}")
    ap.add_argument("--parties", type=int, default=3)
    ap.add_argument("--outdir", default="outputs")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=["semi", "spdz"], default="semi",
                    help="security model: semi-honest (the reference's 'honest' "
                         "feature) or SPDZ with MAC checks ('malicious')")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a run without a card)")
    args = ap.parse_args(argv)
    ok = run(args.zksnark, args.inputs, args.parties, args.outdir, args.slots,
             args.seed, args.backend, args.device)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
