"""Online-phase binary: the input protocol on preprocessed r-shares, then a
collaborative proof of MyCircuit.

Port of ``zkmpc_tpu/cli/online.py`` (the reference's `examples/online.rs:
87-301`), stacked transport: one process plays every party.  It reads each
party's ``<outdir>/<i>/online_setup.json`` r-shares written by the `main`
binary, runs the SPDZ input protocol (the owner's input masked with the
opened r and corrected with the r-shares, the opened mask checked against
its bracket MACs), publishes the owners' Pedersen commitments, proves
MyCircuit (a * b = c with c opened in MPC, and both commitments) with
Marlin (the default) or Groth16, verifies, and rejects a wrong instance.

Usage: python -m zkmpc_tpu_torch.cli.online inputs.json [--outdir outputs]
       [--parties 3] [--zksnark marlin|groth16] [--seed 0] [--device cuda]

It runs on the CUDA card unless ``--device cpu`` is given.  Socket mode
(``--id``/``--addrs``, one process a party over the native TCP mesh) is not
ported yet and exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .. import inputs as IN
from ..circuits import my_circuit
from ..crypto import pedersen
from ..mpc.share import SHARED, MpcContext, MpcFp, mpc_scope
from ..ops.limbs import FR, FpArray
from ..parallel.transport import StackedTransport
from ..snark import groth16, marlin
from ..snark.r1cs import ConstraintSystem
from ..utils import serialize as SER

SOCKET_NOT_PORTED = ("online --id/--addrs: socket mode (parallel/native_net.py) is not "
                     "ported yet: ROADMAP.md, Queue 1 step 12.3")

#: randomness bits of each input's Pedersen commitment
COM_BITS = 16

# the generator streams of a run, each seeded from (seed, stream)
_STREAMS = ("r", "synthesis", "prove")


def read_setups(outdir: str, n_parties: int):
    """Every party's ``online_setup.json``: (r rows, betas, bracket rows),
    r_rows[i][slot], betas[i], br_rows[i][key][slot] (None for a file
    without the bracket representation)."""
    r_rows, betas, br_rows = [], [], []
    for i in range(n_parties):
        path = os.path.join(outdir, str(i), "online_setup.json")
        _, r, _ = SER.read_online_setup(path)
        beta, br = SER.read_online_setup_bracket(path)
        r_rows.append(r)
        betas.append(beta)
        br_rows.append(br)
    return r_rows, betas, br_rows


def input_with_r(x_int: int, slot: int, owner: int, r_rows, betas, br_rows,
                 device="cuda") -> MpcFp:
    """The SPDZ input protocol on a preprocessed mask (`online.rs:178-209`):
    r = sum_i r_i[slot] opens to the owner, who checks it against the
    bracket MACs (sum_i gamma_owner(r)_i == beta_owner * r), then
    publishes eps = x - r; party i's share of x is r_i[slot], plus eps for
    the owner.  Setup files must all carry the bracket representation or
    none of them."""
    p = FR.p
    n = len(r_rows)
    r_open = sum(r[slot] for r in r_rows) % p
    with_bracket = [br is not None for br in br_rows]
    if any(with_bracket):
        if not all(with_bracket) or betas[owner] is None:
            raise ValueError("mixed online_setup.json files: some carry the bracket MACs "
                             "and some do not")
        mac_sum = sum(br_rows[i][owner][slot] for i in range(n)) % p
        if mac_sum != betas[owner] * r_open % p:
            raise AssertionError("bracket MAC check failed on the opened input mask")
    eps = (x_int - r_open) % p
    rows = [(r_rows[i][slot] + (eps if i == owner else 0)) % p for i in range(n)]
    return MpcFp(FpArray.from_int(FR, rows, device=device), SHARED)


def run(inputs_path: str, outdir: str = "outputs", n_parties: int = 3,
        party_id: int | None = None, addrs: str | None = None, zksnark: str = "marlin",
        seed: int = 0, device="cuda", report: dict | None = None) -> bool:
    """The online binary's run; True if the proof verifies and a wrong
    instance is rejected.  ``report``: a dict that receives the circuit's
    size, the setup, prove and verify seconds (to a device synchronize) and
    the openings."""
    if party_id is not None or addrs is not None:
        raise SystemExit(SOCKET_NOT_PORTED)
    if zksnark not in ("marlin", "groth16"):
        raise SystemExit(f"unknown zksnark {zksnark!r}")
    dev = torch.device(device)
    rep = report if report is not None else {}
    gens = {name: torch.Generator(dev).manual_seed((seed << 8) | k)
            for k, name in enumerate(_STREAMS)}
    with open(inputs_path) as f:
        doc = json.load(f)
    # party 0 owns x, party 1 owns y (`online.rs:87-125`)
    a_int, b_int = int(doc.get("x", 3)), int(doc.get("y", 5))
    r_rows, betas, br_rows = read_setups(outdir, n_parties)

    def lap(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rep[name] = time.time() - t0
        return time.time()

    transport = StackedTransport(n_parties, dev)
    with mpc_scope(MpcContext(transport, backend="semi")):
        a = input_with_r(a_int, 0, 0, r_rows, betas, br_rows, dev)
        b = input_with_r(b_int, 1, 1, r_rows, betas, br_rows, dev)
        # each owner commits to its input and publishes the commitment
        # (`input.rs:57-105`); the blinding bits come from the common seed
        pp = pedersen.PedersenParams.sample(seed)
        ra, rb = (int(v) for v in torch.randint(0, 1 << COM_BITS, (2,), generator=gens["r"],
                                                device=dev).tolist())
        iwcs = [IN.InputWithCommit(owner, x, MpcFp.const(FR, [(r >> i) & 1
                                                              for i in range(COM_BITS)]),
                                   pedersen.commit_public_ints(pp, x_int, r))
                for owner, (x, x_int, r) in enumerate(((a, a_int, ra), (b, b_int, rb)))]
        # the public output c = a * b is computed in MPC and opened
        t = time.time()
        c_pub = int((a * b).reveal().to_ints().reshape(-1)[0])
        cs = ConstraintSystem(FR)
        my_circuit.build(cs, iwcs[0], iwcs[1], c_pub, pp, gens["synthesis"],
                         com_nbits=COM_BITS)
        t = lap("synthesis_s", t)
        if not cs.is_satisfied_ints():
            raise AssertionError("online circuit unsatisfied")
        rep.update(constraints=len(cs.constraints), variables=cs.num_vars,
                   synthesis_openings=transport.stats.rounds)
        instance = cs.instance_ints()
        bad = list(instance)
        bad[1] = (bad[1] + 1) % FR.p
        rounds = transport.stats.rounds
        if zksnark == "marlin":
            index = marlin.setup_and_index(cs, seed=seed + 1, device=dev)
            t = lap("setup_s", t)
            proof = marlin.prove(index, cs, gens["prove"])
            t = lap("prove_s", t)
            ok = marlin.verify(index, instance, proof)
            neg = not marlin.verify(index, bad, proof)
            rep.update(srs_degree=len(index.srs.powers) - 1, domain_n=index.domain_n,
                       nx=index.nx, k=[m.k_size for m in index.index_comms])
        else:
            dpk = groth16.device_setup(cs, seed=seed + 1, device=dev)
            t = lap("setup_s", t)
            pints = groth16.proof_to_ints(groth16.prove(dpk, cs, gens["prove"]))
            t = lap("prove_s", t)
            ok = groth16.verify(dpk.pk.vk, instance, pints)
            neg = not groth16.verify(dpk.pk.vk, bad, pints)
        lap("verify_s", t)
    rep.update(zksnark=zksnark, c=c_pub, verified=ok, wrong_instance_rejected=neg,
               prove_openings=transport.stats.rounds - rounds, instance=instance)
    print(f"online {zksnark}: prove {rep['prove_s']:.3f}s, verify {rep['verify_s']:.3f}s, "
          f"ok={ok} negative={neg} comm={transport.stats!r}")
    return ok and neg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("inputs")
    ap.add_argument("--outdir", default="outputs")
    ap.add_argument("--parties", type=int, default=3)
    ap.add_argument("--id", type=int, default=None, help="party id (socket mode, not ported)")
    ap.add_argument("--addrs", default=None, help="address file (socket mode, not ported)")
    ap.add_argument("--zksnark", choices=["marlin", "groth16"], default="marlin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a run without a card)")
    args = ap.parse_args(argv)
    ok = run(args.inputs, args.outdir, args.parties, args.id, args.addrs, args.zksnark,
             args.seed, args.device)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
