"""Online-phase binary: the input protocol on preprocessed r-shares, then a
collaborative proof of MyCircuit.

Port of ``zkmpc_tpu/cli/online.py`` (the reference's `examples/online.rs:
87-301`).  It reads the ``<outdir>/<i>/online_setup.json`` r-shares written
by the `main` binary, runs the SPDZ input protocol (the owner's input masked
with the opened r and corrected with the r-shares, the opened mask checked
against its bracket MACs), publishes the owners' Pedersen commitments,
proves MyCircuit (a * b = c with c opened in MPC, and both commitments)
with Marlin (the default) or Groth16, verifies, and rejects a wrong
instance.

Without ``--id`` one process plays every party on the stacked transport
and reads every party's file.  With ``--id i --addrs F`` the process is
party i alone, one of the mesh's processes over TCP (the reference's
``run_online.zsh`` topology; the party count is the address file's): it
reads only ``<outdir>/<i>/online_setup.json``, consults the inputs file
only for its own input, and its shares cross the mesh.  Three such
processes give the stacked run's proof.

Every private draw of a party (its shares of random values, its random
bits in the bit protocols, the masks it deals, its shares of Groth16's r
and s and of Marlin's masks) comes from that party's own ChaCha20
keystream (`mpc.rand.PartyGenerators`), keyed by its 256-bit private
seed: by default 32 bytes of the process's own entropy, or
``--private-seed`` (stacked: one a party, comma-separated; socket: the
process's own), each an int below 2^256 in decimal or as ``0x`` and up
to 64 hex digits, the same seed as that int given to `run`.  A socket
process holds only its own seed, so it cannot recompute another party's
shares.  Under the same private seeds party i's socket tensors are row
i of the stacked run's, and so the proofs are equal.  The public
``--seed`` makes what is common: the Pedersen parameters, the SRS or
trapdoor (``seed + 1``) and the commitments' randomness ``ra`` and
``rb``, which the circuit takes as public constants, as in the JAX
package (ROADMAP Queue 3).

Usage: python -m zkmpc_tpu_torch.cli.online inputs.json [--outdir outputs]
       [--parties 3] [--id I --addrs FILE] [--zksnark marlin|groth16]
       [--seed 0] [--private-seed S[,S...]] [--device cuda] [--report FILE]

    python -m zkmpc_tpu_torch.cli.online inputs.json --id 0 --addrs data/3 &
    python -m zkmpc_tpu_torch.cli.online inputs.json --id 1 --addrs data/3 &
    python -m zkmpc_tpu_torch.cli.online inputs.json --id 2 --addrs data/3

It runs on the CUDA card unless ``--device cpu`` is given; the MPC backend
is semi-honest.
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
from ..mpc import rand as R
from ..mpc.share import SHARED, MpcContext, MpcFp, mpc_scope
from ..ops import build as K
from ..ops.limbs import FR, FpArray
from ..parallel.native_net import NativeMeshNet, SocketTransport, read_addrs
from ..parallel.transport import StackedTransport
from ..snark import groth16, marlin
from ..snark.r1cs import ConstraintSystem
from ..utils import serialize as SER

#: randomness bits of each input's Pedersen commitment
COM_BITS = 16

#: the public generator stream of a run, seeded from (seed, 0): the
#: commitments' randomness
_PUBLIC_STREAM = 0
#: the ChaCha20 stream ids of a run's private draws (each party's keystream
#: under its own seed)
_SYNTHESIS_STREAM, _PROVE_STREAM = 1, 2

#: wire size of a field element (384-bit little-endian, CanonicalSerialize-style)
NB = 48
#: the mesh channel of the input protocol and the commitments
INPUT_CHAN = 2


def read_setup(outdir: str, party: int):
    """One party's ``online_setup.json``: (r, beta, bracket), r[slot] and
    bracket[key][slot] (beta and bracket None for a file without the
    bracket representation)."""
    path = os.path.join(outdir, str(party), "online_setup.json")
    _, r, _ = SER.read_online_setup(path)
    beta, br = SER.read_online_setup_bracket(path)
    return r, beta, br


def read_setups(outdir: str, n_parties: int):
    """Every party's ``online_setup.json``: (r rows, betas, bracket rows),
    r_rows[i][slot], betas[i], br_rows[i][key][slot]."""
    r_rows, betas, br_rows = zip(*(read_setup(outdir, i) for i in range(n_parties)))
    return list(r_rows), list(betas), list(br_rows)


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


def input_with_r_socket(net: NativeMeshNet, x_int: int | None, slot: int, owner: int, r,
                        beta, br, device="cuda") -> MpcFp:
    """`input_with_r` over the mesh, as one party (``zkmpc_tpu/cli/
    online.py:111-139``): a non-owner sends the owner its r share and its
    bracket-MAC share under the owner's key (48-byte little-endian field
    elements on channel 2); the owner opens r, checks sum gamma ==
    beta_owner * r and sends eps = x - r back.  Only the owner passes
    ``x_int``.  Returns the party's share [1]."""
    p = FR.p
    me, n = net.party_id, net.n_parties
    with_bracket = br is not None
    if with_bracket and beta is None:
        raise ValueError("online_setup.json carries bracket MACs but no beta")
    if (x_int is None) == (me == owner):
        raise ValueError(f"input_with_r_socket: the owner (party {owner}) and only the owner "
                         f"passes its input (this is party {me})")
    if me == owner:
        r_open = r[slot]
        mac_sum = br[owner][slot] if with_bracket else 0
        for i in range(n):
            if i == me:
                continue
            blob = net.recv_bytes(i, max_len=2 * NB, chan=INPUT_CHAN)
            if len(blob) not in (NB, 2 * NB):
                raise ConnectionError(f"party {i} sent a {len(blob)}-byte input frame")
            if (len(blob) == 2 * NB) != with_bracket:
                raise ValueError("mixed online_setup.json files: some carry the bracket MACs "
                                 "and some do not")
            r_open += int.from_bytes(blob[:NB], "little")
            mac_sum += int.from_bytes(blob[NB:], "little")
        r_open %= p
        if with_bracket and mac_sum % p != beta * r_open % p:
            raise AssertionError("bracket MAC check failed on the opened input mask")
        eps = (x_int - r_open) % p
        for i in range(n):
            if i != me:
                net.send_bytes(i, eps.to_bytes(NB, "little"), chan=INPUT_CHAN)
    else:
        blob = (r[slot] % p).to_bytes(NB, "little")
        if with_bracket:
            blob += (br[owner][slot] % p).to_bytes(NB, "little")
        net.send_bytes(owner, blob, chan=INPUT_CHAN)
        reply = net.recv_bytes(owner, max_len=NB, chan=INPUT_CHAN)
        if len(reply) != NB:
            raise ConnectionError(f"party {owner} sent a {len(reply)}-byte eps frame")
        eps = int.from_bytes(reply, "little")
    mine = (r[slot] + (eps if me == owner else 0)) % p
    return MpcFp(FpArray.from_int(FR, [mine], device=device), SHARED)


def published_commitment(net: NativeMeshNet, pp, x_int: int | None, r_int: int, owner: int):
    """The owner's Pedersen commitment to its input, broadcast on channel 2
    as two 48-byte coordinates (zeros from the other parties: broadcast
    frames are of one length)."""
    blob = bytes(2 * NB)
    if net.party_id == owner:
        cx, cy = pedersen.commit_public_ints(pp, x_int, r_int)
        blob = int(cx).to_bytes(NB, "little") + int(cy).to_bytes(NB, "little")
    got = net.broadcast_bytes(blob, chan=INPUT_CHAN)[owner]
    return int.from_bytes(got[:NB], "little"), int.from_bytes(got[NB:], "little")


def _canonical(x):
    """A proof (dicts, tuples and lists of ints and strings) as JSON-ready
    lists."""
    if isinstance(x, dict):
        return {k: _canonical(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_canonical(v) for v in x]
    return x


def run(inputs_path: str, outdir: str = "outputs", n_parties: int | None = None,
        party_id: int | None = None, addrs: str | None = None, zksnark: str = "marlin",
        seed: int = 0, device="cuda", report: dict | None = None,
        private_seeds=None) -> bool:
    """The online binary's run; True if the proof verifies and a wrong
    instance is rejected.  ``party_id`` and ``addrs`` (an address file)
    run one party over the mesh; without them one process plays
    ``n_parties`` (default 3) on the stacked transport.  ``report``: a dict
    that receives the circuit's size, the input, synthesis, setup, prove
    and verify seconds (to a device synchronize), the openings, the proof
    as canonical ints and, on the mesh, its byte and broadcast counters.
    ``private_seeds``: the private seeds of the parties this process plays
    (stacked: one a party; socket: its own, a seed or a one-item list),
    each 32 bytes or an int below 2^256; by default each party's comes from
    the process's own entropy."""
    if zksnark not in ("marlin", "groth16"):
        raise SystemExit(f"unknown zksnark {zksnark!r}")
    if party_id is not None and addrs is None:
        raise ValueError("--id needs --addrs: socket mode reads the parties' addresses from a "
                         "file")
    if addrs is not None and party_id is None:
        raise ValueError("--addrs needs --id: socket mode runs one party a process")
    if party_id is not None:
        addr_list = read_addrs(addrs)
        if n_parties is not None and n_parties != len(addr_list):
            raise ValueError(f"--parties {n_parties} does not match the {len(addr_list)} "
                             f"addresses of --addrs {addrs}")
        if not 0 <= party_id < len(addr_list):
            raise ValueError(f"--id {party_id} is not a party of --addrs {addrs} "
                             f"({len(addr_list)} parties)")
    dev = torch.device(device)
    rep = report if report is not None else {}
    public_gen = torch.Generator(dev).manual_seed((seed << 8) | _PUBLIC_STREAM)
    if isinstance(private_seeds, (int, bytes)):
        private_seeds = [private_seeds]
    with open(inputs_path) as f:
        doc = json.load(f)
    # party 0 owns x, party 1 owns y (`online.rs:87-125`); a party of the
    # mesh consults the inputs file only for its own input
    a_int, b_int = int(doc.get("x", 3)), int(doc.get("y", 5))
    net = None
    if party_id is None:
        n_parties = 3 if n_parties is None else n_parties
        setups = read_setups(outdir, n_parties)
        transport = StackedTransport(n_parties, dev)
    else:
        n_parties = len(addr_list)
        a_int = a_int if party_id == 0 else None
        b_int = b_int if party_id == 1 else None
        own = read_setup(outdir, party_id)
    # each party's private streams, keyed by its own seed (checked before
    # the mesh comes up)
    priv = R.PartyGenerators(range(n_parties) if party_id is None else [party_id],
                             private_seeds, dev)
    gens = dict(synthesis=priv.stream(_SYNTHESIS_STREAM), prove=priv.stream(_PROVE_STREAM))
    rep["private_seeds"] = "own entropy" if private_seeds is None else "given"
    if party_id is not None:
        net = NativeMeshNet(party_id, addr_list)

    def lap(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rep[name] = time.time() - t0
        return time.time()

    try:
        if net is not None:
            net.connect()
            transport = SocketTransport(net, dev)
        with mpc_scope(MpcContext(transport, backend="semi")):
            t = time.time()
            if net is None:
                a = input_with_r(a_int, 0, 0, *setups, dev)
                b = input_with_r(b_int, 1, 1, *setups, dev)
            else:
                a = input_with_r_socket(net, a_int, 0, 0, *own, dev)
                b = input_with_r_socket(net, b_int, 1, 1, *own, dev)
            # each owner commits to its input and publishes the commitment
            # (`input.rs:57-105`); the blinding bits come from the common seed
            pp = pedersen.PedersenParams.sample(seed)
            ra, rb = (int(v) for v in torch.randint(0, 1 << COM_BITS, (2,),
                                                    generator=public_gen, device=dev).tolist())
            iwcs = []
            for owner, (x, x_int, r) in enumerate(((a, a_int, ra), (b, b_int, rb))):
                com = (pedersen.commit_public_ints(pp, x_int, r) if net is None
                       else published_commitment(net, pp, x_int, r, owner))
                iwcs.append(IN.InputWithCommit(
                    owner, x, MpcFp.const(FR, [(r >> i) & 1 for i in range(COM_BITS)]), com))
            t = lap("input_s", t)
            rep["input_openings"] = transport.stats.rounds
            # the public output c = a * b is computed in MPC and opened
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
                proof = groth16.proof_to_ints(groth16.prove(dpk, cs, gens["prove"]))
                t = lap("prove_s", t)
                ok = groth16.verify(dpk.pk.vk, instance, proof)
                neg = not groth16.verify(dpk.pk.vk, bad, proof)
            lap("verify_s", t)
        rep.update(zksnark=zksnark, c=c_pub, verified=ok, wrong_instance_rejected=neg,
                   prove_openings=transport.stats.rounds - rounds, instance=instance,
                   openings=transport.stats.rounds, proof=_canonical(proof),
                   transport=transport.kind)
        who = transport.kind
        if net is not None:
            rep.update(party_id=party_id, n_parties=n_parties, net=net.stats)
            who += f", party {party_id} of {n_parties}, net {rep['net']}"
    finally:
        if net is not None:
            net.close()
    print(f"online {zksnark} ({who}): input {rep['input_s']:.3f}s, synthesis "
          f"{rep['synthesis_s']:.3f}s, setup {rep['setup_s']:.3f}s, prove {rep['prove_s']:.3f}s, "
          f"verify {rep['verify_s']:.3f}s, ok={ok} negative={neg} comm={transport.stats!r}")
    return ok and neg


def parse_private_seed(text: str) -> int:
    """One ``--private-seed`` item: an int below 2^256, in decimal digits
    or as ``0x`` and hex digits; `mpc.rand.seed_bytes` makes it the 32
    little-endian key bytes, as for an int given to `run`."""
    text = text.strip()
    try:
        return int(text, 16) if text[:2].lower() == "0x" else int(text, 10)
    except ValueError:
        raise ValueError(f"--private-seed {text!r}: a decimal int, or 0x and hex digits, "
                         f"below 2^256") from None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("inputs")
    ap.add_argument("--outdir", default="outputs")
    ap.add_argument("--parties", type=int, default=None,
                    help="party count (default 3; in socket mode the address file's)")
    ap.add_argument("--id", type=int, default=None, help="this process's party id (socket mode)")
    ap.add_argument("--addrs", default=None,
                    help="address file, one host:port a party (socket mode)")
    ap.add_argument("--zksnark", choices=["marlin", "groth16"], default="marlin")
    ap.add_argument("--seed", type=int, default=0,
                    help="the public seed: Pedersen parameters, SRS or trapdoor, the "
                         "commitments' randomness")
    ap.add_argument("--private-seed", default=None,
                    help="the private seeds of the parties played, comma-separated (stacked: "
                         "one a party; socket: this party's own), each an int below 2^256 in "
                         "decimal or as 0x and hex digits; default: 32 bytes of own "
                         "entropy")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a run without a card)")
    ap.add_argument("--report", default=None,
                    help="write the run's report as JSON here, with the kernel launches, the "
                         "peak device memory and the top-level modules loaded")
    args = ap.parse_args(argv)
    report = {}
    ok = run(args.inputs, args.outdir, args.parties, args.id, args.addrs, args.zksnark,
             args.seed, args.device, report=report,
             private_seeds=None if args.private_seed is None
             else [parse_private_seed(v) for v in args.private_seed.split(",")])
    if args.report:
        report.update(launches=dict(K.LAUNCHES),
                      modules=sorted({m.split(".")[0] for m in sys.modules}))
        if torch.device(args.device).type == "cuda":
            report["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        with open(args.report, "w") as f:
            json.dump(report, f)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
