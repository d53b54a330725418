#!/usr/bin/env python3
"""Where a socket party's circuit synthesis spends its time.

Writes ``online_setup.json`` files for three parties (random r-shares
with consistent bracket MACs, as the `main` binary writes them), then
runs the online binary's Marlin prove of MyCircuit on one CUDA card three
ways, at seed 0:

- ``stacked``: `cli.online.run` on the stacked transport, as it runs;
- ``stacked_synced``: the same with a device synchronize after every
  opening, which a socket party cannot avoid (its share goes to the host
  before it crosses the mesh), so the host no longer runs ahead of the
  card;
- ``socket``: one OS process a party over a localhost mesh
  (`cli.online.run` with ``party_id``), each running the binary twice,
  ``cold`` (the process's first run, as ``python -m`` runs it) and then
  ``warm``, on a fresh mesh each time.  Each run times, inside the
  synthesis (`my_circuit.build`, ``build_s``), the three steps of every
  collective: ``drain_s``, the copy of the share to the host, which first
  waits for the party's device queue to empty; ``mesh_s``, the broadcast
  over the mesh, the wire plus the wait for the slowest peer; ``back_s``,
  the copy of the result to the card.  ``rest_s`` is what remains of the
  build, the host's own work between openings, and ``before_build_s``
  what the synthesis spends before it (c's Beaver multiply and opening).

Prints the card's name and power limit, then one JSON object: the
synthesis seconds and openings of each run and, for each socket party
and run, its split.

    python3 tools/socket_latency.py      # needs one CUDA card
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_PARTIES = 3
SLOTS = 4
SEED = 0
TIMEOUT_S = 300


def write_setups(outdir):
    """Per-party online_setup.json files: r-shares, alpha-MAC shares and
    each party's MAC shares under every key beta_j, with
    sum_i gamma_j(r)_i = beta_j * r."""
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.utils import serialize as SER
    p = FR.p
    rng = random.Random(5)
    r = [[rng.randrange(p) for _ in range(SLOTS)] for _ in range(N_PARTIES)]
    opened = [sum(row[s] for row in r) % p for s in range(SLOTS)]
    betas = [rng.randrange(1, p) for _ in range(N_PARTIES)]
    gamma = [[[rng.randrange(p) for _ in range(SLOTS)] for _ in range(N_PARTIES)]
             for _ in range(N_PARTIES)]                     # [key j][holder i][slot]
    for j in range(N_PARTIES):
        for s in range(SLOTS):
            rest = sum(gamma[j][i][s] for i in range(1, N_PARTIES))
            gamma[j][0][s] = (betas[j] * opened[s] - rest) % p

    def hx(vals):
        return [SER.field_to_hex(v, FR) for v in vals]
    for i in range(N_PARTIES):
        SER.write_online_setup(
            os.path.join(outdir, str(i), "online_setup.json"), i, hx(r[i]),
            hx([rng.randrange(p) for _ in range(SLOTS)]),
            r_bracket_hex=[hx(gamma[j][i]) for j in range(N_PARTIES)],
            beta_hex=SER.field_to_hex(betas[i], FR))


def _summary(rep):
    return {"synthesis_s": rep["synthesis_s"], "verified": rep["verified"],
            "synthesis_openings": rep["synthesis_openings"] - rep["input_openings"]}


def party(i, addrs, setup_dir, inputs, out):
    """One socket party: the online run, cold and then warm (``addrs``:
    one address file a run), its collectives timed inside the
    synthesis."""
    import torch
    from zkmpc_tpu_torch.circuits import my_circuit
    from zkmpc_tpu_torch.cli import online
    from zkmpc_tpu_torch.parallel import native_net as NN
    split = {}
    inside = [False]

    def timed(key, fn):
        def wrap(*a, **k):
            if not inside[0]:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[key] += time.perf_counter() - t0
        return wrap
    NN._to_wire = timed("drain_s", NN._to_wire)
    NN.NativeMeshNet.broadcast_bytes = timed("mesh_s", NN.NativeMeshNet.broadcast_bytes)
    NN.SocketTransport._back = timed("back_s", NN.SocketTransport._back)
    build = my_circuit.build

    def build_timed(*a, **k):
        torch.cuda.synchronize()
        inside[0] = True
        t0 = time.perf_counter()
        try:
            return build(*a, **k)
        finally:
            torch.cuda.synchronize()
            split["build_s"] = time.perf_counter() - t0
            inside[0] = False
    my_circuit.build = build_timed
    runs = {}
    for run, path in zip(("cold", "warm"), addrs):
        split.update(drain_s=0.0, mesh_s=0.0, back_s=0.0)
        rep = {}
        online.run(inputs, setup_dir, None, i, path, "marlin", SEED, "cuda", report=rep)
        runs[run] = dict(_summary(rep), net=rep["net"], **split,
                         rest_s=split["build_s"] - split["drain_s"] - split["mesh_s"]
                         - split["back_s"],
                         before_build_s=rep["synthesis_s"] - split["build_s"])
    with open(out, "w") as f:
        json.dump(dict(party=i, **runs), f)


def stacked(setup_dir, inputs, synced):
    import torch
    from zkmpc_tpu_torch.cli import online
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    saved = StackedTransport.psum, StackedTransport.all_gather

    def then_sync(fn):
        def wrap(self, x):
            out = fn(self, x)
            torch.cuda.synchronize()
            return out
        return wrap
    if synced:
        StackedTransport.psum, StackedTransport.all_gather = map(then_sync, saved)
    try:
        rep = {}
        online.run(inputs, setup_dir, N_PARTIES, zksnark="marlin", seed=SEED, device="cuda",
                   report=rep)
    finally:
        StackedTransport.psum, StackedTransport.all_gather = saved
    return _summary(rep)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("socket_latency: no CUDA device available")
    from zkmpc_tpu_torch.parallel import native_net
    native_net.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    inputs = os.path.join(ROOT, "inputs", "inputs-template.json")
    with tempfile.TemporaryDirectory() as work:
        write_setups(work)
        stacked(work, inputs, False)            # builds and warms the kernels
        runs = {"stacked": stacked(work, inputs, False),
                "stacked_synced": stacked(work, inputs, True)}
        addrs = [os.path.join(work, f"addrs_{run}") for run in ("cold", "warm")]
        ports = iter(_free_ports(2 * N_PARTIES))
        for path in addrs:
            with open(path, "w") as f:
                f.write("".join(f"127.0.0.1:{next(ports)}\n" for _ in range(N_PARTIES)))
        outs = [os.path.join(work, f"{i}.json") for i in range(N_PARTIES)]
        spawn = multiprocessing.get_context("spawn")
        procs = [spawn.Process(target=party, args=(i, addrs, work, inputs, outs[i]))
                 for i in range(N_PARTIES)]
        for p in procs:
            p.start()
        t0 = time.time()
        try:
            for p in procs:
                p.join(max(1.0, t0 + TIMEOUT_S - time.time()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if any(p.exitcode for p in procs):
            raise SystemExit(f"socket_latency: a party failed "
                             f"({[p.exitcode for p in procs]})")
        runs["socket"] = []
        for o in outs:
            with open(o) as f:
                runs["socket"].append(json.load(f))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "parties": N_PARTIES,
                      "zksnark": "marlin", **runs}), flush=True)


if __name__ == "__main__":
    main()
