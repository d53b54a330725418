#!/usr/bin/env python3
"""Where one warm SHE triple batch of the port spends its time, on one CUDA
card.

Makes a dealer at 3 parties (`she.preprocessing.make_dealer` and
`initialize`), runs `triple_kernel` once to warm up, once on the host clock
and once under `torch.profiler`, for each (slots, ciphertexts) given;
prints one JSON object per batch with the card's name and power limit, the
wall-clocks, the device's busy time, device time and launches by kernel
(K1 by limb width, and the ten largest PyTorch kernels) and the wrappers'
launch counts.  With ``--device cpu`` it times the batches on the host
clock alone (the plain versions, one thread unless ``--threads``).

    python3 tools/profile_triples.py [--slots 1024] [--ciphertexts 1 16]
                                     [--device cpu] [--threads N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--ciphertexts", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=1, help="CPU threads (--device cpu)")
    args = ap.parse_args(argv)
    import torch
    from profile_prove import profile_call
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.she import bgv
    from zkmpc_tpu_torch.she import preprocessing as PP
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_triples: no CUDA device available")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    else:
        torch.set_num_threads(args.threads)
    gen = torch.Generator(dev).manual_seed(1)
    ctx = PP.make_dealer(bgv.SheParams(args.slots), 3, gen, device=dev)
    PP.initialize(ctx, gen)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for cts in args.ciphertexts:
        PP.triple_kernel(ctx, gen, cts)
        sync()
        t0 = time.time()
        PP.triple_kernel(ctx, gen, cts)
        sync()
        wall = time.time() - t0
        if dev.type == "cpu":
            print(json.dumps({"device": "cpu", "threads": args.threads, "slots": args.slots,
                              "ciphertexts": cts, "triples": args.slots * cts,
                              "batch_s": wall, "triples_per_s": args.slots * cts / wall}),
                  flush=True)
            continue
        prof_wall, ours, other = profile_call(lambda: PP.triple_kernel(ctx, gen, cts),
                                              before=K.reset_launches)
        busy = sum(v[0] for v in ours.values()) + sum(v[0] for v in other.values())
        top = sorted(other.items(), key=lambda kv: -kv[1][0])[:10]
        print(json.dumps({
            "card": card, "slots": args.slots, "ciphertexts": cts,
            "triples": args.slots * cts, "batch_s": wall, "profiled_batch_s": prof_wall,
            "device_busy_ms": busy, "idle_share": 1 - busy / (prof_wall * 1e3),
            "kernels": {k: {"ms": v[0], "launches": v[1]} for k, v in sorted(ours.items())},
            "wrapper_launch_counts": dict(K.LAUNCHES),
            "pytorch_ms": sum(v[0] for v in other.values()),
            "pytorch_launches": sum(v[1] for v in other.values()),
            "pytorch_top": [{"name": k[:80], "ms": v[0], "launches": v[1]} for k, v in top],
        }), flush=True)


if __name__ == "__main__":
    main()
