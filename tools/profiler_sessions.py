#!/usr/bin/env python3
"""How often a torch.profiler session on one CUDA card records no device
event, before and after a session as long as a profiled prove.

Runs ``--sessions`` short sessions of ``--launches`` K1 launches each
(`cuda_fp.mont_mul_cuda` at FR [2^14], the kind of session that
`chip_smoke.device_ms` opens), then one long session of ``--big`` small
PyTorch launches (a profiled warm prove records about 254,000), then the
short sessions again; each session goes through
`tools/profile_prove.device_events` with no retry.  Prints one JSON object:
the card's name and power limit, torch's version, and for each round the
sessions that recorded no device event at all, those that recorded events
but none named ``mont_mul_kernel``, and the device events the long session
recorded against the launches it made.

    python3 tools/profiler_sessions.py [--sessions 200] [--launches 20] [--big 300000]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def short_sessions(n, fn, device_events):
    """Indices of the sessions with no device event, and of those without
    a K1 event."""
    empty, unnamed = [], []
    for i in range(n):
        try:
            _, evs = device_events(fn, sessions=1)
        except RuntimeError:
            empty.append(i)
            continue
        if not any("mont_mul_kernel" in name for name, _ in evs):
            unnamed.append(i)
    return {"sessions": n, "no_device_event": empty, "no_k1_event": unnamed}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=200)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--big", type=int, default=300000)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from profile_prove import device_events
    from zkmpc_tpu_torch.ops import cuda_fp
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    if not torch.cuda.is_available():
        raise SystemExit("profiler_sessions: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    ints = [int(x) for x in rng.integers(1, 2**62, 1 << 14)]
    a = FpArray.from_int(FR, np.asarray(ints, dtype=object), device=dev)

    def k1():
        for _ in range(args.launches):
            cuda_fp.mont_mul_cuda(FR, a.limbs, a.limbs)
    k1()
    torch.cuda.synchronize()
    before = short_sessions(args.sessions, k1, device_events)
    x = torch.zeros(256, device=dev)

    def big():
        for _ in range(args.big):
            x.add_(1)
    try:
        wall, evs = device_events(big, sessions=1)
        long = {"launches": args.big, "device_events": len(evs), "wall_s": wall}
    except RuntimeError:
        long = {"launches": args.big, "device_events": 0}
    after = short_sessions(args.sessions, k1, device_events)
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "launches_per_short_session": args.launches,
                      "before_long_session": before, "long_session": long,
                      "after_long_session": after}), flush=True)


if __name__ == "__main__":
    main()
