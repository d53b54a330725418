#!/usr/bin/env python3
"""Where one warm prove of the port's main path spends its time, on one
CUDA card.

Sets up the wide-mul circuit at 3 parties (16,381 gates by default, the
size `chip_smoke.py` proves), runs one prove to warm up, one timed on the
host clock, and one under `torch.profiler`; prints one JSON object with the
card's name and power limit, the two wall-clocks, the device's busy time,
and device time and launches by kernel: K1 (`mont_mul_kernel`), K2/K3
(`point_add_kernel<F1|F2>`) and the PyTorch kernels around them, the ten
largest of those by name; the wrappers' launch counts (K1's operand copies
among them); and K1's own device time at the NTT-stage shape FR [3, 2^14].

    python3 tools/profile_prove.py [--gates N] [--root DIR]

``--root`` profiles the ``zkmpc_tpu_torch`` of another checkout (an
unpacked parent commit, say) with this script.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_group(name):
    """K1/K2/K3 by kernel name, K1 split by limb width ("K1 mont_mul n18")."""
    if "point_add_kernel" in name:
        return "K3 point_add<F2>" if "F2" in name else "K2 point_add<F1>"
    if "mont_mul_kernel" in name:
        m = re.search(r"mont_mul_kernel<(\d+)", name)
        return f"K1 mont_mul n{m.group(1)}" if m else "K1 mont_mul"
    return None


def _kineto_device_events(prof) -> list:
    """(kernel name, device us) of every device event of a finished
    profile, read from its kineto results as `prof.events()` reads them
    (device type CUDA, hidden events left out, names demangled), without
    building that list of every CPU and device event: for a prove's
    quarter-million launches the list takes about 100 s to build."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    demangle = getattr(torch._C, "_demangle", lambda name: name)
    return [(demangle(ev.name()), (ev.end_ns() - ev.start_ns()) / 1e3)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda
            and not getattr(ev, "is_hidden_event", lambda: False)()]


def device_events(fn, sessions=5, before=None):
    """One call of fn, ended by a synchronize, under torch.profiler: (wall
    s, [(kernel name, device us)]) of every device event.  A session on the
    card now and then records no device event at all (PERF.md section 7);
    such a session is run again, ``before()`` first where given, up to
    ``sessions`` in all, and then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        if before is not None:
            before()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        evs = _kineto_device_events(prof)
        if sum(us for _, us in evs) > 0:
            return wall, evs
    raise RuntimeError(f"torch.profiler recorded no device event in {sessions} sessions")


def profile_call(fn, before=None):
    """`device_events` of one call of fn, grouped: (wall s, {K1/K2/K3
    group: [device ms, launches]}, {other kernel name: [device ms,
    launches]})."""
    wall, evs = device_events(fn, before=before)
    ours = collections.defaultdict(lambda: [0.0, 0])
    other = collections.defaultdict(lambda: [0.0, 0])
    for name, us in evs:
        group = kernel_group(name)
        acc = ours[group] if group else other[name]
        acc[0] += us / 1e3
        acc[1] += 1
    return wall, dict(ours), dict(other)


def k1_device_ms(dev, reps=20):
    """K1's own device time (profiler records of `mont_mul_kernel`) at the
    slice's NTT-stage shape, FR [3, 2^14], on a relaxed operand (a + a, as
    the NTT's odd half is) times a canonical one."""
    import numpy as np
    from zkmpc_tpu_torch.ops import cuda_fp
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    rng = np.random.default_rng(3)
    ints = [int(x) for x in rng.integers(1, 2**62, 3 << 14)]
    a = FpArray.from_int(FR, np.asarray(ints, dtype=object).reshape(3, 1 << 14), device=dev)
    b = a + a
    cuda_fp.mont_mul_cuda(FR, b.limbs, a.limbs)
    _, evs = device_events(lambda: [cuda_fp.mont_mul_cuda(FR, b.limbs, a.limbs)
                                    for _ in range(reps)])
    us = sum(t for name, t in evs if "mont_mul_kernel" in name)
    if us <= 0:
        raise RuntimeError("the profiler recorded no mont_mul_kernel event")
    return us / reps / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gates", type=int, default=16381)
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose zkmpc_tpu_torch is profiled")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.snark import driver
    if not torch.cuda.is_available():
        raise SystemExit("profile_prove: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    dpk = driver.synthesize(args.gates, 3, device=dev)
    step, call = driver.make_prove_fn(dpk, 3)
    step(*call)
    torch.cuda.synchronize()
    t0 = time.time()
    step(*call)
    torch.cuda.synchronize()
    wall = time.time() - t0
    prof_wall, ours, other = profile_call(lambda: step(*call), before=K.reset_launches)
    launches = dict(K.LAUNCHES)
    k1_ms = k1_device_ms(dev)
    busy = sum(v[0] for v in ours.values()) + sum(v[0] for v in other.values())
    top = sorted(other.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "card": card, "root": os.path.abspath(args.root), "gates": args.gates, "prove_s": wall,
        "profiled_prove_s": prof_wall, "device_busy_ms": busy,
        "idle_share": 1 - busy / (prof_wall * 1e3),
        "kernels": {k: {"ms": v[0], "launches": v[1]} for k, v in sorted(ours.items())},
        "wrapper_launch_counts": launches,
        "k1_fr_3x2^14_device_ms": k1_ms,
        "pytorch_ms": sum(v[0] for v in other.values()),
        "pytorch_launches": sum(v[1] for v in other.values()),
        "pytorch_top": [{"name": k[:80], "ms": v[0], "launches": v[1]} for k, v in top],
    }), flush=True)


if __name__ == "__main__":
    main()
