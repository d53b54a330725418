#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the hand-written CUDA kernels from ``zkmpc_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the port's
main path: the wide-mul collaborative Groth16 prove at 16,381 gates and 3
parties (domain 2^14) on the stacked transport -- device setup, two proves
on different share inputs and randomness, pairing verification of both and
rejection of a wrong instance.  It also re-proves the committed 4-gate
fixture with the JAX package's key and shares and requires that package's
proof.

    python3 chip_smoke.py              # needs one CUDA card
    python3 chip_smoke.py --gates 64   # a quicker main-path run

Exits nonzero, printing no result, when any phase fails or no CUDA card is
present.  The line before the last is a JSON object of per-kernel results;
the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

DEVICE = "cuda"

# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    "mont_mul": ("zkmpc_tpu_torch/csrc/mont_mul.cu", "zkmpc_tpu/ops/pallas_fp.py:122"),
    "point_add_g1": ("zkmpc_tpu_torch/csrc/point_add.cu", "zkmpc_tpu/ops/pallas_point.py:344"),
    "point_add_g2": ("zkmpc_tpu_torch/csrc/point_add.cu", "zkmpc_tpu/ops/pallas_point.py:358"),
}


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events, warmed up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    import torch
    from zkmpc_tpu_torch.ops import build as K
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    log(out.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.time()
    path = K.build()
    K.library()
    log(f"phase 1 build: {time.time() - t0:.1f} s, {path}")
    with open(os.path.join(os.path.dirname(path), "ptxas.log")) as f:
        for ln in f:
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"  ptxas {ln.strip()}")


def _rand_fp(spec, n, rng, device):
    import numpy as np
    from zkmpc_tpu_torch.ops.limbs import FpArray
    ints = [rng.randrange(spec.p) for _ in range(n)]
    return ints, FpArray.from_int(spec, np.asarray(ints, dtype=object), device=device)


def _to_ints(spec, limbs):
    from zkmpc_tpu_torch.ops.limbs import FpArray
    return [int(v) for v in FpArray(limbs, spec, 2).to_ints().reshape(-1)]


def phase_mont_mul(results):
    import torch
    from zkmpc_tpu_torch.ops import cuda_fp
    from zkmpc_tpu_torch.ops.limbs import FQ, FR, MNT4Q
    dev = torch.device(DEVICE)
    rng = random.Random(1)
    max_err = 0
    for spec in (FR, FQ, MNT4Q):
        for size in (1, 1000, 65537):
            xs, a = _rand_fp(spec, size, rng, dev)
            ys, b = _rand_fp(spec, size, rng, dev)
            a2 = a + a                                     # relaxed, bound 2
            cases = [("canonical", a.limbs, b.limbs, 1, False),
                     ("relaxed", a2.limbs, b.limbs, 2, False),
                     ("const-b", a2.limbs, b.limbs[0], 2, True)]
            for name, la, lb, scale, const in cases:
                got = cuda_fp.mont_mul_cuda(spec, la, lb)
                want = cuda_fp.mont_mul_plain(spec, la, lb)
                torch.cuda.synchronize()
                max_err = max(max_err, int((got - want).abs().max().item()))
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 {spec.name} {name} n={size}: "
                                         f"limbs differ from the plain version")
                # a sample against host ints: REDC(xR * yR) = xyR
                k = min(size, 8)
                vals = _to_ints(spec, got[:k])
                for i in range(k):
                    y = ys[0] if const else ys[i]
                    if vals[i] != scale * xs[i] * y % spec.p:
                        raise AssertionError(f"K1 {spec.name} {name}: sample {i}")
    log(f"phase 2 K1 vs plain: FR/FQ/MNT4Q x canonical/relaxed/const-b x "
        f"n=1/1000/65537 bit-identical, host samples agree; max_abs_err {max_err}")
    for spec in (FR, FQ):
        for logn in (14, 16, 18):
            _, a = _rand_fp(spec, 1 << logn, rng, dev)
            b = a + a
            k_ms = cuda_time_ms(lambda: cuda_fp.mont_mul_cuda(spec, b.limbs, a.limbs), 20)
            p_ms = cuda_time_ms(lambda: cuda_fp.mont_mul_plain(spec, b.limbs, a.limbs), 5)
            log(f"  K1 {spec.name} 2^{logn}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    # the NTT stage shape of the slice: 3 parties x 2^14 FR elements
    _, a = _rand_fp(FR, 3 << 14, rng, dev)
    b = (a + a).reshape((3, 1 << 14))
    a = a.reshape((3, 1 << 14))
    k_ms = cuda_time_ms(lambda: cuda_fp.mont_mul_cuda(FR, b.limbs, a.limbs), 20)
    p_ms = cuda_time_ms(lambda: cuda_fp.mont_mul_plain(FR, b.limbs, a.limbs), 5)
    log(f"  K1 FR [3, 2^14] (an NTT stage of the slice): kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms")
    results["mont_mul"] = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms)


def _case_points(g2, device):
    """All-cases lanes: generic, p == q, q == -p, p at inf, q at inf, both at
    inf, then a ragged run of generic pairs (1003 lanes in all)."""
    import torch
    from zkmpc_tpu.spec import curves as SC
    from zkmpc_tpu_torch.ops.curve import SWPoint
    gen, mul, neg, add = (SC.G2_GEN, SC.g2_mul, SC.g2_neg, SC.g2_add) if g2 else \
        (SC.G1_GEN, SC.g1_mul, SC.g1_neg, SC.g1_add)
    make = SWPoint.g2_from_affine_ints if g2 else SWPoint.g1_from_affine_ints
    base = [mul(gen, k) for k in range(1, 34)]
    pk = [2, 5, 7, 11, 13, 17] + [3 + (i % 29) for i in range(997)]
    qk = [9, 5, 7, 19, 23, 29] + [1 + ((7 * i + 3) % 31) for i in range(997)]
    pa = [base[k - 1] for k in pk]
    qa = [base[k - 1] for k in qk]
    qa[2] = neg(pa[2])
    pinf = [0, 0, 0, 1, 0, 1] + [0] * 997
    qinf = [0, 0, 0, 0, 1, 1] + [0] * 997
    p, q = make(pa, device), make(qa, device)
    p.inf = torch.tensor(pinf, dtype=torch.bool, device=device)
    q.inf = torch.tensor(qinf, dtype=torch.bool, device=device)
    exp = []
    for a, b, ia, ib in zip(pa, qa, pinf, qinf):
        a, b = (None if ia else a), (None if ib else b)
        exp.append(b if a is None else a if b is None else add(a, b))
    return p, q, exp


def _affine_err(got, want):
    """Largest |difference| of affine coordinates (ints) between two lists of
    points, counting an infinity mismatch as infinitely large."""
    err = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            return float("inf")
        if g is None:
            continue
        flat = [(g[0], w[0]), (g[1], w[1])]
        if isinstance(g[0], tuple):
            flat = [(g[0][0], w[0][0]), (g[0][1], w[0][1]),
                    (g[1][0], w[1][0]), (g[1][1], w[1][1])]
        err = max([err] + [abs(int(x) - int(y)) for x, y in flat])
    return err


def phase_point_add(results):
    import torch
    from zkmpc_tpu_torch.ops import cuda_point
    dev = torch.device(DEVICE)
    for g2, name in ((False, "point_add_g1"), (True, "point_add_g2")):
        p, q, exp = _case_points(g2, dev)
        got = cuda_point.sw_add_complete_cuda(p, q)
        want = cuda_point.sw_add_complete_plain(p, q)
        torch.cuda.synchronize()
        ga, wa = got.to_affine_ints(), want.to_affine_ints()
        err = _affine_err(ga, wa)
        if not torch.equal(got.inf, want.inf) or err != 0:
            bad = [i for i, (x, y) in enumerate(zip(ga, wa)) if x != y][:5]
            raise AssertionError(f"{name}: differs from the plain version at lanes {bad}")
        if ga != exp:
            bad = [i for i, (x, y) in enumerate(zip(ga, exp)) if x != y][:5]
            raise AssertionError(f"{name}: differs from spec.curves at lanes {bad}")
        # timing at the Pippenger lane count of the slice (L = 32768)
        idx = torch.arange(32768, device=dev) % 1003
        pl = p.map(lambda t: t.index_select(0, idx))
        ql = q.map(lambda t: t.index_select(0, idx))
        k_ms = cuda_time_ms(lambda: cuda_point.sw_add_complete_cuda(pl, ql), 10)
        p_ms = cuda_time_ms(lambda: cuda_point.sw_add_complete_plain(pl, ql), 3)
        results[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
        log(f"phase 3 {name} vs plain and spec: 1003 lanes (all cases + ragged) "
            f"identical, max_abs_err {err}; 32768 lanes: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms")


def phase_fixture():
    """The committed 4-gate prove of the JAX package, re-run on the card."""
    import importlib.util

    import numpy as np
    import torch
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.snark import driver, groth16
    path = os.path.join(ROOT, "tests", "fixtures", "make_torch_slice_fixture.py")
    spec = importlib.util.spec_from_file_location("slice_fixture", path)
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    fx = mk.load(np.load(mk.PATH))
    dev = torch.device(DEVICE)
    t0 = time.time()
    dpk = driver.dpk_from_host(fx["doc"], dev)
    step, args = driver.make_prove_fn(dpk, mk.N_PARTIES)

    def share(key):
        limbs, bound = fx[key]
        return FpArray(torch.as_tensor(limbs.astype(np.int64), device=dev), FR, bound)
    proof = driver.proof_arrays_to_ints(step(*args, r=share("r"), s=share("s")))
    if proof != fx["proof"]:
        raise AssertionError("4-gate prove on the card differs from the reference proof")
    if not groth16.verify(dpk.pk.vk, driver.expected_instance(mk.N_GATES), proof):
        raise AssertionError("4-gate proof does not verify")
    log(f"phase 4a reference fixture ({mk.N_GATES} gates, {mk.N_PARTIES} parties): "
        f"proof equals the reference's and verifies ({time.time() - t0:.1f} s)")


def _reshare(limbs, masks, n_parties, n_gates):
    """Party 0 holds value - sum(masks), party i holds mask i (the dealt
    shares of `make_prove_fn` put the whole value on party 0)."""
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    x = FpArray(limbs, FR, 2)
    total = masks[0]
    for i in range(1, n_parties - 1):
        total = total + masks[i]
    first = (x[0] - total).tighten()
    return FpArray.concat([first.reshape((1, n_gates)), masks.tighten()], 0).limbs


def phase_slice(n_gates, n_parties=3):
    """The main path: setup and two proves, with the kernel counts reset
    just before and read just after."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.snark import driver, groth16
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.time()
    dpk = driver.synthesize(n_gates, n_parties, device=dev)
    step, args = driver.make_prove_fn(dpk, n_parties)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    setup_launches = dict(K.LAUNCHES)

    # the second input: the same gate values re-shared with fresh masks
    rng = np.random.default_rng(11)
    a_l, b_l, _ = args
    masks = [FpArray.from_int(FR, np.asarray(
        [int(x) for x in rng.integers(1, 2**62, (n_parties - 1) * n_gates)],
        dtype=object).reshape(n_parties - 1, n_gates), device=dev) for _ in range(2)]
    args2 = (_reshare(a_l, masks[0], n_parties, n_gates),
             _reshare(b_l, masks[1], n_parties, n_gates),
             torch.Generator().manual_seed(8))

    proofs, times, per_prove = [], [], []
    for call in (args, args2):
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.time()
        outs = step(*call)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        per_prove.append({k: v - before.get(k, 0) for k, v in K.LAUNCHES.items()})
        proofs.append(driver.proof_arrays_to_ints(outs))
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    pk = dpk.pk
    log(f"phase 4 setup: {n_gates} gates, {pk.num_constraints} constraints, "
        f"domain {pk.domain_n}, m = {pk.num_instance + pk.num_witness}: {t_setup:.2f} s")
    inst = driver.expected_instance(n_gates)
    for i, proof in enumerate(proofs):
        if any(pt is None for pt in proof):
            raise AssertionError(f"prove {i + 1}: a proof point is at infinity")
        if not groth16.verify(pk.vk, inst, proof):
            raise AssertionError(f"prove {i + 1}: the proof does not verify")
    if proofs[0] == proofs[1]:
        raise AssertionError("two proves on different inputs gave the same proof")
    bad = [inst[0], (inst[1] + 1) % FR.p]
    if groth16.verify(pk.vk, bad, proofs[0]):
        raise AssertionError("a wrong instance verified")
    log(f"phase 4 prove 1: {times[0]:.2f} s, prove 2: {times[1]:.2f} s; both verify, "
        f"wrong instance rejected; peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    log(f"phase 4 launches: setup {setup_launches}; prove 1 {per_prove[0]}; "
        f"prove 2 {per_prove[1]}; main path {launches}")
    for name in KERNELS:
        if min(per_prove[0].get(name, 0), per_prove[1].get(name, 0)) <= 0:
            raise AssertionError(f"a prove never launched {name}")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gates", type=int, default=16381,
                    help="wide-mul gates of the main-path prove (default 16381: domain 2^14)")
    args = ap.parse_args(argv)
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    import zkmpc_tpu_torch  # noqa: F401  (fails at once outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    phase_card()
    phase_mont_mul(results)
    phase_point_add(results)
    phase_fixture()
    launches = phase_slice(args.gates)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the run imported jax")
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
