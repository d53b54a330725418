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

# Peak rates of one H100 SXM for bound_ms: device memory bytes/s (NVIDIA's
# data sheet) and 32-bit integer multiply-adds/s (64 IMADs per clock per SM,
# 132 SMs, 1.98 GHz boost clock).
MEM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9

# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    "mont_mul": ("zkmpc_tpu_torch/csrc/mont_mul.cu", "zkmpc_tpu/ops/pallas_fp.py:122"),
    "point_add_g1": ("zkmpc_tpu_torch/csrc/point_add.cu", "zkmpc_tpu/ops/pallas_point.py:344"),
    "point_add_g2": ("zkmpc_tpu_torch/csrc/point_add.cu", "zkmpc_tpu/ops/pallas_point.py:358"),
}


def log(msg):
    print(msg, flush=True)


def mont_imads(bits):
    """IMADs of one Montgomery product at `bits`: a w-word CIOS does
    2w^2 + w word products, each a lo and a hi IMAD."""
    w = -(-bits // 32)
    return 2 * (2 * w * w + w)


def bound(n_bytes, imads):
    """(bound_ms, bound_by): the least time for moving n_bytes and doing
    `imads` multiply-adds on the card, and which of the two sets it."""
    t_mem, t_ops = n_bytes / MEM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


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


def device_ms(fn, reps, match=None):
    """Mean device time of fn() over reps calls, from torch.profiler's
    records of the kernels it ran: those whose name contains `match`, or all
    of them.  Unlike `cuda_time_ms`, no host time between launches counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and (match is None or match in ev.name))
    if us <= 0:
        raise AssertionError(f"the profiler recorded no device time for {match or 'fn'}")
    return us / reps / 1e3


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


def k1_edge_limbs(spec, c):
    """Limbs B+1 from the bottom up while the value stays below c*p; the
    next limb as large as that bound allows; the rest 0."""
    import numpy as np
    from zkmpc_tpu_torch.ops.limbs import B
    n, bound = spec.nlimbs, c * spec.p
    limbs, val = [0] * n, 0
    for i in range(n):
        limbs[i] = min(B + 1, (bound - 1 - val) // B ** i)
        val += limbs[i] * B ** i
        if limbs[i] < B + 1:
            break
    return np.asarray(limbs, dtype=np.int64)


def k1_cases(spec, seed):
    """K1's hard inputs, each pair within the contract (a < c1*p, b < c2*p,
    c1*c2*p <= R/2): [(name, a limbs [k, n], b limbs [k, n])], int64 numpy.
    0, 1, p-1 and 2p-1 against each other; pairs at the contract's edge
    (c1*c2 as large as the budget allows) with values c*p - 1, random ones
    and limbs B+1 wherever the bound allows; runs of all-ones 32-bit words,
    whose carries run the length of a chain."""
    import math

    import numpy as np
    from zkmpc_tpu_torch.ops.limbs import int_to_limbs
    p, n = spec.p, spec.nlimbs
    budget = spec.mul_bound_budget
    rng = np.random.default_rng(seed)

    def below(bound, k):
        return [int.from_bytes(rng.bytes(bound.bit_length() // 8 + 8), "little") % bound
                for _ in range(k)]

    def lim(vals):
        return np.stack([int_to_limbs(v, n) for v in vals])

    small = [0, 1, p - 1, 2 * p - 1]
    out = [("small", lim([x for x in small for _ in small]),
            lim([y for _ in small for y in small]))]
    c_sq = math.isqrt(budget)
    for c1, c2 in ((budget, 1), (1, budget), (c_sq, budget // c_sq), (2, 2)):
        a = np.concatenate([lim([c1 * p - 1] + below(c1 * p, 6)), k1_edge_limbs(spec, c1)[None]])
        b = np.concatenate([lim([c2 * p - 1] + below(c2 * p, 6)), k1_edge_limbs(spec, c2)[None]])
        out.append((f"edge {c1}x{c2}", a, b))
        out.append((f"edge {c1}x{c2} reversed", a[::-1].copy(), b))
    w = -(-15 * n // 32)
    top = 1 << (32 * (w - 1))
    ones = [top - 1, top - (1 << 32), top - (1 << (32 * (w // 2))), top // 2 - 1]
    c1 = (top - 1) // p + 1
    c2 = min(c1, budget // c1)
    partners = [v for v in ones if v < c2 * p] + [c2 * p - 1]
    out.append(("all-ones words", lim([x for x in ones for _ in partners]),
                lim([y for _ in ones for y in partners])))
    return out


def check_k1(spec, got, want):
    """K1's output against the plain version's on the same inputs: equal
    modulo p, below 2p, every limb below 2^15.  Returns the largest
    difference of the two canonical (below p) limb vectors: 0."""
    import torch
    from zkmpc_tpu_torch.ops.limbs import _canonicalize_lt2p, _geq, int_to_limbs
    if got.shape != want.shape or not got.is_contiguous():
        raise AssertionError(f"K1 {spec.name}: output shape {tuple(got.shape)}")
    if bool(((got < 0) | (got >= 1 << 15)).any()):
        raise AssertionError(f"K1 {spec.name}: a limb outside [0, 2^15)")
    two_p = torch.as_tensor(int_to_limbs(2 * spec.p, spec.nlimbs), device=got.device)
    if bool(_geq(got, two_p).any()):
        raise AssertionError(f"K1 {spec.name}: a value at or above 2p")
    err = int((_canonicalize_lt2p(spec, got) - _canonicalize_lt2p(spec, want)).abs().max())
    if err:
        raise AssertionError(f"K1 {spec.name}: values differ from the plain version mod p")
    return err


def k1_views(spec, dev, seed):
    """[(name, a, b)] of strided and broadcast operands as the main path
    makes them: a sliced non-contiguous a; an NTT stage's odd half (a view of
    [3, n/m, m] elements) times the stage's [m/2] twiddles, at an inner and
    at the last stage; [3, 1] x [1, 5].  Random values below 2p."""
    import torch
    _, x = _rand_fp(spec, 3 * 4096, random.Random(seed), dev)
    x2 = (x + x).limbs.reshape(3, 4096, spec.nlimbs)
    _, tw = _rand_fp(spec, 2048, random.Random(seed + 1), dev)
    out = [("sliced a", x2[:, 1::3, :], x.limbs.reshape(3, 4096, -1)[:, :1365, :])]
    for m in (64, 4096):
        y = x2.reshape(3, 4096 // m, m, spec.nlimbs)
        out.append((f"NTT odd view m={m} x twiddles", y[..., m // 2:, :], tw.limbs[:m // 2]))
    out.append(("[3, 1] x [1, 5]", x2[0, :3, None, :], x.limbs[None, 7:12, :]))
    assert not out[0][1].is_contiguous() and not out[1][1].is_contiguous()
    return out


def phase_mont_mul(results):
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops import cuda_fp
    from zkmpc_tpu_torch.ops.limbs import FQ, FR, MNT4Q, limbs_to_int
    dev = torch.device(DEVICE)
    rng = random.Random(1)
    max_err = 0

    def one_launch(spec, name, a, b):
        """K1 through the wrapper: exactly one launch and no operand copy."""
        K.reset_launches()
        got = cuda_fp.mont_mul(spec, a, b)
        torch.cuda.synchronize()
        if dict(K.LAUNCHES) != {"mont_mul": 1}:
            raise AssertionError(f"K1 {spec.name} {name}: launches {dict(K.LAUNCHES)}")
        return got, check_k1(spec, got, cuda_fp.mont_mul_plain(spec, a, b))

    for spec in (FR, FQ, MNT4Q):
        for size in (1, 1000, 65537):
            xs, a = _rand_fp(spec, size, rng, dev)
            ys, b = _rand_fp(spec, size, rng, dev)
            a2 = a + a                                     # relaxed, bound 2
            cases = [("canonical", a.limbs, b.limbs, 1, False),
                     ("relaxed", a2.limbs, b.limbs, 2, False),
                     ("const-b", a2.limbs, b.limbs[0], 2, True)]
            for name, la, lb, scale, const in cases:
                got, err = one_launch(spec, name, la, lb)
                max_err = max(max_err, err)
                # a sample against host ints: REDC(xR * yR) = xyR
                k = min(size, 8)
                vals = _to_ints(spec, got[:k])
                for i in range(k):
                    y = ys[0] if const else ys[i]
                    if vals[i] != scale * xs[i] * y % spec.p:
                        raise AssertionError(f"K1 {spec.name} {name}: sample {i}")
        for name, la, lb in k1_cases(spec, seed=2):
            a, b = torch.as_tensor(la, device=dev), torch.as_tensor(lb, device=dev)
            got, err = one_launch(spec, name, a, b)
            max_err = max(max_err, err)
            for ra, rb, rg in zip(la, lb, got.cpu().numpy()):       # host ints
                want = limbs_to_int(ra) * limbs_to_int(rb) * spec.rinv % spec.p
                if limbs_to_int(rg) % spec.p != want:
                    raise AssertionError(f"K1 {spec.name} {name}: differs from host ints")
        for name, a, b in k1_views(spec, dev, seed=3):
            _, err = one_launch(spec, name, a, b)
            max_err = max(max_err, err)
    log(f"phase 2 K1 vs plain: FR/FQ/MNT4Q x canonical/relaxed/const-b x n=1/1000/65537, "
        f"contract-edge and all-ones-word inputs, sliced, NTT-view and broadcast operands: "
        f"equal mod p, below 2p, limbs below 2^15, one launch and no operand copy each; "
        f"host samples agree; max_abs_err {max_err}")
    # times: "device" is the kernel's own device time (`device_ms`), "per
    # call" the CUDA-event time of back-to-back wrapper calls, which the
    # host paces where the kernel is short
    for spec in (FR, FQ):
        for logn in (14, 16, 18):
            _, a = _rand_fp(spec, 1 << logn, rng, dev)
            b = a + a
            k_ms = device_ms(lambda: cuda_fp.mont_mul_cuda(spec, b.limbs, a.limbs), 20,
                             "mont_mul_kernel")
            c_ms = cuda_time_ms(lambda: cuda_fp.mont_mul_cuda(spec, b.limbs, a.limbs), 20)
            p_ms = device_ms(lambda: cuda_fp.mont_mul_plain(spec, b.limbs, a.limbs), 5)
            n = 1 << logn
            b_ms, _ = bound(3 * n * spec.nlimbs * 8, n * mont_imads(spec.p.bit_length()))
            log(f"  K1 {spec.name} 2^{logn}: device {k_ms:.4f} ms, per call {c_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms")
    # the NTT stage shape of the slice: 3 parties x 2^14 FR elements
    _, a = _rand_fp(FR, 3 << 14, rng, dev)
    b = (a + a).reshape((3, 1 << 14))
    a = a.reshape((3, 1 << 14))
    k_ms = device_ms(lambda: cuda_fp.mont_mul_cuda(FR, b.limbs, a.limbs), 20, "mont_mul_kernel")
    c_ms = cuda_time_ms(lambda: cuda_fp.mont_mul_cuda(FR, b.limbs, a.limbs), 20)
    p_ms = device_ms(lambda: cuda_fp.mont_mul_plain(FR, b.limbs, a.limbs), 5)
    n = 3 << 14
    b_ms, b_by = bound(3 * n * FR.nlimbs * 8, n * mont_imads(FR.p.bit_length()))
    log(f"  K1 FR [3, 2^14] (an NTT stage of the slice): device {k_ms:.4f} ms, per call "
        f"{c_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the slice's last NTT stage end to end through the wrapper: the odd
    # half, a view [3, 1, 2^13] of [3, 2^14], times the [2^13] twiddles
    _, tw = _rand_fp(FR, 1 << 13, rng, dev)
    odd = b.limbs.reshape(3, 1, 1 << 14, FR.nlimbs)[..., 1 << 13:, :]
    e_ms = cuda_time_ms(lambda: cuda_fp.mont_mul(FR, odd, tw.limbs), 20)
    e_dev = device_ms(lambda: cuda_fp.mont_mul(FR, odd, tw.limbs), 20)
    log(f"  K1 FR last NTT stage (odd view [3, 1, 2^13] x twiddles [2^13]) through "
        f"cuda_fp.mont_mul, copies included: per call {e_ms:.4f} ms, device {e_dev:.4f} ms")
    results["mont_mul"] = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                               bound_ms=b_ms, bound_by=b_by)


# Limb vectors that are B = 2^15 in most places (value < 2p): the Jacobian z
# of the "limbs = B" lanes carries them into the kernel's word packing.
def limbs_at_b(rng, n_limbs=26, width=15):
    top = 1 if rng.random() < 0.5 else 2
    return [1 << width if rng.random() < 0.7 else rng.randrange(1 << width)
            for _ in range(n_limbs - 1)] + [top]


def case_points(g2, device, n_lanes=1003, seed=5):
    """Point-add case lanes with their expected sums from ``spec.curves``.

    Lanes 0-5: generic, p == q, q == -p, p at inf, q at inf, both at inf.
    Then 8 lanes each of: generic pairs in Jacobian form (x l^2, y l^3, z l)
    with random l; the same with every coordinate stored as value + p
    (bound 2); z with limbs equal to B; p == q with z1 != z2; q == -p in
    Jacobian form.  Then a full 32-lane warp of doublings (p == q, mixed
    forms) at a multiple of 32, and generic affine pairs up to n_lanes.
    Returns (p, q, expected affine points, range of the generic tail)."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.ops.curve import SWPoint
    from zkmpc_tpu_torch.ops.fp2 import Fp2Array
    from zkmpc_tpu_torch.ops.limbs import FQ, FpArray, int_to_limbs, limbs_to_int
    from zkmpc_tpu_torch.spec import curves as SC
    rng = random.Random(seed)
    P, n = FQ.p, FQ.nlimbs
    if g2:
        gen, smul, neg, add, F = SC.G2_GEN, SC.g2_mul, SC.g2_neg, SC.g2_add, SC._Fq2Ops
        parts = lambda v: list(v)                         # noqa: E731
    else:
        gen, smul, neg, add, F = SC.G1_GEN, SC.g1_mul, SC.g1_neg, SC.g1_add, SC._FqOps
        parts = lambda v: [v]                             # noqa: E731
    base = [smul(gen, k) for k in range(1, 34)]

    def rand_l():
        return tuple(rng.randrange(1, P) for _ in range(2)) if g2 else rng.randrange(1, P)

    def l_with_b_limbs():
        """l whose Montgomery limbs are B in most places, with those limbs."""
        vecs = [limbs_at_b(rng, n) for _ in range(2 if g2 else 1)]
        ls = [limbs_to_int(v) * FQ.rinv % P for v in vecs]
        assert all(0 < limbs_to_int(v) < 2 * P and l for v, l in zip(vecs, ls))
        return (tuple(ls) if g2 else ls[0]), vecs

    def encode(pt, lam=None, plus_p=False, z_limbs=None):
        """Limb rows [x parts, y parts, z parts] of pt in Jacobian form."""
        if pt is None:                  # coordinates of G, z = 1
            pt, lam = base[0], None
        x, y = pt
        lam = F.one if lam is None else lam
        l2 = F.mul(lam, lam)
        coords = (F.mul(x, l2), F.mul(y, F.mul(l2, lam)), lam)
        rows = []
        for ci, v in enumerate(coords):
            for k, c in enumerate(parts(v)):
                if ci == 2 and z_limbs is not None:
                    rows.append(np.asarray(z_limbs[k], dtype=np.int64))
                    continue
                m = c * FQ.R % P + (P if plus_p else 0)
                rows.append(int_to_limbs(m, n))
        return rows

    lanes = []                      # (p affine, q affine, p rows, q rows)

    def lane(pa, qa, pe=None, qe=None):
        lanes.append((pa, qa, encode(pa, **(pe or {})), encode(qa, **(qe or {}))))

    def any_form():
        form = rng.randrange(3)
        if form == 2:
            lam, vecs = l_with_b_limbs()
            return dict(lam=lam, z_limbs=vecs, plus_p=rng.random() < 0.5)
        return dict(lam=rand_l(), plus_p=form == 1)

    for a, b in ((base[1], base[8]), (base[4], base[4]), (base[6], neg(base[6])),
                 (None, base[22]), (base[12], None), (None, None)):
        lane(a, b)
    for _ in range(8):
        a, b = base[rng.randrange(33)], base[rng.randrange(33)]
        if a == b:
            b = base[(base.index(a) + 1) % 33]
        lane(a, b, dict(lam=rand_l()), dict(lam=rand_l()))
    for i in range(8):
        a, b = base[(3 * i) % 33], base[(3 * i + 5) % 33]
        lane(a, b, dict(lam=rand_l(), plus_p=True), dict(lam=rand_l(), plus_p=True))
    for i in range(8):
        a, b = base[(5 * i + 1) % 33], base[(5 * i + 8) % 33]
        (la, va), (lb, vb) = l_with_b_limbs(), l_with_b_limbs()
        lane(a, b, dict(lam=la, z_limbs=va), dict(lam=lb, z_limbs=vb, plus_p=i % 2 == 1))
    for i in range(8):
        a = base[(7 * i + 2) % 33]
        lane(a, a, dict(lam=rand_l(), plus_p=i % 2 == 0), dict(lam=rand_l()))
    for i in range(8):
        a = base[(11 * i + 4) % 33]
        lane(a, neg(a), dict(lam=rand_l()), dict(lam=rand_l(), plus_p=i % 2 == 0))
    while len(lanes) % 32:
        lane(base[len(lanes) % 33], base[(len(lanes) + 3) % 33])
    for i in range(32):
        a = base[(13 * i + 6) % 33]
        lane(a, a, any_form(), any_form())
    tail = len(lanes)
    while len(lanes) < n_lanes:
        i = len(lanes)
        ia, ib = (2 + i) % 29, (7 * i + 3) % 31
        lane(base[ia], base[ib if ib != ia else ib + 1])

    def point(rows, inf):
        cols = [FpArray(torch.as_tensor(np.stack([r[k] for r in rows])).to(device), FQ, 2)
                for k in range(len(rows[0]))]
        if g2:
            x, y, z = (Fp2Array(cols[2 * c], cols[2 * c + 1]) for c in range(3))
        else:
            x, y, z = cols
        return SWPoint(x, y, z, torch.tensor(inf, dtype=torch.bool, device=device))

    p = point([ln[2] for ln in lanes], [ln[0] is None for ln in lanes])
    q = point([ln[3] for ln in lanes], [ln[1] is None for ln in lanes])
    exp = [add(a, b) for a, b, _, _ in lanes]
    return p, q, exp, (tail, len(lanes))


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


# FQ products a lane of the complete add: add-2007-bl is 11 M + 5 S; over
# Fq2 a Karatsuba M is 3 FQ products and a square 2
POINT_ADD_PRODUCTS = {"point_add_g1": 16, "point_add_g2": 11 * 3 + 5 * 2}
# lanes of the timed point-add launch: the Pippenger lane count of the slice
TIMED_LANES = 32768


def phase_point_add(results):
    import torch
    from zkmpc_tpu_torch.ops import cuda_point
    from zkmpc_tpu_torch.ops.limbs import FQ
    dev = torch.device(DEVICE)
    for g2, name in ((False, "point_add_g1"), (True, "point_add_g2")):
        p, q, exp, (lo, hi) = case_points(g2, dev)
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
        # timing at the Pippenger lane count of the slice, on generic finite
        # pairs: every lane runs the whole add.  The timed launch is checked
        # first, lane by lane, against the spec.curves sums its lanes repeat.
        idx = lo + torch.arange(TIMED_LANES, device=dev) % (hi - lo)
        pl = p.map(lambda t: t.index_select(0, idx))
        ql = q.map(lambda t: t.index_select(0, idx))
        gl = cuda_point.sw_add_complete_cuda(pl, ql).to_affine_ints()
        el = [exp[lo + i % (hi - lo)] for i in range(TIMED_LANES)]
        err = max(err, _affine_err(gl, el))
        if err != 0:
            bad = [i for i, (x, y) in enumerate(zip(gl, el)) if x != y][:5]
            raise AssertionError(f"{name}: {TIMED_LANES} lanes differ from spec.curves "
                                 f"at lanes {bad}")
        k_ms = device_ms(lambda: cuda_point.sw_add_complete_cuda(pl, ql), 10,
                         "point_add_kernel")
        c_ms = cuda_time_ms(lambda: cuda_point.sw_add_complete_cuda(pl, ql), 10)
        p_ms = device_ms(lambda: cuda_point.sw_add_complete_plain(pl, ql), 3)
        nc = 6 if g2 else 3                    # coordinate parts of a point
        lane_bytes = 3 * nc * FQ.nlimbs * 8 + 3          # P, Q in, sum out; flags
        b_ms, b_by = bound(TIMED_LANES * lane_bytes, TIMED_LANES * POINT_ADD_PRODUCTS[name] *
                           mont_imads(FQ.p.bit_length()))
        results[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by)
        log(f"phase 3 {name} vs plain and spec: {len(exp)} lanes (all cases) "
            f"identical, max_abs_err {err}; {TIMED_LANES} generic lanes identical to "
            f"spec.curves: device {k_ms:.4f} ms, per call {c_ms:.4f} ms, "
            f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")


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
    bad = sorted(m for m in sys.modules if m in ("jax", "zkmpc_tpu")
                 or m.startswith(("jax.", "jaxlib", "zkmpc_tpu.")))
    if bad:
        raise AssertionError(f"the run imported JAX or the JAX package: {bad[:5]}")
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
