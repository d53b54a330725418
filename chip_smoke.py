#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the hand-written CUDA kernels from ``zkmpc_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the port's
main paths, the collaborative Groth16 prove at 3 parties on the stacked
transport, each with device setup, two proves on different share inputs
and randomness, pairing verification of both and rejection of a wrong
instance: the wide-mul circuit at 16,381 gates (domain 2^14, phase 4), and
the PedersenComCircuit at 253 message and 253 randomness bits (the
reference's headline circuit, domain 2^12, phase 5), synthesized through
the MPC bit protocols and the in-circuit Pedersen commitment.  It also
re-proves the committed 4-gate fixture with the JAX package's key and
shares and requires that package's proof.  Phase 6 runs the `main` binary
(`zkmpc_tpu_torch/cli/main.py`) at 1,024 slots: SHE/SPDZ preprocessing
(keys, initialize with ZKPoPKs, pair, triple; K1 at 51 limbs) feeding the
committed-input circuit's prove, its parsed proof blob verified and a
wrong instance rejected; then checked triple batches timed at 1,024 and
8,192 slots.  Phase 7 runs the same binary on the SPDZ backend
(``--backend spdz``): MACs on every field and group share, both MAC
checks passed with residues in their queues; then a tampered field share
and a tampered group share must fail their checks on the card, and a
MAC'd plus a MAC-less group share must raise, and so must two tampered
group shares whose errors cancel, and field and group errors weighted to
cancel under the rhos the public seed would predict (the checks' rhos come
from the parties' coin toss).  Phase 8 runs the binary's Marlin branch
(``main marlin``, a universal KZG setup, the holographic index and the
collaborative Marlin prove) semi-honest and on SPDZ, then the online
binary (`zkmpc_tpu_torch/cli/online.py`) over their online_setup.json
files, proving MyCircuit with Marlin and with Groth16.  Phase 9 plays the
werewolf game at 3 players (`zkmpc_tpu_torch/cli/werewolf_game.py`): its
six modes with Groth16 (SHE preprocessing at 1,024 slots, 251-bit ElGamal
randomness), ``vote`` and ``role_assignment`` with Marlin under one
universal SRS, KeyPublicizeCircuit(3) and DivinationCircuit(3) at the
reference's parameters proved with Groth16, and a scripted CLI game with
proofs (`werewolf_cli.run_scripted`).  Phase 10 runs the online binary in
socket mode over phase 8's files: three OS processes on the card, one a
party (``python -m zkmpc_tpu_torch.cli.online ... --id i --addrs F``)
over the native TCP mesh, with Marlin and with Groth16; each must verify,
and the three proofs must equal each other; the Marlin processes take
phase 8's private seeds and must give its stacked proof, the Groth16
processes draw their private seeds from their own entropy.  Phase 11
drives the last single-device modules: multiplicative shares, shared
bytes, a byte circuit proved with Groth16, modulus conversion, the
Edwards ops and `te_msm`, and the SW tree reduction, under the timer.
Phase 12 runs the party-axis mesh: three ranks (OS processes) of a
torch.distributed group on the one card, over gloo (`parallel.mesh`),
prove phase 4's circuit with their own private seeds and must give the
stacked proof under the same seeds; then bit decompositions, comparisons,
private draws and the JAX package's two mesh protocols, whose opened
values and rows must equal the stacked run's.  Phase 13 runs the chips
axis: 3 parties x 2 chips, six ranks on the one card over gloo, each
party's MSMs split across its two chip ranks (`parallel.sharded`); every
rank proves phase 12's circuit with phase 12's key, inputs and seeds and
must give its stacked proof, every MSM call must have gathered over the
chips group, and the four-step NTT over the chips must equal each rank's
own NTT.

    python3 chip_smoke.py              # needs one CUDA card
    python3 chip_smoke.py --gates 64   # a quicker main-path run

Exits nonzero, printing no result, when any phase fails or no CUDA card is
present.  The line before the last is a JSON object of per-kernel results;
the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
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
    of them.  Unlike `cuda_time_ms`, no host time between launches counts.
    Fails if the profiler records no device event (after the retries of
    `tools/profile_prove.device_events`) or none of that name."""
    import torch
    fn()
    torch.cuda.synchronize()
    _, evs = _load_script("tools", "profile_prove.py").device_events(
        lambda: [fn() for _ in range(reps)])
    us = sum(t for name, t in evs if match is None or match in name)
    if us <= 0:
        raise AssertionError(f"the profiler recorded no device time for {match}; it "
                             f"recorded {sorted({n[:60] for n, _ in evs})[:4]}")
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
        """K1 through the wrapper: exactly one launch, counted at its width,
        and no operand copy."""
        K.reset_launches()
        got = cuda_fp.mont_mul(spec, a, b)
        torch.cuda.synchronize()
        if dict(K.LAUNCHES) != {"mont_mul": 1, f"mont_mul_n{spec.nlimbs}": 1}:
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
    # the BGV shape of phase 6: [3, 1024] products of 51 limbs (MNT4Q, the
    # SHE ciphertext ring)
    _, a = _rand_fp(MNT4Q, 3 << 10, rng, dev)
    a = a.reshape((3, 1 << 10))
    b = a + a
    k_ms = device_ms(lambda: cuda_fp.mont_mul_cuda(MNT4Q, b.limbs, a.limbs), 20,
                     "mont_mul_kernel")
    c_ms = cuda_time_ms(lambda: cuda_fp.mont_mul_cuda(MNT4Q, b.limbs, a.limbs), 20)
    p_ms = device_ms(lambda: cuda_fp.mont_mul_plain(MNT4Q, b.limbs, a.limbs), 5)
    n = 3 << 10
    b_ms, b_by = bound(3 * n * MNT4Q.nlimbs * 8, n * mont_imads(MNT4Q.p.bit_length()))
    log(f"  K1 MNT4Q [3, 1024] x 51 limbs (the BGV shape of phase 6): device {k_ms:.4f} ms, "
        f"per call {c_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")


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


@functools.lru_cache(maxsize=None)
def _load_script(*parts):
    """A script of the repository (not a package module) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(parts[-1][:-3], os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_fixture():
    """The committed 4-gate prove of the JAX package, re-run on the card."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.snark import driver, groth16
    mk = _load_script("tests", "fixtures", "make_torch_slice_fixture.py")
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


def _reshare(limbs, masks):
    """Party 0 holds value - sum(masks), party i holds mask i (the dealt
    shares of `snark.driver` put the whole value on party 0).  limbs:
    [P, *shape, nlimbs] shares; masks: FpArray [P-1, *shape]."""
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    x = FpArray(limbs, FR, 2)
    total = masks[0]
    for i in range(1, masks.shape[0]):
        total = total + masks[i]
    first = (x[0] - total).tighten()
    return FpArray.concat([first.reshape((1,) + first.shape), masks.tighten()], 0).limbs


def _masks(rng, n_parties, shape, device):
    """Fresh random masks FpArray [P-1, *shape] from a numpy generator."""
    import numpy as np
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    n = (n_parties - 1) * int(np.prod(shape, dtype=np.int64))
    ints = np.asarray([int(x) for x in rng.integers(1, 2**62, n)], dtype=object)
    return FpArray.from_int(FR, ints.reshape((n_parties - 1,) + tuple(shape)), device=device)


def _prove_twice(what, step, calls, vk, inst, wrong_inst):
    """Two proves, one on each of ``calls`` (pairs of step arguments and
    keyword arguments), each timed on the host clock up to a synchronize and
    its kernel launches counted.  Both proofs must verify and differ, a
    wrong instance must be rejected, and each prove must launch every
    kernel.  Returns (seconds per prove, launches per prove)."""
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.snark import driver, groth16
    proofs, times, per_prove = [], [], []
    for args, kwargs in calls:
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.time()
        outs = step(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        per_prove.append({k: v - before.get(k, 0) for k, v in K.LAUNCHES.items()})
        proofs.append(driver.proof_arrays_to_ints(outs))
    for i, proof in enumerate(proofs):
        if any(pt is None for pt in proof):
            raise AssertionError(f"{what} prove {i + 1}: a proof point is at infinity")
        if not groth16.verify(vk, inst, proof):
            raise AssertionError(f"{what} prove {i + 1}: the proof does not verify")
    if proofs[0] == proofs[1]:
        raise AssertionError(f"{what}: two proves on different inputs gave the same proof")
    if groth16.verify(vk, wrong_inst, proofs[0]):
        raise AssertionError(f"{what}: a wrong instance verified")
    for name in KERNELS:
        if min(p.get(name, 0) for p in per_prove) <= 0:
            raise AssertionError(f"{what}: a prove never launched {name}")
    return times, per_prove


def phase_slice(n_gates, n_parties=3):
    """The main path: setup and two proves, with the kernel counts reset
    just before and read just after."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.snark import driver
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
    args2 = (_reshare(a_l, _masks(rng, n_parties, (n_gates,), dev)),
             _reshare(b_l, _masks(rng, n_parties, (n_gates,), dev)),
             torch.Generator().manual_seed(8))
    pk = dpk.pk
    log(f"phase 4 setup: {n_gates} gates, {pk.num_constraints} constraints, "
        f"domain {pk.domain_n}, m = {pk.num_instance + pk.num_witness}: {t_setup:.2f} s")
    inst = driver.expected_instance(n_gates)
    times, per_prove = _prove_twice("phase 4", step, [(args, {}), (args2, {})], pk.vk,
                                    inst, [inst[0], (inst[1] + 1) % FR.p])
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4 prove 1: {times[0]:.2f} s, prove 2: {times[1]:.2f} s; both verify, "
        f"wrong instance rejected; peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    log(f"phase 4 launches: setup {setup_launches}; prove 1 {per_prove[0]}; "
        f"prove 2 {per_prove[1]}; main path {launches}")
    return launches, dpk


def phase_pedersen(n_parties=3):
    """The PedersenComCircuit at 253 message and 253 randomness bits:
    synthesis through the port's MPC and setup, two proves on different
    re-sharings and randomness, verification of both and rejection of a
    wrong commitment, with the kernel counts reset just before and read
    just after; then one warm prove and one warm synthesis (its MPC part)
    under the profiler, and the synthesis alone on the host clock."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    from zkmpc_tpu_torch.snark import driver, groth16
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.time()
    cs = driver.synthesize_pedersen_cs(n_parties, device=dev)
    torch.cuda.synchronize()
    t_synth = time.time() - t0
    dpk = groth16.device_setup(cs, seed=1, device=dev)
    step, args = driver.make_pedersen_prove_fn(dpk, n_parties)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    setup_launches = dict(K.LAUNCHES)

    # the second input: m and the bits of r re-shared with fresh masks
    rng = np.random.default_rng(12)
    m_l, r_l, _ = args
    args2 = (_reshare(m_l, _masks(rng, n_parties, (), dev)),
             _reshare(r_l, _masks(rng, n_parties, (driver.PED_NBITS,), dev)),
             torch.Generator().manual_seed(12))
    pk = dpk.pk
    log(f"phase 5 PedersenComCircuit ({driver.PED_NBITS}+{driver.PED_NBITS} bits, "
        f"{n_parties} parties): {pk.num_constraints} constraints, domain {pk.domain_n}, "
        f"m = {pk.num_instance + pk.num_witness} variables; synthesis {t_synth:.2f} s, "
        f"setup in all {t_setup:.2f} s")
    inst = driver.expected_pedersen_instance()
    if cs.instance_ints() != inst:
        raise AssertionError("the synthesized instance is not the commitment")
    transports = [StackedTransport(n_parties, dev) for _ in range(2)]
    times, per_prove = _prove_twice(
        "phase 5", step, [(a, {"transport": t}) for a, t in zip((args, args2), transports)],
        pk.vk, inst, [inst[0], (inst[1] + 1) % FR.p, inst[2]])
    rounds = [t.stats.rounds for t in transports]
    if min(rounds) <= 0:
        raise AssertionError(f"phase 5: a prove opened nothing on its transport ({rounds})")
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 5 prove 1: {times[0]:.2f} s, prove 2: {times[1]:.2f} s; both verify, "
        f"wrong commitment rejected; peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    log(f"phase 5 launches: setup {setup_launches}; prove 1 {per_prove[0]}, "
        f"{rounds[0]} openings; prove 2 {per_prove[1]}, {rounds[1]} openings; "
        f"main path {launches}")
    tool = _load_script("tools", "profile_prove.py")

    def profiled(what, fn):
        wall, groups, other = tool.profile_call(fn)
        groups["PyTorch kernels"] = [sum(v[0] for v in other.values()),
                                     sum(v[1] for v in other.values())]
        busy = sum(v[0] for v in groups.values())
        log(f"phase 5 profiled {what}: {wall:.3f} s, device busy {busy:.1f} ms "
            f"({busy / (wall * 1e3):.1%}); " + "; ".join(
                f"{k} {v[0]:.1f} ms over {v[1]} launches" for k, v in sorted(groups.items())))

    profiled("warm prove", lambda: step(*args))
    # the MPC witness synthesis alone, the part of a prove before groth16.prove
    t1 = time.time()
    driver.synthesize_pedersen_cs(n_parties, device=dev)
    torch.cuda.synchronize()
    log(f"phase 5 warm synthesis alone: {time.time() - t1:.2f} s")
    profiled("warm synthesis", lambda: driver.synthesize_pedersen_cs(n_parties, device=dev))
    return launches


def check_triples(alpha, batch, sample=64):
    """One `triple_kernel` batch: a*b = c in every slot (opened, compared
    on the card) and mac = alpha*value on `sample` slots (host ints)."""
    import torch
    from zkmpc_tpu_torch.mpc.share import _sum_axis0
    from zkmpc_tpu_torch.ops.limbs import FR
    a, ma, b, mb, c, mc = batch
    va, vb, vc = (_sum_axis0(x) for x in (a, b, c))
    if not bool(torch.equal((va * vb).canon_limbs(), vc.canon_limbs())):
        raise AssertionError("a preprocessing triple has a*b != c")
    n = va.shape[0]
    idx = torch.linspace(0, n - 1, min(sample, n), device=va.limbs.device).long()
    for v, m in ((va, ma), (vb, mb), (vc, mc)):
        vals = v[idx].to_ints().tolist()
        macs = _sum_axis0(m)[idx].to_ints().tolist()
        if macs != [alpha * x % FR.p for x in vals]:
            raise AssertionError("a preprocessing MAC is not alpha * value")
    return n


def phase_main(slots=1024, n_parties=3, rate_slots=(1024, 8192)):
    """Phase 6: the port's `main` binary, `cli.main.run("groth16",
    inputs/inputs-template.json)` at `slots` slots and `n_parties` parties
    on the card (SHE preprocessing with ZKPoPKs, the committed-input
    circuit proved on SHE triples, the ark blob verified, a wrong instance
    rejected, the parties' files read back), with the kernel counts reset
    just before and read just after; then warm `triple_kernel` rates at
    `rate_slots` and at the online source's batch, every triple checked,
    and one triple batch under the profiler.  (K1's own time at the BGV
    shape is phase 2's.)"""
    import tempfile

    import torch
    from zkmpc_tpu_torch.cli import main as CLI
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.she import bgv
    from zkmpc_tpu_torch.she import preprocessing as PP
    from zkmpc_tpu_torch.utils import serialize as SER
    dev = torch.device(DEVICE)
    inputs = os.path.join(ROOT, "inputs", "inputs-template.json")
    report = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        ok = CLI.run("groth16", inputs, n_parties=n_parties, outdir=out, slots=slots,
                     device=dev, report=report)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        files = []
        for i in range(n_parties):
            path = os.path.join(out, str(i), "online_setup.json")
            party, r, mac = SER.read_online_setup(path)
            beta, br = SER.read_online_setup_bracket(path)
            if party != i or len(r) != slots or len(mac) != slots or len(br) != n_parties \
                    or beta is None:
                raise AssertionError(f"phase 6: party {i}'s online_setup.json is incomplete")
            files.append(path)
        with open(os.path.join(out, "proof.bin"), "rb") as f:
            if len(f.read()) != 192:
                raise AssertionError("phase 6: the proof blob is not 192 bytes")
    if not (ok and report["verified"] and report["wrong_instance_rejected"]):
        raise AssertionError(f"phase 6: verification failed ({report})")
    if report["prove_openings"] <= 0 or report["synthesis_openings"] <= 0:
        raise AssertionError("phase 6: the synthesis or the prove opened nothing")
    if min(report["synthesis_served"]["triple"], report["prove_served"]["triple"]) <= 0:
        raise AssertionError("phase 6: the synthesis or the prove took no preprocessed triple")
    if launches.get("mont_mul_n51", 0) <= 0:
        raise AssertionError(f"phase 6: K1 never ran at 51 limbs ({launches})")
    log(f"phase 6 main ({slots} slots, {n_parties} parties): preprocessing make_dealer "
        f"{report['make_dealer_s']:.3f} s, initialize {report['initialize_s']:.3f} s "
        f"(ZKPoPKs accepted), pair {report['pair_s']:.3f} s, triple {report['triple_s']:.3f} s "
        f"(a*b = c in all {slots} slots)")
    log(f"phase 6 prove: {report['constraints']} constraints, {report['variables']} "
        f"variables; synthesis {report['synthesis_s']:.2f} s "
        f"({report['synthesis_openings']} openings; preprocessing batches run "
        f"{report['synthesis_batches']}, slots served {report['synthesis_served']}), setup "
        f"{report['setup_s']:.2f} s, prove {report['prove_s']:.2f} s "
        f"({report['prove_openings']} openings; batches run {report['prove_batches']}, slots "
        f"served {report['prove_served']}); wall-clock in all {wall:.2f} s; peak device memory "
        f"{peak} B ({peak / 2**30:.2f} GiB)")
    log(f"phase 6 source: triple batches of {report['triple_batch_slots']} slots "
        f"({report['triple_batch_slots'] // slots} ciphertexts of {slots}); "
        f"batches run in all {report['batches']}")
    log(f"phase 6 verification: the parsed ark blob verifies, a wrong instance is rejected, "
        f"instance {report['instance'][:1]} + commitment; {len(files)} online_setup.json "
        f"files written and read back")
    log(f"phase 6 launches: {launches}; K1 by width: " + ", ".join(
        f"{k[len('mont_mul_'):]} {v}" for k, v in sorted(launches.items())
        if k.startswith("mont_mul_n")))

    # warm triple rates, each batch checked: one ciphertext at each of
    # `rate_slots`, then the online source's batch (`report["triple_batch_slots"]`
    # slots as ciphertexts of `slots` slots)
    dealers = {}
    cts_source = report["triple_batch_slots"] // slots
    for n_slots, cts in [(n, 1) for n in rate_slots] + [(slots, cts_source)]:
        gen = torch.Generator(dev).manual_seed(n_slots + cts)
        if n_slots not in dealers:
            t1 = time.time()
            ctx = PP.make_dealer(bgv.SheParams(n_slots), n_parties, gen, device=dev)
            PP.initialize(ctx, gen)
            torch.cuda.synchronize()
            dealers[n_slots] = (ctx, time.time() - t1)
        ctx, t_init = dealers[n_slots]
        alpha = sum(ctx.alpha_shares.to_ints().tolist()) % FR.p
        check_triples(alpha, PP.triple_kernel(ctx, gen, cts))       # warm-up, checked
        reps = 3
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.time()
            batch = PP.triple_kernel(ctx, gen, cts)
            torch.cuda.synchronize()
            times.append(time.time() - t1)
            check_triples(alpha, batch)
        best, total = min(times), n_slots * cts
        log(f"phase 6 triples, {cts} ciphertext(s) of {n_slots} slots: make_dealer + "
            f"initialize {t_init:.3f} s; warm triple_kernel {', '.join(f'{x:.4f}' for x in times)}"
            f" s: {total / best:.0f} triples/s at the best, {total * reps / sum(times):.0f} on "
            f"average; a*b = c in every slot, mac = alpha*value on 64 slots")
        if (n_slots, cts) == (slots, 1):
            tool = _load_script("tools", "profile_prove.py")
            wall_p, ours, other = tool.profile_call(lambda: PP.triple_kernel(ctx, gen))
            for name, (ms_, cnt) in sorted(ours.items()):
                log(f"  profiled triple batch: {name} {ms_:.2f} ms over {cnt} launches")
            busy = sum(v[0] for v in ours.values()) + sum(v[0] for v in other.values())
            log(f"phase 6 profiled triple batch ({n_slots} slots): {wall_p:.3f} s, device "
                f"busy {busy:.1f} ms ({busy / (wall_p * 1e3):.1%}); PyTorch kernels "
                f"{sum(v[0] for v in other.values()):.1f} ms over "
                f"{sum(v[1] for v in other.values())} launches")
    return launches, report


PHASE_TIMES = ("make_dealer_s", "initialize_s", "pair_s", "triple_s", "synthesis_s",
               "setup_s", "prove_s")


def phase_spdz(semi, slots=1024, n_parties=3):
    """Phase 7: the `main` binary on the SPDZ backend, `cli.main.run(
    "groth16", inputs/inputs-template.json, backend="spdz")` at `slots`
    slots and `n_parties` parties on the card, with the kernel counts reset
    just before and read just after: every field and group share carries
    MAC shares under the preprocessed key, and after the prove the field
    and group MAC checks must pass with residues in both queues; the
    parsed proof blob verifies and a wrong instance is rejected.  Then, on
    the card, a share that party 1 tampers with must fail its check, and a
    MAC'd plus a MAC-less group share must raise.  ``semi``: phase 6's
    report, whose phase times are logged beside these."""
    import tempfile

    import torch
    from zkmpc_tpu_torch.cli import main as CLI
    from zkmpc_tpu_torch.ops import build as K
    dev = torch.device(DEVICE)
    inputs = os.path.join(ROOT, "inputs", "inputs-template.json")
    report = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        ok = CLI.run("groth16", inputs, n_parties=n_parties, outdir=out, slots=slots,
                     backend="spdz", device=dev, report=report)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "proof.bin"), "rb") as f:
            if len(f.read()) != 192:
                raise AssertionError("phase 7: the proof blob is not 192 bytes")
    if not (ok and report["verified"] and report["wrong_instance_rejected"]):
        raise AssertionError(f"phase 7: verification failed ({report})")
    if min(report.get("field_mac_residues", 0), report.get("group_mac_residues", 0)) <= 0 \
            or "mac_check_s" not in report:
        raise AssertionError(f"phase 7: a MAC queue was empty or unchecked ({report})")
    missing = [k for k in ("mont_mul_n51", "point_add_g1", "point_add_g2")
               if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 7: {missing} never launched ({launches})")
    log(f"phase 7 main --backend spdz ({slots} slots, {n_parties} parties): the parsed ark "
        f"blob verifies, a wrong instance is rejected; field MAC check over "
        f"{report['field_mac_residues']} openings and group MAC check over "
        f"{report['group_mac_residues']} openings passed in {report['mac_check_s']:.2f} s")
    log("phase 7 times, spdz (phase 6 semi): " + ", ".join(
        f"{k[:-2]} {report[k]:.3f} s ({semi[k]:.3f} s)" for k in PHASE_TIMES)
        + f"; wall-clock in all {wall:.2f} s")
    log(f"phase 7 source: batches run in synthesis {report['synthesis_batches']}, in the "
        f"prove {report['prove_batches']}; slots served in synthesis "
        f"{report['synthesis_served']}, in the prove {report['prove_served']}; openings "
        f"{report['synthesis_openings']} + {report['prove_openings']} (semi "
        f"{semi['synthesis_openings']} + {semi['prove_openings']}); {report['constraints']} "
        f"constraints")
    log(f"phase 7 launches: {launches}; K1 by width: " + ", ".join(
        f"{k[len('mont_mul_'):]} {v}" for k, v in sorted(launches.items())
        if k.startswith("mont_mul_n")) + f"; peak device memory {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    spdz_faults_caught(dev, n_parties)
    time_bit_rand_sqrt(dev, n_parties)
    return launches


def time_bit_rand_sqrt(dev, n_parties=3, shape=(16, 253)):
    """The SPDZ bits' cost on the card: one warm `bit_rand_sqrt` batch at
    the committed-input circuit's shape (16 candidates x 253 bits), its
    <r> dealt and its triple the dummy source's so that only the protocol
    runs, timed to a synchronize, its launches counted; the bits must open
    to 0/1 and the MAC check pass.  `sqrt_public` alone at that shape too."""
    import torch
    from zkmpc_tpu_torch.mpc import bits as B
    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.mpc.share import DummyTripleSource, MpcContext, mpc_scope
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.parallel.transport import StackedTransport

    gen = torch.Generator(dev).manual_seed(78)
    ctx = MpcContext(StackedTransport(n_parties, dev), "spdz", DummyTripleSource(gen),
                     alpha_share=R.uniform_fp(gen, FR, (n_parties,), device=dev))
    with mpc_scope(ctx):
        B.bit_rand_sqrt(gen, FR, shape)                        # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.time()
        bits = B.bit_rand_sqrt(gen, FR, shape)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        opened = bits.reveal()
        if not bool((opened.is_zero() | opened.equals(1)).all()) or \
                not ctx.assert_field_macs(True):
            raise AssertionError("phase 7: bit_rand_sqrt gave a non-bit or failed its MACs")
        squares = R.uniform_fp(gen, FR, (n_parties,) + shape, device=dev).square()
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.time()
        B.sqrt_public(squares)
        torch.cuda.synchronize()
        wall_sqrt = time.time() - t0
        sqrt_launches = K.LAUNCHES.get("mont_mul", 0)
    n = n_parties * shape[0] * shape[1]
    log(f"phase 7 bit_rand_sqrt, one warm batch of {shape[0]} x {shape[1]} bits x "
        f"{n_parties} parties: {wall:.3f} s, K1 launches {launches.get('mont_mul', 0)}; "
        f"sqrt_public alone on [{n}] squares: {wall_sqrt:.3f} s, {sqrt_launches} K1 "
        f"launches; every bit opens to 0 or 1, MACs checked")


def spdz_faults_caught(dev, n_parties=3):
    """On the card: honest field and group openings pass their MAC checks;
    party 1 adding 1 to a field share (its MAC share kept) fails the field
    check; party 1 adding G to a group share fails the group check, and so
    does party 1 adding G to one point and -G to another of one opening; a
    MAC'd plus a MAC-less group share raises ValueError."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.mpc import group as G
    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.mpc.share import SHARED, MpcContext, MpcFp, king_share, mpc_scope
    from zkmpc_tpu_torch.ops.curve import SWPoint, sw_add_complete
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.ops.msm import _bcast_sw
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    from zkmpc_tpu_torch.spec import curves as SC

    gen = torch.Generator(dev).manual_seed(77)
    ctx = MpcContext(StackedTransport(n_parties, dev), "spdz",
                     alpha_share=R.uniform_fp(gen, FR, (n_parties,), device=dev))
    party1 = torch.arange(n_parties, device=dev) == 1

    def fails(check, what):
        try:
            check(require_nonempty=True)
        except AssertionError:
            return
        raise AssertionError(f"phase 7: {what} passed its MAC check")
    with mpc_scope(ctx):
        x = king_share(FpArray.from_int(FR, np.asarray([5], dtype=object), device=dev), gen)
        one = FpArray.from_int(FR, np.asarray([[int(b)] for b in party1.tolist()],
                                              dtype=object), device=dev)
        if x.reveal().to_ints()[0].tolist() != [5] or not ctx.assert_field_macs(True):
            raise AssertionError("phase 7: an honest field opening failed")
        if MpcFp(x.value + one, SHARED, x.mac).reveal().to_ints()[0].tolist() != [6]:
            raise AssertionError("phase 7: the tampered field share did not open to 6")
        fails(ctx.assert_field_macs, "a tampered field share")
        g = SWPoint.g1_from_affine_ints([SC.G1_GEN], dev)[0]
        pt = G.with_mac_from_public(g)
        pt.reveal()
        if not ctx.assert_group_macs(True):
            raise AssertionError("phase 7: an honest group opening failed")
        bumped = sw_add_complete(pt.point, _bcast_sw(g, pt.point.shape))
        G.MpcSWPoint(SWPoint.select(party1, bumped, pt.point), SHARED, pt.mac).reveal()
        fails(ctx.assert_group_macs, "a tampered group share")
        # +G on one point and -G on another of one opening: the plain sum of
        # the opened points is the honest one, the weighted check is not
        pair = G.with_mac_from_public(SWPoint.g1_from_affine_ints(
            [SC.G1_GEN, SC.g1_mul(SC.G1_GEN, 2)], dev))                     # [P, 2]
        gg = SWPoint.g1_from_affine_ints([SC.G1_GEN, SC.g1_neg(SC.G1_GEN)], dev)
        moved = sw_add_complete(pair.point, _bcast_sw(gg, pair.point.shape))
        opened = G.MpcSWPoint(SWPoint.select(party1.reshape(-1, 1).expand(-1, 2), moved,
                                             pair.point), SHARED, pair.mac).reveal()
        if opened[0].to_affine_ints() != [SC.g1_mul(SC.G1_GEN, 2), SC.G1_GEN]:
            raise AssertionError("phase 7: the cancelling tamper did not open to (2G, G)")
        fails(ctx.assert_group_macs, "+G and -G on two shares of one opening")
        seed_predicted_tamper(dev, n_parties, ctx, fails)
        try:
            pt + G.MpcSWPoint(pt.point, SHARED)
        except ValueError:
            pass
        else:
            raise AssertionError("phase 7: a MAC'd plus a MAC-less group share did not raise")
    log("phase 7 faults on the card: honest field and group openings pass; party 1's "
        "+1 on a field share, +G on a group share, +G and -G on two group shares of "
        "one opening (errors that cancel in a plain sum), and field and group errors "
        "weighted to cancel under the rhos the public seed would predict fail their MAC "
        "checks; a MAC'd plus a MAC-less group share raises ValueError")


def seed_predicted_tamper(dev, n_parties, ctx, fails, seed=11):
    """Party 1 weights its errors to cancel under the rhos that a generator
    seeded from the public run seed, ((seed + 0x517D) << 1) | 1, draws
    first on the card: field shares of two openings get e_1 = rho_2 and
    e_2 = -rho_1; two group shares of one opening get rho_2*G and
    -rho_1*G.  Both checks draw their rhos from the parties' coin toss
    after the openings and must fail."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.mpc import group as G
    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.mpc.share import SHARED, MpcFp, king_share
    from zkmpc_tpu_torch.ops.curve import SWPoint, sw_add_complete
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.ops.msm import _bcast_sw
    from zkmpc_tpu_torch.spec import curves as SC

    def predicted(shapes):
        """The seed-derived generator's draws, one a shape, in order."""
        gen = torch.Generator(dev).manual_seed(((seed + 0x517D) << 1) | 1)
        return [[int(v) for v in R.uniform_fp(gen, FR, shape, device=dev).to_ints()]
                for shape in shapes]
    p = FR.p
    (r1,), (r2,) = predicted([(1,), (1,)])
    for k, err in enumerate((r2, -r1)):
        x = king_share(FpArray.from_int(FR, np.asarray([5 + k], dtype=object), device=dev),
                       torch.Generator(dev).manual_seed(3 + k))
        bump = FpArray.from_int(FR, np.asarray([[err % p if i == 1 else 0]
                                                for i in range(n_parties)], dtype=object),
                                device=dev)
        MpcFp(x.value + bump, SHARED, x.mac).reveal()
    fails(ctx.assert_field_macs, "field shares tampered with seed-predicted weights")
    ((g1, g2),) = predicted([(2,)])
    pts = G.with_mac_from_public(SWPoint.g1_from_affine_ints(
        [SC.G1_GEN, SC.g1_mul(SC.G1_GEN, 2)], dev))
    errs = SWPoint.g1_from_affine_ints([SC.g1_mul(SC.G1_GEN, g2), SC.g1_mul(SC.G1_GEN, -g1 % p)],
                                       dev)
    moved = sw_add_complete(pts.point, _bcast_sw(errs, pts.point.shape))
    party1 = (torch.arange(n_parties, device=dev) == 1).reshape(-1, 1).expand(-1, 2)
    G.MpcSWPoint(SWPoint.select(party1, moved, pts.point), SHARED, pts.mac).reveal()
    fails(ctx.assert_group_macs, "group shares tampered with seed-predicted weights")


def _marlin_report(what, report, launches, peak, wall):
    log(f"phase 8 {what}: SRS degree D = {report['srs_degree']}, n = {report['domain_n']}, "
        f"nx = {report['nx']}, k = {report['k']} (A, B, C); {report['constraints']} "
        f"constraints, {report['variables']} variables; synthesis {report['synthesis_s']:.2f} s, "
        f"index {report['index_s']:.2f} s, prove {report['prove_s']:.2f} s "
        f"({report['prove_openings']} openings), verify {report['verify_s']:.2f} s"
        + (f", MAC checks {report['mac_check_s']:.2f} s" if "mac_check_s" in report else "")
        + f"; wall-clock in all {wall:.2f} s; peak device memory {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    log(f"phase 8 {what} launches: K1 by width " + ", ".join(
        f"{k[len('mont_mul_'):]} {v}" for k, v in sorted(launches.items())
        if k.startswith("mont_mul_n")) + f"; K2 {launches.get('point_add_g1', 0)}, K3 "
        f"{launches.get('point_add_g2', 0)}")


def phase_marlin(out, slots=1024, n_parties=3):
    """Phase 8: the `main` binary's Marlin branch, `cli.main.run("marlin",
    inputs/inputs-template.json)` at `slots` slots and `n_parties` parties,
    semi-honest and on SPDZ (a universal KZG setup and index of the
    committed-input circuit, the collaborative prove on SHE
    preprocessing, verification and a wrong instance rejected; under
    SPDZ both MAC checks pass with residues, the G1 queue holding Marlin's
    opened commitments); then the online binary, `cli.online.run` on the
    stacked transport over those runs' online_setup.json files, the parties'
    private seeds `ONLINE_PRIVATE_SEEDS`: MyCircuit proved with Marlin over
    the semi-honest run's files and with Groth16 over the SPDZ run's, each
    verified and a wrong instance rejected.  The
    kernel counts are reset just before each run and read just after.  The
    runs' files stay in the directory ``out`` for phase 10.  Returns the
    launches and, by zksnark, the online run's setup directory and
    report."""
    import torch
    from zkmpc_tpu_torch.cli import main as CLI
    from zkmpc_tpu_torch.cli import online as ON
    from zkmpc_tpu_torch.ops import build as K
    dev = torch.device(DEVICE)
    inputs = os.path.join(ROOT, "inputs", "inputs-template.json")
    total = {}

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.time()
        ok = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return ok, launches, torch.cuda.max_memory_allocated(), wall

    dirs, online = {}, {}
    for backend in ("semi", "spdz"):
        report = {}
        dirs[backend] = os.path.join(out, backend)
        ok, launches, peak, wall = counted(lambda: CLI.run(
            "marlin", inputs, n_parties=n_parties, outdir=dirs[backend], slots=slots,
            backend=backend, device=dev, report=report))
        what = f"main marlin --backend {backend} ({slots} slots, {n_parties} parties)"
        if not (ok and report["verified"] and report["wrong_instance_rejected"]):
            raise AssertionError(f"phase 8 {what}: verification failed ({report})")
        if report["prove_openings"] <= 0 or report["prove_served"].get("triple", 0) <= 0:
            raise AssertionError(f"phase 8 {what}: the prove opened nothing or took no "
                                 f"preprocessed triple ({report})")
        if min(launches.get("mont_mul_n51", 0), launches.get("point_add_g1", 0)) <= 0:
            raise AssertionError(f"phase 8 {what}: K1 at 51 limbs or K2 never ran "
                                 f"({launches})")
        if backend == "spdz":
            if min(report["field_mac_residues"],
                   report["group_mac_residues_by_group"].get("G1", 0)) <= 0:
                raise AssertionError(f"phase 8 {what}: a MAC queue was empty ({report})")
            log(f"phase 8 {what}: field MAC check over {report['field_mac_residues']} "
                f"openings and group MAC check over {report['group_mac_residues']} "
                f"openings ({report['group_mac_residues_by_group']}; required non-empty: "
                f"{report['group_mac_groups_required']}, a Marlin prove opens no G2 "
                f"point) passed")
        log(f"phase 8 {what}: the proof verifies, a wrong instance is rejected")
        _marlin_report(what, report, launches, peak, wall)
    for zksnark, backend in (("marlin", "semi"), ("groth16", "spdz")):
        report = {}
        ok, launches, peak, wall = counted(lambda: ON.run(
            inputs, dirs[backend], n_parties, zksnark=zksnark, device=dev, report=report,
            private_seeds=ONLINE_PRIVATE_SEEDS[:n_parties]))
        what = f"online --zksnark {zksnark} (the {backend} run's online_setup.json)"
        if not (ok and report["verified"] and report["wrong_instance_rejected"]):
            raise AssertionError(f"phase 8 {what}: verification failed ({report})")
        if report["c"] != 4 * 5 or min(launches.get("mont_mul", 0),
                                       launches.get("point_add_g1", 0)) <= 0:
            raise AssertionError(f"phase 8 {what}: wrong c or no K1/K2 launch "
                                 f"({report}, {launches})")
        log(f"phase 8 {what}: c = a*b = {report['c']} opened, the proof verifies, a wrong "
            f"instance is rejected; {report['constraints']} constraints, synthesis "
            f"{report['synthesis_s']:.2f} s, setup {report['setup_s']:.2f} s, prove "
            f"{report['prove_s']:.2f} s ({report['prove_openings']} openings), verify "
            f"{report['verify_s']:.2f} s; wall-clock in all {wall:.2f} s; peak device "
            f"memory {peak} B ({peak / 2**30:.2f} GiB)"
            + (f"; SRS degree {report['srs_degree']}, n = {report['domain_n']}, nx = "
               f"{report['nx']}, k = {report['k']}" if zksnark == "marlin" else ""))
        log(f"phase 8 {what} launches: K1 by width " + ", ".join(
            f"{k[len('mont_mul_'):]} {v}" for k, v in sorted(launches.items())
            if k.startswith("mont_mul_n")) + f"; K2 {launches.get('point_add_g1', 0)}, "
            f"K3 {launches.get('point_add_g2', 0)}")
        online[zksnark] = (dirs[backend], dict(report, peak_device_bytes=peak,
                                               launches=launches))
    return total, online


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


#: the per-party seconds of an online run, in order
ONLINE_TIMES = ("input_s", "synthesis_s", "setup_s", "prove_s", "verify_s")
#: the parties' private seeds of phase 8's online runs and phase 10's
#: Marlin processes (phase 10's Groth16 processes draw their own)
ONLINE_PRIVATE_SEEDS = [int.from_bytes(bytes([101 + i]) * 32, "little") for i in range(3)]
#: the zksnarks whose phase 10 processes take phase 8's private seeds
SEEDED_ZKSNARKS = ("marlin",)


def phase_socket(online, workdir, timeout=300):
    """Phase 10: the online binary in socket mode, one OS process a party on
    the card (`python -m zkmpc_tpu_torch.cli.online ... --id i --addrs F`,
    an address file of free localhost ports), over phase 8's files and at
    its public seed: MyCircuit with Marlin over the semi-honest run's files,
    each process given its party's private seed of phase 8
    (``--private-seed``), and with Groth16 over the SPDZ run's, each
    process drawing its private seed from its own entropy.  Every process
    must exit 0 within ``timeout`` seconds, verify and reject a wrong
    instance, give the proof of the other parties and, with phase 8's
    seeds, of phase 8's stacked run (``online``: by zksnark, its setup
    directory and report), launch K1, K2 and, for Groth16, K3, and import
    nothing of JAX or the JAX package.  Each
    process counts its own launches from its start.  Logs per party the
    seconds of input, synthesis, setup, prove and verify, the openings,
    the mesh's bytes and broadcasts, peak device memory and the launches,
    beside the stacked run's."""
    from zkmpc_tpu_torch.parallel import native_net
    native_net.build()
    inputs = os.path.join(ROOT, "inputs", "inputs-template.json")
    total = {}
    for zksnark, (setup_dir, stacked) in online.items():
        n = len([d for d in os.listdir(setup_dir) if d.isdigit()])
        addrs = os.path.join(workdir, f"addrs_{zksnark}")
        with open(addrs, "w") as f:
            f.write("".join(f"127.0.0.1:{p}\n" for p in _free_ports(n)))
        reports = [os.path.join(workdir, f"socket_{zksnark}_{i}.json") for i in range(n)]
        logs = [os.path.join(workdir, f"socket_{zksnark}_{i}.log") for i in range(n)]
        t0 = time.time()
        procs = []
        seeded = zksnark in SEEDED_ZKSNARKS
        for i in range(n):
            with open(logs[i], "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "zkmpc_tpu_torch.cli.online", inputs, "--outdir",
                     setup_dir, "--id", str(i), "--addrs", addrs, "--zksnark", zksnark,
                     "--seed", "0", "--device", DEVICE, "--report", reports[i]]
                    + (["--private-seed", hex(ONLINE_PRIVATE_SEEDS[i])] if seeded else []),
                    cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT))
        try:
            rcs = [p.wait(timeout=max(1.0, t0 + timeout - time.time())) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        what = f"phase 10 online --zksnark {zksnark} over sockets ({n} processes)"
        if any(rcs):
            tails = "\n".join(f"party {i} (rc {rc}):\n" + open(logs[i]).read()[-3000:]
                              for i, rc in enumerate(rcs))
            raise AssertionError(f"{what}: a process failed\n{tails}")
        got = []
        for path in reports:
            with open(path) as f:
                got.append(json.load(f))
        want = json.loads(json.dumps(stacked["proof"])) if seeded else got[0]["proof"]
        mode = ("phase 8's private seeds" if seeded
                else "private seeds from each process's own entropy")
        for i, r in enumerate(got):
            bad = sorted(m for m in r["modules"] if m in ("jax", "jaxlib", "zkmpc_tpu"))
            if bad:
                raise AssertionError(f"{what}: party {i} imported {bad}")
            if not (r["verified"] and r["wrong_instance_rejected"]) or r["c"] != stacked["c"]:
                raise AssertionError(f"{what}: party {i} did not verify ({r})")
            if r["private_seeds"] != ("given" if seeded else "own entropy"):
                raise AssertionError(f"{what}: party {i} ran with {r['private_seeds']} seeds")
            if r["proof"] != want:
                raise AssertionError(f"{what}: party {i}'s proof differs from "
                                     + ("phase 8's stacked proof" if seeded
                                        else "party 0's"))
            need = ["mont_mul", "point_add_g1"] + (["point_add_g2"] if zksnark == "groth16"
                                                  else [])
            if min(r["launches"].get(k, 0) for k in need) <= 0:
                raise AssertionError(f"{what}: party {i} never launched one of {need} "
                                     f"({r['launches']})")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        log(f"{what}, {mode}: all exit 0 in {wall:.2f} s wall-clock; every party verifies "
            f"and rejects a wrong instance; the {n} proofs equal each other"
            + (" and phase 8's stacked proof" if seeded else "")
            + "; no process imported JAX or the JAX package")
        for i, r in enumerate(got + [stacked]):
            who = f"party {i}" if i < n else "stacked (phase 8)"
            net = r.get("net")
            log(f"phase 10 {zksnark} {who}: " + ", ".join(
                f"{k[:-2]} {r[k]:.3f} s" for k in ONLINE_TIMES)
                + f"; openings {r['openings']} (input {r['input_openings']}, synthesis "
                f"{r['synthesis_openings'] - r['input_openings']}, prove {r['prove_openings']})"
                + (f"; mesh sent {net['bytes_sent']} B, received {net['bytes_recv']} B, "
                   f"{net['broadcasts']} broadcasts" if net else "")
                + f"; peak device memory {r['peak_device_bytes']} B "
                f"({r['peak_device_bytes'] / 2**30:.2f} GiB); {_kernel_counts(r['launches'])}")
    return total


def _kernel_counts(launches):
    """K1 launches by width, K2 and K3, for a log line."""
    return ("K1 by width " + ", ".join(f"{k[len('mont_mul_'):]} {v}" for k, v in
                                       sorted(launches.items()) if k.startswith("mont_mul_n"))
            + f"; K2 {launches.get('point_add_g1', 0)}, K3 {launches.get('point_add_g2', 0)}")


def _prove_line(report, peak, launches):
    setup = (f"index {report['index_s']:.2f} s" if "index_s" in report
             else f"setup {report['setup_s']:.2f} s")
    return (f"{report['constraints']} constraints, domain {report['domain_n']}; synthesis "
            f"{report['synthesis_s']:.2f} s ({report['synthesis_openings']} openings), {setup}, "
            f"prove {report['prove_s']:.2f} s ({report['prove_openings']} openings), verify "
            f"{report['verify_s']:.2f} s; peak device memory {peak} B "
            f"({peak / 2**30:.2f} GiB); {_kernel_counts(launches)}")


#: the reference's constraint counts of the full-width werewolf circuits
#: at 3 players (`tests/test_constraint_parity.py`)
REFERENCE_COUNTS = {"KeyPublicizeCircuit(3)": 15266, "DivinationCircuit(3)": 22249}


def reference_circuit(name, dev, generator):
    """KeyPublicizeCircuit(3) or DivinationCircuit(3) at the reference's
    parameters, built as `tests/test_constraint_parity.py` builds them
    (per-input Pedersen commitment checks of 253 message and 253
    randomness bits; 251 ElGamal randomness bits) but with every wire
    dealt by the leader (`king_share`), under the ambient MPC scope."""
    import numpy as np
    from zkmpc_tpu_torch.circuits import werewolf as WC
    from zkmpc_tpu_torch.crypto import elgamal as EG
    from zkmpc_tpu_torch.crypto import pedersen as PD
    from zkmpc_tpu_torch.mpc.share import king_share
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem
    from zkmpc_tpu_torch.spec import curves as SC
    nb = FR.p.bit_length()

    def deal(vals):
        return king_share(FpArray.from_int(FR, np.asarray(vals, dtype=object), device=dev),
                          generator)

    def scalars(vals):
        x = deal(vals)
        return [x[i] for i in range(len(vals))]

    def bits(v, n=nb):
        return deal([(v >> i) & 1 for i in range(n)])
    pp = PD.PedersenParams.sample(1)
    cs = ConstraintSystem(FR)
    if name == "KeyPublicizeCircuit(3)":
        xs, ys = [5, 0, 0], [6, 0, 0]
        rs = list(range(10, 16))
        WC.key_publicize_circuit(
            cs, scalars(xs), scalars(ys), scalars([1, 0, 0]), 5, 6, pedersen_pp=pp,
            xy_randomness=[bits(r) for r in rs],
            xy_commitments=[PD.commit_public_ints(pp, v, r) for v, r in zip(xs + ys, rs)],
            generator=generator, com_nbits=None)
    else:
        keys = EG.keygen(3)
        r_int = 0x5A5A5
        c1, c2 = EG.encrypt_ints(keys.pk, SC.TE_GEN, r_int)
        flags = [0, 1, 0]
        rs = list(range(30, 36))
        WC.divination_circuit(
            cs, scalars(flags), scalars(flags), bits(r_int, 251), keys.pk, c1, c2, generator,
            pedersen_pp=pp, wire_randomness=[bits(r) for r in rs],
            wire_commitments=[PD.commit_public_ints(pp, v, r)
                              for v, r in zip(flags + flags, rs)], com_nbits=None)
    return cs


def phase_werewolf(slots=1024, n_parties=3):
    """Phase 9: the werewolf game at `n_parties` players on the stacked
    transport.  (a) The game binary's six modes with Groth16 in one fresh
    game directory: ``init`` (roles, shuffles and SHE preprocessing at
    `slots` slots), ``preprocessing``, ``role_assignment``, ``night
    --rand-bits 251 --target 1``, ``vote --votes 2,2,0`` and
    ``judgment``; every proof verifies and a wrong instance is rejected,
    the seer's decryption is the dealt role, and the vote's and judgment's
    results are what the dealt roles and the votes imply.  (b) ``vote`` and
    ``role_assignment`` under ``--zksnark marlin`` against ONE universal SRS
    file, set up by the first at the smallest degree that holds
    role_assignment.  (c) KeyPublicizeCircuit(3) and DivinationCircuit(3) at
    the reference's parameters (`reference_circuit`) proved with Groth16
    and verified, a wrong instance rejected.  Then a scripted CLI game
    (`werewolf_cli.run_scripted`) with ``prove=True``: one divination and
    one vote proof.  The kernel counts are reset just before each run and
    read just after."""
    import json
    import tempfile

    import torch
    from zkmpc_tpu_torch.cli import werewolf_cli as CLI
    from zkmpc_tpu_torch.cli import werewolf_game as WG
    from zkmpc_tpu_torch.mpc.share import MpcContext, mpc_scope
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    from zkmpc_tpu_torch.snark import groth16
    dev = torch.device(DEVICE)
    total = {}

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out, launches, torch.cuda.max_memory_allocated(), wall

    with tempfile.TemporaryDirectory() as gamedir:
        def load(name):
            with open(os.path.join(gamedir, name)) as f:
                return json.load(f)
        # (a) the six modes, Groth16
        for mode, extra in (("init", ["--slots", str(slots)]), ("preprocessing", []),
                            ("role_assignment", []),
                            ("night", ["--rand-bits", "251", "--target", "1"]),
                            ("vote", ["--votes", "2,2,0"]), ("judgment", [])):
            args = WG.parse_args([mode, "--gamedir", gamedir, "--players", str(n_parties),
                                  "--device", DEVICE] + extra)
            report = {}
            ok, launches, peak, wall = counted(lambda: WG.MODES[mode](args, report))
            if not ok:
                raise AssertionError(f"phase 9 {mode}: failed ({report})")
            if mode == "init":
                log(f"phase 9 werewolf_game init ({slots} slots, {n_parties} players): roles "
                    f"dealt, SHE preprocessing {report['preprocessing_s']:.2f} s; wall-clock "
                    f"{wall:.2f} s; {_kernel_counts(launches)}")
                continue
            if min(launches.get("mont_mul", 0), launches.get("point_add_g1", 0),
                   launches.get("point_add_g2", 0)) <= 0:
                raise AssertionError(f"phase 9 {mode}: K1, K2 or K3 never ran ({launches})")
            log(f"phase 9 werewolf_game {mode} (groth16): the proof verifies, a wrong instance "
                f"is rejected; {_prove_line(report, peak, launches)}; wall-clock {wall:.2f} s")
        roles = [load(f"role_{i}.json")["role"] for i in range(n_parties)]
        div = load("divination.json")
        if div["is_werewolf"] != (roles[1] == "Werewolf"):
            raise AssertionError(f"phase 9: the seer decrypted {div}, the dealt roles are {roles}")
        tally = [[2, 2, 0].count(i) for i in range(n_parties)]
        if load("vote.json")["most_voted"] != max(range(n_parties),
                                                  key=lambda i: (tally[i], -i)):
            raise AssertionError(f"phase 9: vote.json {load('vote.json')} for tally {tally}")
        wolves = roles.count("Werewolf")
        state = 2 if wolves == 0 else (3 if wolves < n_parties - wolves else 1)
        if load("judgment.json")["state"] != state:
            raise AssertionError(f"phase 9: judgment.json {load('judgment.json')}, expected {state}")
        log(f"phase 9 game results: roles {roles}; the seer's decryption of player 1 "
            f"({div['is_werewolf']}) is the dealt role; most voted {load('vote.json')['most_voted']} "
            f"and game state {state} ({WG.GAME_STATES[state]}) as the roles and votes imply")
        # (b) vote and role_assignment under one universal Marlin SRS
        srs_path = os.path.join(gamedir, "universal_srs.json")
        stamp = None
        for mode, extra in (("role_assignment", []), ("vote", ["--votes", "2,2,0"])):
            args = WG.parse_args([mode, "--gamedir", gamedir, "--players", str(n_parties),
                                  "--device", DEVICE, "--zksnark", "marlin"] + extra)
            report = {}
            ok, launches, peak, wall = counted(lambda: WG.MODES[mode](args, report))
            if not ok or min(launches.get("mont_mul", 0), launches.get("point_add_g1", 0)) <= 0:
                raise AssertionError(f"phase 9 {mode} (marlin): failed or K1/K2 never ran "
                                     f"({report}, {launches})")
            if stamp is not None and os.path.getmtime(srs_path) != stamp:
                raise AssertionError("phase 9: the second Marlin phase set up its own SRS")
            stamp = os.path.getmtime(srs_path)
            log(f"phase 9 werewolf_game {mode} (marlin, universal SRS degree "
                f"{report['srs_degree']}, this circuit needs {report['srs_degree_needed']}"
                + (f", set up in {report['srs_setup_s']:.2f} s" if "srs_setup_s" in report
                   else ", the same file reloaded") + f"): the proof verifies, a wrong instance "
                f"is rejected; {_prove_line(report, peak, launches)}; wall-clock {wall:.2f} s")
    # (c) the reference-parameter circuits, proved with Groth16
    for name, want in REFERENCE_COUNTS.items():
        gen = torch.Generator(dev).manual_seed(91)
        report = {}

        def run():
            t = StackedTransport(n_parties, dev)
            with mpc_scope(MpcContext(t, "semi")):
                t0 = time.time()
                cs = reference_circuit(name, dev, gen)
                torch.cuda.synchronize()
                report.update(synthesis_s=time.time() - t0, synthesis_openings=t.stats.rounds,
                              constraints=len(cs.constraints))
                if not cs.is_satisfied_ints():
                    raise AssertionError(f"phase 9 {name}: unsatisfied")
                t0 = time.time()
                dpk = groth16.device_setup(cs, seed=5, device=dev)
                torch.cuda.synchronize()
                report["setup_s"] = time.time() - t0
                rounds, t0 = t.stats.rounds, time.time()
                proof = groth16.proof_to_ints(groth16.prove(dpk, cs, gen))
                report.update(prove_s=time.time() - t0, prove_openings=t.stats.rounds - rounds,
                              domain_n=dpk.pk.domain_n)
                inst = cs.instance_ints()
                t0 = time.time()
                ok = groth16.verify(dpk.pk.vk, inst, proof)
                report["verify_s"] = time.time() - t0
                bad = [inst[0], (inst[1] + 1) % FR.p] + inst[2:]
                return ok and not groth16.verify(dpk.pk.vk, bad, proof)
        ok, launches, peak, wall = counted(run)
        if not ok or min(launches.get(k, 0) for k in ("mont_mul", "point_add_g1",
                                                      "point_add_g2")) <= 0:
            raise AssertionError(f"phase 9 {name}: the proof failed or a kernel never ran "
                                 f"({report}, {launches})")
        log(f"phase 9 {name} at the reference's parameters, wires dealt by the leader: "
            f"{report['constraints']} constraints (the reference: {want}, ratio "
            f"{report['constraints'] / want:.3f}); the Groth16 proof verifies, a wrong instance "
            f"is rejected; {_prove_line(report, peak, launches)}; wall-clock {wall:.2f} s")
    # the CLI game with proofs: night (no kill, the seer divines the first
    # villager) and one vote that eliminates the werewolf
    names = ["a", "b", "c"]
    roles = [p.role for p in CLI.Game(names, seed=0).players]
    wolf = roles.index("Werewolf")
    seen = roles.index("Villager")
    script = f"divines={seen};votes={','.join([str(wolf)] * len(names))}"
    game, launches, peak, wall = counted(lambda: CLI.run_scripted(names, script, seed=0,
                                                                  prove=True, device=dev))
    if game.phase != "Over" or game._judge() != 2 or len(game.proofs) != 2 or \
            not all(r["verified"] and r["wrong_instance_rejected"] for r in game.proofs):
        raise AssertionError(f"phase 9 werewolf_cli: {game.phase}, {game.log}, {game.proofs}")
    for r in game.proofs:
        log(f"phase 9 werewolf_cli {r['what']}: {r['constraints']} constraints, domain "
            f"{r['domain_n']}; synthesis {r['synthesis_s']:.2f} s, setup {r['setup_s']:.2f} s, "
            f"prove {r['prove_s']:.2f} s ({r['prove_openings']} openings), verify "
            f"{r['verify_s']:.2f} s")
    log(f"phase 9 werewolf_cli run_scripted({names}, {script!r}, prove=True): "
        f"{' / '.join(game.log)}; wall-clock {wall:.2f} s; peak device memory {peak} B "
        f"({peak / 2**30:.2f} GiB); {_kernel_counts(launches)}")
    return total


#: the sampled positions at which phase 11 checks a batch against host ints
SAMPLES = 16
#: phase 11's sizes: MpcMulFp factors a party, shared bytes, bytes of each
#: string of the byte circuit, converted values, te_msm points,
#: te_tree_reduce points, sw_tree_reduce G1 and G2 points
MODULE_SIZES = dict(factors=1 << 14, bytes=4096, circuit_bytes=32, converted=1024,
                    te_msm=256, te_reduce=4096, g1=4096, g2=1024)


def _sample(n, rng):
    return sorted(rng.sample(range(n), min(SAMPLES, n)))


def phase_modules(n_parties=3, seed=11):
    """Phase 11: the last single-device modules on the card, each checked at
    sampled positions against Python ints or `spec/curves.py`, under
    `utils.timer.timed` (its records printed at the end), each logging its
    seconds, its launches by kernel and its peak device memory:
    (a) `MpcMulFp` at `n_parties` parties over FR and FQ, [2^14] random
    factors a party: reveal, local mul, inv, pow, scale, reveal again, and
    `+` raising; (b) `MpcU8` on 4,096 shared bytes: xor, and, or, not;
    (c) a byte circuit proved with Groth16: two 32-byte strings shared by
    parties 0 and 1 through `input_share`, allocated with
    `UInt8.new_witness_vec`, a.xor(b) equal to a public 32-byte instance,
    and `is_eq`, `rotr`, `shl` and `to_fp` of a few bytes; device setup,
    prove, verify and a wrong instance rejected; (d) `modulus_conversion`
    of [1,024] shared FR values below 2^250 to EDFR and to FQ, and of a
    public value; (e) `te_msm` of 256 Ed-on-BLS12-377 points with 251-bit
    scalars, `te_tree_reduce` of 4,096 points, `sw_tree_reduce` of 4,096
    G1 and 1,024 G2 points.  Every private draw comes from the parties'
    own generators (`mpc.rand.PartyGenerators`); the sizes are
    `MODULE_SIZES`.  Returns the launches."""
    import torch
    from zkmpc_tpu_torch import inputs as IN
    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.mpc.mul_share import MpcMulFp
    from zkmpc_tpu_torch.mpc.share import MpcContext, MpcFp, king_share, modulus_conversion, \
        mpc_scope
    from zkmpc_tpu_torch.mpc.uint8 import MpcU8
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops import curve as C
    from zkmpc_tpu_torch.ops import msm as M
    from zkmpc_tpu_torch.ops.limbs import EDFR, FQ, FR, FpArray
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    from zkmpc_tpu_torch.snark import groth16
    from zkmpc_tpu_torch.snark.gadgets import FpVar
    from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem
    from zkmpc_tpu_torch.snark.uint8_gadget import UInt8
    from zkmpc_tpu_torch.spec import curves as SC
    from zkmpc_tpu_torch.utils import timer
    dev = torch.device(DEVICE)
    rng = random.Random(seed)
    size = MODULE_SIZES
    total = {}
    timer.reset()

    def scope():
        t = StackedTransport(n_parties, dev)
        return mpc_scope(MpcContext(t, "semi")), R.PartyGenerators.for_transport(
            t, [rng.getrandbits(256) for _ in range(n_parties)])

    def ints(fp):
        return [int(v) for v in fp.to_ints().reshape(-1)]

    def fp(spec, vals):
        return FpArray.from_int(spec, vals, device=dev)

    def item(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.time()
        with timer.timed(f"phase 11 {name}", enabled=False):
            what = fn()
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 11 {name}: {what}; {wall:.2f} s, peak device memory {peak} B "
            f"({peak / 2**30:.2f} GiB); {_kernel_counts(launches)}")

    def mul_share():
        n = size["factors"]
        for spec in (FR, FQ):
            ctx, gens = scope()
            with ctx:
                fa = [[rng.randrange(1, spec.p) for _ in range(n)] for _ in range(n_parties)]
                k = [rng.randrange(1, spec.p) for _ in range(n)]
                x = MpcMulFp.from_shares(fp(spec, fa))
                y = MpcMulFp.from_public(fp(spec, k))
                outs = [x.reveal(), (x * y).reveal(), x.inv().reveal(),
                        x.pow_const(65537).reveal(), x.scale(fp(spec, k)).reveal()]
                try:
                    x + x
                    raise AssertionError("phase 11: + on multiplicative shares did not raise")
                except NotImplementedError:
                    pass
            p = spec.p
            for j in _sample(n, rng):
                v = 1
                for row in fa:
                    v = v * row[j] % p
                got = [int(o[(0, j)].to_ints()) for o in outs]
                want = [v, v * k[j] % p, pow(v, -1, p), pow(v, 65537, p), v * k[j] % p]
                if got != want:
                    raise AssertionError(f"phase 11 MpcMulFp {spec.name} at {j}: {got} != {want}")
        return (f"MpcMulFp at {n_parties} parties over FR and FQ, [{n}] factors a party: "
                f"reveal, mul, inv, pow, scale open to the host's products at {SAMPLES} "
                f"sampled positions; + raises")

    def uint8():
        n = size["bytes"]
        a_v = [rng.randrange(256) for _ in range(n)]
        b_v = [rng.randrange(256) for _ in range(n)]
        ctx, gens = scope()
        with ctx:
            a, b = (MpcU8(king_share(fp(FR, [[(v >> j) & 1 for j in range(8)] for v in vs]),
                                     gens)) for vs in (a_v, b_v))
            got = [u.reveal_ints() for u in (a.xor(b), a.and_(b), a.or_(b), a.not_())]
        for j in _sample(n, rng):
            want = [a_v[j] ^ b_v[j], a_v[j] & b_v[j], a_v[j] | b_v[j], a_v[j] ^ 0xFF]
            if [g[j] for g in got] != want:
                raise AssertionError(f"phase 11 MpcU8 at {j}: {[g[j] for g in got]} != {want}")
        return f"MpcU8 on {n} shared bytes: xor, and, or, not open to the host's bytes"

    def byte_circuit():
        n = size["circuit_bytes"]
        a_v = [rng.randrange(256) for _ in range(n)]
        b_v = [rng.randrange(256) for _ in range(n)]
        b_v[3] = a_v[3]
        ctx, gens = scope()
        syn, prv = gens.stream(1), gens.stream(2)
        with ctx as c:
            t0 = time.time()
            a_w, b_w = (IN.input_share(fp(FR, vs), owner, gens)
                        for owner, vs in enumerate((a_v, b_v)))
            cs = ConstraintSystem(FR)
            xs = [FpVar.new_input(cs, MpcFp.const(FR, x ^ y)) for x, y in zip(a_v, b_v)]
            a = UInt8.new_witness_vec(cs, a_w, syn)
            b = UInt8.new_witness_vec(cs, b_w, syn)
            for i in range(n):
                a[i].xor(b[i]).to_fp().enforce_equal(xs[i])
            a[3].is_eq(b[3], syn).enforce_true()
            a[0].rotr(3).to_fp().enforce_equal(FpVar.constant(
                cs, ((a_v[0] >> 3) | (a_v[0] << 5)) & 0xFF))
            a[1].shl(2).enforce_equal(UInt8.constant(cs, (a_v[1] << 2) & 0xFF))
            a[2].to_fp().enforce_equal(FpVar.new_witness(cs, a_w[2]))
            torch.cuda.synchronize()
            t_syn = time.time() - t0
            if not cs.is_satisfied_ints():
                raise AssertionError("phase 11: the byte circuit is not satisfied")
            inst = cs.instance_ints()
            t0 = time.time()
            dpk = groth16.device_setup(cs, seed=seed, device=dev)
            torch.cuda.synchronize()
            t_setup = time.time() - t0
            t0 = time.time()
            proof = groth16.proof_to_ints(groth16.prove(dpk, cs, prv))
            torch.cuda.synchronize()
            t_prove = time.time() - t0
            bad = list(inst)
            bad[1] = (bad[1] + 1) % FR.p
            if not groth16.verify(dpk.pk.vk, inst, proof) or groth16.verify(dpk.pk.vk, bad,
                                                                            proof):
                raise AssertionError("phase 11: the byte circuit's proof failed to verify or "
                                     "verified a wrong instance")
            openings = c.transport.stats.rounds
        return (f"byte circuit (2 x {n} bytes input-shared by parties 0 and 1, xor against "
                f"a public {n}-byte instance, is_eq, rotr, shl, to_fp): "
                f"{len(cs.constraints)} constraints, {cs.num_instance} instance values, "
                f"domain {dpk.pk.domain_n}; synthesis {t_syn:.2f} s, setup {t_setup:.2f} s, "
                f"prove {t_prove:.2f} s, {openings} openings; the proof verifies, a wrong "
                f"instance is rejected")

    def conversion():
        n = size["converted"]
        vals = [rng.getrandbits(250) for _ in range(n)]
        ctx, gens = scope()
        with ctx:
            x = king_share(fp(FR, vals), gens)
            outs = [modulus_conversion(x, EDFR, gens), modulus_conversion(x, FQ, gens)]
            got = [ints(o.reveal()[0]) for o in outs]
            pub = ints(modulus_conversion(MpcFp.const(FR, vals[:4]), EDFR, gens).value[0])
        for j in _sample(n, rng):
            want = [vals[j] % EDFR.p, vals[j] % FQ.p]
            if [g[j] for g in got] != want:
                raise AssertionError(f"phase 11 modulus_conversion at {j}")
        if pub != [v % EDFR.p for v in vals[:4]]:
            raise AssertionError("phase 11 modulus_conversion of a public value")
        return (f"modulus_conversion of [{n}] shared FR values below 2^250 to EDFR and FQ, "
                f"and of a public value, open to the host's residues")

    def curves():
        G = C.TEPoint.from_affine_ints([SC.TE_GEN], dev)
        ks = [rng.randrange(1, EDFR.p) for _ in range(size["te_reduce"])]
        pts = C.te_scalar_mul(G[0], fp(EDFR, ks))                        # k_i * G
        for j in _sample(len(ks), rng)[:4]:
            if pts[j:j + 1].to_affine_ints() != [SC.te_scalar_mul(SC.TE_GEN, ks[j])]:
                raise AssertionError(f"phase 11 te_scalar_mul at {j}")
        ss = [rng.getrandbits(251) % EDFR.p for _ in range(size["te_msm"])]
        msm = M.te_msm(pts[:len(ss)], fp(EDFR, ss)).reshape(1).to_affine_ints()
        want = SC.te_scalar_mul(SC.TE_GEN, sum(s * k for s, k in zip(ss, ks)) % EDFR.p)
        if msm != [want]:
            raise AssertionError("phase 11 te_msm")
        red = C.te_tree_reduce(pts).reshape(1).to_affine_ints()
        if red != [SC.te_scalar_mul(SC.TE_GEN, sum(ks) % EDFR.p)]:
            raise AssertionError("phase 11 te_tree_reduce")
        for name, n, mk, gen_pt, mul in (
                ("G1", size["g1"], C.SWPoint.g1_from_affine_ints, SC.G1_GEN, SC.g1_mul),
                ("G2", size["g2"], C.SWPoint.g2_from_affine_ints, SC.G2_GEN, SC.g2_mul)):
            ks = [rng.randrange(1, FR.p) for _ in range(n)]
            pts = C.sw_scalar_mul(mk([gen_pt], dev)[0], fp(FR, ks))
            got = C.sw_tree_reduce(pts).reshape(1).to_affine_ints()
            if got != [mul(gen_pt, sum(ks) % FR.p)]:
                raise AssertionError(f"phase 11 sw_tree_reduce on {name}")
        return (f"te_msm of {size['te_msm']} points with 251-bit scalars and te_tree_reduce "
                f"of {size['te_reduce']} points equal the spec's multiples of the generator; "
                f"sw_tree_reduce of {size['g1']} G1 and {size['g2']} G2 points likewise")

    for name, fn in (("(a) MpcMulFp", mul_share), ("(b) MpcU8", uint8),
                     ("(c) byte circuit, Groth16", byte_circuit),
                     ("(d) modulus_conversion", conversion),
                     ("(e) Edwards and tree reductions", curves)):
        item(name, fn)
    log("phase 11 (f) timer records: " + "; ".join(
        f"{'  ' * d}{label} {dt:.3f} s" for d, label, dt in timer.records()))
    return total


#: the values of phase 12 (b): bit decompositions and comparisons (64
#: through PR 12; 16 since phase 13 joined the script's 1,200 s)
MESH_BITS = 16


def _mesh_protocols(t, seeds, inputs):
    """Phase 12 (b) and (c) on transport ``t`` (stacked or a mesh rank),
    under the parties' private ``seeds``, one ChaCha20 stream each
    protocol: `bit_decomposition` of MESH_BITS shared values, `less_than`
    of MESH_BITS pairs, a `rand_shared` and a `bit_rand` draw; then the
    protocols of the JAX package's mesh tests, x*y + x - y and the
    multiplicative shares 2, 3, 5.  ``inputs``: every party's share limbs
    [P, ...] by name.  Returns name -> (this process's share limbs or
    None, the opened ints of its first row)."""
    import torch
    from zkmpc_tpu_torch.mpc import bits as B
    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.mpc.mul_share import MpcMulFp
    from zkmpc_tpu_torch.mpc.share import SHARED, MpcContext, MpcFp, mpc_scope, rand_shared
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    gens = R.PartyGenerators.for_transport(t, {i: seeds[i] for i in t.row_ids})

    def rows(name):
        return FpArray(t.own_rows(torch.as_tensor(inputs[name])).to(t.device), FR, 2)

    def opened(x):
        return [int(v) for v in x.reveal().to_ints()[0].reshape(-1)]
    out = {}
    with mpc_scope(MpcContext(t, "semi")):
        shared = {k: MpcFp(rows(k), SHARED) for k in ("bits_x", "lt_x", "lt_y", "x", "y")}
        for name, x in (
                ("bit_decomposition", B.bit_decomposition(shared["bits_x"], gens.stream(3))),
                ("less_than", B.less_than(shared["lt_x"], shared["lt_y"], gens.stream(4))),
                ("rand_shared", rand_shared(gens.stream(5), FR, (MESH_BITS,))),
                ("bit_rand", B.bit_rand(gens.stream(6), FR, (MESH_BITS,)))):
            out[name] = (x.value.limbs, opened(x))
        x, y = shared["x"], shared["y"]
        out["x*y+x-y"] = (None, opened(x * y + x - y))
        out["mul_share"] = (None, opened(MpcMulFp.from_shares(rows("factors"))))
    return out


def _mesh_rank(t, key_path, a_limbs, b_limbs, seeds, inputs):
    """One rank of phase 12: the wide-mul prove with its own private seed
    (`parallel.mesh.prove_rank`), then `_mesh_protocols`; returns its
    report (seconds, openings, bytes, peak device memory, launches, the
    loaded modules) and results."""
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.parallel import mesh
    dev = t.device
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launches()
    rep = mesh.prove_rank(t, key_path, a_limbs, b_limbs, seed=seeds[t.party_id])
    rounds, nbytes = t.stats.rounds, t.stats.bytes_moved
    t0 = time.time()
    rep["protocols"] = _mesh_protocols(t, seeds, inputs)
    torch.cuda.synchronize(dev)
    rep.update(protocols_s=time.time() - t0, protocol_openings=t.stats.rounds - rounds,
               protocol_bytes=t.stats.bytes_moved - nbytes,
               on_device=rep["on_device"] and all(
                   v.device.type == dev.type for v, _ in rep["protocols"].values()
                   if v is not None),
               peak_device_bytes=torch.cuda.max_memory_allocated(dev),
               launches=dict(K.LAUNCHES), describe=t.describe(),
               modules=mesh.forbidden_modules())
    return rep


def phase_mesh(dpk, n_gates, workdir, n_parties=3, timeout=600, seed=12):
    """Phase 12: the party-axis mesh on the card, one rank (OS process) a
    party in a torch.distributed group (`parallel.mesh.run_parties`), all
    ranks on one device, so the backend is gloo and the collectives go
    through the host.  (a) The wide-mul prove at ``n_gates`` gates on
    phase 4's key: the parent writes the key to a file, proves once on the
    stacked transport with `PartyGenerators` holding the ranks' private
    seeds (fresh 256-bit seeds), and each rank loads the key, takes its
    rows of freshly re-shared inputs and proves with its own seed; every
    rank's proof must equal the stacked one, verify under the host pairing
    and reject a wrong instance.  (b) `_mesh_protocols`' bit protocols and
    private draws, and (c) the JAX package's two mesh protocols: every
    rank's opened values equal the stacked run's and the plain values, and
    its rows of each share equal the stacked run's row.  Per rank: key
    load and prove seconds, openings and bytes moved, peak device memory,
    K1/K2/K3 launches, and no JAX module loaded.  The key file stays in
    ``workdir``.  Returns the launches of the stacked runs and the ranks,
    and what phase 13 reuses: the key file, the re-shared inputs, the
    seeds, the stacked proof, the verifying key and domain size, and rank
    0's launches."""
    import secrets

    import numpy as np
    import torch
    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.parallel import mesh
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    from zkmpc_tpu_torch.snark import driver, groth16
    dev = torch.device(DEVICE)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    seeds = [secrets.token_bytes(32) for _ in range(n_parties)]
    _, (a_l, b_l, _) = driver.make_prove_fn(dpk, n_parties)
    a_l = _reshare(a_l, _masks(rng, n_parties, (n_gates,), dev))
    b_l = _reshare(b_l, _masks(rng, n_parties, (n_gates,), dev))
    vals = {"bits_x": [prng.randrange(FR.p) for _ in range(MESH_BITS)],
            "lt_x": [prng.getrandbits(200) for _ in range(MESH_BITS)],
            "lt_y": [prng.getrandbits(200) for _ in range(MESH_BITS)],
            "x": [6, 9], "y": [7, 11]}
    inputs = {k: _reshare(driver.deal(v, n_parties, dev), _masks(rng, n_parties, (len(v),), dev))
              .cpu().numpy() for k, v in vals.items()}
    inputs["factors"] = FpArray.from_int(FR, np.asarray([[2], [3], [5]], dtype=object),
                                         device="cpu").limbs.numpy()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.time()
    step, _ = driver.make_prove_fn(dpk, n_parties)
    want = driver.proof_arrays_to_ints(step(a_l, b_l, R.PartyGenerators(range(n_parties),
                                                                        seeds, dev)))
    torch.cuda.synchronize()
    t_stacked = time.time() - t0
    t0 = time.time()
    stacked = _mesh_protocols(StackedTransport(n_parties, dev), seeds, inputs)
    torch.cuda.synchronize()
    t_stacked_protocols = time.time() - t0
    launches = dict(K.LAUNCHES)
    inst = driver.expected_instance(n_gates)
    if not groth16.verify(dpk.pk.vk, inst, want):
        raise AssertionError("phase 12: the stacked proof does not verify")
    if groth16.verify(dpk.pk.vk, [inst[0], (inst[1] + 1) % FR.p], want):
        raise AssertionError("phase 12: a wrong instance verified")
    plain = {"bit_decomposition": [(v >> j) & 1 for v in vals["bits_x"]
                                   for j in range(FR.p.bit_length())],
             "less_than": [int(x < y) for x, y in zip(vals["lt_x"], vals["lt_y"])],
             "x*y+x-y": [(6 * 7 + 6 - 7) % FR.p, (9 * 11 + 9 - 11) % FR.p],
             "mul_share": [30]}
    for name, v in plain.items():
        if stacked[name][1] != v:
            raise AssertionError(f"phase 12: the stacked {name} opens wrong values")
    key_path = os.path.join(workdir, "dpk.pkl")
    t0 = time.time()
    mesh.write_key(dpk, key_path)
    t_key = time.time() - t0
    a_np, b_np = a_l.cpu().numpy(), b_l.cpu().numpy()
    t0 = time.time()
    ranks = mesh.run_parties(_mesh_rank, n_parties, dev, "gloo", timeout,
                             args=(key_path, a_np, b_np, seeds, inputs))
    wall = time.time() - t0
    log(f"phase 12 mesh: backend gloo, {n_parties} ranks on one device {dev} "
        f"({ranks[0]['describe']}); stacked prove {t_stacked:.2f} s, stacked protocols "
        f"{t_stacked_protocols:.2f} s, key written in {t_key:.2f} s; ranks "
        f"{wall:.2f} s wall-clock")
    for i, r in enumerate(ranks):
        who = f"phase 12 rank {i}"
        if r["modules"]:
            raise AssertionError(f"{who} imported {r['modules'][:5]}")
        if not r["on_device"]:
            raise AssertionError(f"{who}: a result left the card")
        if r["proof"] != want:
            raise AssertionError(f"{who}: the mesh proof differs from the stacked proof")
        for name, (limbs, opened) in stacked.items():
            mine, mine_opened = r["protocols"][name]
            if mine_opened != opened:
                raise AssertionError(f"{who}: {name} opens other values than the stacked run")
            if limbs is not None and not torch.equal(mine[0], limbs[i].cpu()):
                raise AssertionError(f"{who}: its rows of {name} differ from the stacked row")
        if min(r["launches"].get(k, 0) for k in KERNELS) <= 0:
            raise AssertionError(f"{who} never launched one of {list(KERNELS)}: "
                                 f"{r['launches']}")
        log(f"{who}: key load {r['load_s']:.3f} s, prove {r['prove_s']:.3f} s "
            f"({r['openings']} openings, {r['bytes']} B), protocols {r['protocols_s']:.3f} s "
            f"({r['protocol_openings']} openings, {r['protocol_bytes']} B); peak device memory "
            f"{r['peak_device_bytes']} B ({r['peak_device_bytes'] / 2**30:.2f} GiB); "
            f"{_kernel_counts(r['launches'])}, K1 {r['launches'].get('mont_mul', 0)}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"phase 12: every rank's proof equals the stacked proof, which verifies and rejects a "
        f"wrong instance; bit_decomposition of {MESH_BITS}, less_than of {MESH_BITS}, "
        f"x*y+x-y = {stacked['x*y+x-y'][1]} and the product 30 open as stacked, every rank's "
        f"rows equal the stacked rows; no rank imported JAX; stacked launches "
        f"{_kernel_counts(dict(K.LAUNCHES))}; in all {_kernel_counts(launches)}")
    return launches, dict(key_path=key_path, a=a_np, b=b_np, seeds=seeds, proof=want,
                          vk=dpk.pk.vk, domain_n=dpk.pk.domain_n,
                          rank_launches=ranks[0]["launches"])


#: chips a party in phase 13
CHIPS = 2


def _chips_rank(t, key_path, a_limbs, b_limbs, seeds, ntt_n, chips=None):
    """One rank of phase 13 (party p, chip c): the wide-mul prove with
    party p's private seed, its MSMs split over the party's chips group
    (`parallel.mesh.prove_rank`), then the four-step NTT of ``ntt_n``
    coefficients over the chips group (`parallel.sharded.sharded_fft` and
    `sharded_ifft`) held against the rank's own `Domain` NTT; returns its
    report (seconds, openings and bytes over the party group, gathers and
    bytes over the chips group, MSM calls, peak device memory, launches of
    the prove and in all, the loaded modules)."""
    import numpy as np
    import torch
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops.limbs import FR, FpArray
    from zkmpc_tpu_torch.ops.ntt import Domain
    from zkmpc_tpu_torch.parallel import mesh, sharded
    dev = t.device
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launches()
    rep = mesh.prove_rank(t, key_path, a_limbs, b_limbs, seed=seeds[t.party_id], chips=chips)
    rep["prove_launches"] = dict(K.LAUNCHES)
    vals = np.random.default_rng(13).integers(0, 1 << 62, ntt_n, dtype=np.int64)
    full = FpArray.from_int(FR, np.asarray([int(v) for v in vals], dtype=object), device=dev)
    per = ntt_n // chips.size
    lo, hi = chips.index * per, (chips.index + 1) * per
    rounds, nbytes = chips.transposes.rounds, chips.transposes.bytes_moved
    torch.cuda.synchronize(dev)
    t0 = time.time()
    ev = sharded.sharded_fft(FR, ntt_n, full[lo:hi], chips)
    back = sharded.sharded_ifft(FR, ntt_n, ev, chips)
    torch.cuda.synchronize(dev)
    ntt_s = time.time() - t0
    want = Domain(FR, ntt_n, dev).fft(full)[lo:hi]
    rep.update(ntt_s=ntt_s, ntt_ok=list(ev.to_ints()) == list(want.to_ints()),
               intt_ok=list(back.to_ints()) == [int(v) for v in vals[lo:hi]],
               ntt_transposes=chips.transposes.rounds - rounds,
               ntt_transpose_bytes=chips.transposes.bytes_moved - nbytes,
               on_device=rep["on_device"] and ev.device.type == back.device.type == dev.type,
               party=t.party_id, chip=chips.index, n_chips=chips.size,
               peak_device_bytes=torch.cuda.max_memory_allocated(dev),
               launches=dict(K.LAUNCHES), describe=t.describe(),
               modules=mesh.forbidden_modules())
    return rep


def phase_chips(shared, n_gates, n_parties=3, n_chips=CHIPS, timeout=600):
    """Phase 13: the chips axis on the card, the 3 x 2 mesh of
    ``__graft_entry__.dryrun_multichip``: n_parties x n_chips ranks (OS
    processes) on the one device over gloo, party p, chip c at rank
    p*C + c (`parallel.mesh.run_parties(n_chips=...)`).  Each rank proves
    the wide-mul circuit at ``n_gates`` gates with phase 12's key file,
    re-shared inputs and its party's fresh 256-bit seed, its openings over
    its party group and each MSM split over its party's chips group; every
    rank's proof must equal phase 12's stacked proof (so both chips of a
    party agree), which verifies and rejects a wrong instance.  Then the
    four-step NTT over each chips group at the prove's domain size, held
    against the rank's own NTT.  Fails unless the split ran: each rank's
    gathers over its chips group equal its MSM calls, more than none, and
    its prove launched fewer K2 and K3 than phase 12's one-chip rank.  Per
    rank: key load and prove seconds, openings and bytes, gathers and
    bytes, peak device memory, launches, and no JAX module loaded.
    Returns the ranks' launches."""
    import torch
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.parallel import mesh
    from zkmpc_tpu_torch.snark import driver, groth16
    dev = torch.device(DEVICE)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ntt_n = shared["domain_n"]
    want, one_chip = shared["proof"], shared["rank_launches"]
    t0 = time.time()
    ranks = mesh.run_parties(_chips_rank, n_parties, dev, "gloo", timeout, n_chips=n_chips,
                             args=(shared["key_path"], shared["a"], shared["b"],
                                   shared["seeds"], ntt_n))
    wall = time.time() - t0
    log(f"phase 13 chips: backend gloo, {n_parties} parties x {n_chips} chips on one device "
        f"{dev} ({ranks[0]['describe']}); ranks {wall:.2f} s wall-clock")
    proofs = {}
    launches = {}
    for i, r in enumerate(ranks):
        who = f"phase 13 rank {i} (party {r['party']}, chip {r['chip']})"
        if (r["party"], r["chip"], r["n_chips"]) != divmod(i, n_chips) + (n_chips,):
            raise AssertionError(f"{who}: rank {i} is not party {i // n_chips}, chip "
                                 f"{i % n_chips}")
        if r["modules"]:
            raise AssertionError(f"{who} imported {r['modules'][:5]}")
        if not r["on_device"]:
            raise AssertionError(f"{who}: a result left the card")
        if r["proof"] != want:
            raise AssertionError(f"{who}: its proof differs from the stacked proof")
        if not (r["ntt_ok"] and r["intt_ok"]):
            raise AssertionError(f"{who}: the four-step NTT differs from the rank's own NTT")
        if not r["chips_gathers"] == r["msm_calls"] > 0:
            raise AssertionError(f"{who}: {r['msm_calls']} MSM calls but {r['chips_gathers']} "
                                 f"gathers over the chips group: an MSM ran unsplit")
        pl = r["prove_launches"]
        for k in ("point_add_g1", "point_add_g2"):
            if not 0 < pl.get(k, 0) < one_chip.get(k, 0):
                raise AssertionError(f"{who}: its prove launched {k} {pl.get(k, 0)} times, not "
                                     f"fewer than phase 12's one-chip rank's "
                                     f"{one_chip.get(k, 0)}")
        if min(r["launches"].get(k, 0) for k in KERNELS) <= 0:
            raise AssertionError(f"{who} never launched one of {list(KERNELS)}: "
                                 f"{r['launches']}")
        proofs[(r["party"], r["chip"])] = r["proof"]
        log(f"{who}: key load {r['load_s']:.3f} s, prove {r['prove_s']:.3f} s "
            f"({r['openings']} openings, {r['bytes']} B over the party group; "
            f"{r['chips_gathers']} gathers, {r['chips_bytes']} B over the chips group, "
            f"{r['msm_calls']} MSM calls); NTT and inverse of {ntt_n} {r['ntt_s']:.3f} s "
            f"({r['ntt_transposes']} transposes, {r['ntt_transpose_bytes']} B); peak device "
            f"memory {r['peak_device_bytes']} B ({r['peak_device_bytes'] / 2**30:.2f} GiB); "
            f"prove {_kernel_counts(pl)}, K1 {pl.get('mont_mul', 0)}; in all "
            f"{_kernel_counts(r['launches'])}, K1 {r['launches'].get('mont_mul', 0)}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for p in range(n_parties):
        if len({str(proofs[(p, c)]) for c in range(n_chips)}) != 1:
            raise AssertionError(f"phase 13: the chips of party {p} disagree on the proof")
    inst = driver.expected_instance(n_gates)
    if not groth16.verify(shared["vk"], inst, proofs[(0, 0)]):
        raise AssertionError("phase 13: the proof does not verify")
    if groth16.verify(shared["vk"], [inst[0], (inst[1] + 1) % FR.p], proofs[(0, 0)]):
        raise AssertionError("phase 13: a wrong instance verified")
    log(f"phase 13: every rank's proof equals the stacked proof, both chips of each party "
        f"agree, it verifies and rejects a wrong instance; every MSM split over the chips "
        f"group; the four-step NTT of {ntt_n} equals the rank's own; no rank imported JAX; "
        f"in all {_kernel_counts(launches)}, K1 {launches.get('mont_mul', 0)}")
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
    import tempfile
    results = {}
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        seconds[name] = time.time() - t0
        return out
    timed("1", phase_card)
    timed("2", phase_mont_mul, results)
    timed("3", phase_point_add, results)
    timed("4a", phase_fixture)
    wide, wide_dpk = timed("4", phase_slice, args.gates)
    ped = timed("5", phase_pedersen)
    main_bin, semi = timed("6", phase_main)
    spdz = timed("7", phase_spdz, semi)
    with tempfile.TemporaryDirectory() as work:
        marlin, online = timed("8", phase_marlin, work)
        werewolf = timed("9", phase_werewolf)
        socket = timed("10", phase_socket, online, work)
    modules = timed("11", phase_modules)
    with tempfile.TemporaryDirectory(prefix="zkmpc_mesh_key_") as keydir:
        mesh, shared = timed("12", phase_mesh, wide_dpk, args.gates, keydir)
        chips = timed("13", phase_chips, shared, args.gates)
    paths = {"4": wide, "5": ped, "6": main_bin, "7": spdz, "8": marlin, "9": werewolf,
             "10": socket, "11": modules, "12": mesh, "13": chips}
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in set().union(*paths.values())}
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
                        "bound_by": r["bound_by"], "library_ms": None,
                        "launches_by_phase": {ph: p.get(name, 0) for ph, p in paths.items()}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
