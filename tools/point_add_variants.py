#!/usr/bin/env python3
"""Layout variants of the point-add kernels K2/K3 on one CUDA card.

Builds ``zkmpc_tpu_torch/csrc/point_add.cu`` as committed and a few variants
derived from it by text substitution, all with ``nvcc`` at once, then for
each: prints the ptxas register/spill report, holds K2 and K3 against the
plain version on `chip_smoke.case_points`'s lanes, and times them at 32,768
generic lanes (CUDA events, the kernels in turns).

    python3 tools/point_add_variants.py            # needs one CUDA card

Variants (names as printed):
- ``committed``: the source as it is (the CIOS outer loop rolled, the
  per-coordinate load loop and the store's doubling loop rolled);
- ``cios_unrolled``: the 12-word CIOS with its outer loop fully unrolled;
- ``cios_roll2`` / ``cios_roll4``: its outer loop unrolled by 2 or 4;
- ``io_unrolled``: the load and store loops fully unrolled;
- ``mul_noinline``: the FQ product out of line (one copy, called);
- ``f2_noinline``: the Fq2 product and square out of line.

Each variant also reports its SASS instruction count per kernel
(``cuobjdump -sass``), the size the instruction cache has to hold.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import threading
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "zkmpc_tpu_torch", "variants")

def _swap(src, old, new):
    assert src.count(old) == 1, f"point_add.cu: {old!r} not found once"
    return src.replace(old, new)


def variants(src):
    out = {"committed": src}
    cios = "#pragma unroll 1\n  for (int i = 0; i < NW; ++i) {"
    for name, pragma in (("cios_unrolled", "#pragma unroll"), ("cios_roll2", "#pragma unroll 2"),
                         ("cios_roll4", "#pragma unroll 4")):
        out[name] = _swap(src, cios, pragma + cios[len("#pragma unroll 1"):])
    io = _swap(src, "#pragma unroll 1\n  for (int s = 0; s < 6; ++s) {",
               "#pragma unroll\n  for (int s = 0; s < 6; ++s) {")
    out["io_unrolled"] = _swap(io, "#pragma unroll 1\n  for (int k = 0; k < NC; ++k) {",
                               "#pragma unroll\n  for (int k = 0; k < NC; ++k) {")
    out["mul_noinline"] = _swap(src, "__device__ __forceinline__ Fq mul(const Fq& a",
                                "__device__ __noinline__ Fq mul(const Fq& a")
    f2 = _swap(src, "__device__ __forceinline__ F2 mul(const F2& x",
               "__device__ __noinline__ F2 mul(const F2& x")
    out["f2_noinline"] = _swap(f2, "__device__ __forceinline__ F2 sqr(const F2& x",
                               "__device__ __noinline__ F2 sqr(const F2& x")
    return out


def build_all(srcs):
    """One nvcc per variant, all started together; returns {name: (lib, log)}."""
    from zkmpc_tpu_torch.ops import build as K
    procs = {}
    for name, src in srcs.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "point_add.cu"), "w") as f:
            f.write(src)
        cmd = [K._nvcc()] + K.NVCC_FLAGS + ["-I", K.CSRC_DIR, "-o", os.path.join(d, "lib.so"),
                                           os.path.join(d, "point_add.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), d)
    built = {}
    for name, (proc, d) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        built[name] = (os.path.join(d, "lib.so"), log)
    return built


def ptxas_report(log):
    """{'F1'|'F2': (registers, spill store bytes)} from a -Xptxas -v log."""
    rep, kind = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = re.search(r"point_add_kernelINS_2(F[12])", ln)
            kind = m.group(1) if m else None
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and kind and kind not in rep:
            rep[kind] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and kind in rep and rep[kind][0] is None:
            rep[kind][0] = int(m.group(1))
    return {k: tuple(v) for k, v in rep.items()}


def sass_sizes(lib_path):
    """{function: SASS instructions} from ``cuobjdump -sass``."""
    from zkmpc_tpu_torch.ops import build as K
    tool = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    sizes, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            kind = re.search(r"point_add_kernelINS_2(F[12])", name)
            fn = f"kernel<{kind.group(1)}>" if kind else name[-40:]
            sizes[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            sizes[fn] += 1
    return sizes


def main():
    import torch
    import chip_smoke as CS
    from zkmpc_tpu_torch.ops import build as K
    from zkmpc_tpu_torch.ops import cuda_point
    if not torch.cuda.is_available():
        raise SystemExit("point_add_variants: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with open(os.path.join(K.CSRC_DIR, "point_add.cu")) as f:
        src = f.read()
    t0 = time.time()
    # the committed library (K1 and all) builds beside the variants
    real = threading.Thread(target=K.library)
    real.start()
    built = build_all(variants(src))
    real.join()
    real = K.library()
    print(f"built {len(built)} variants in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    cases = {g2: CS.case_points(g2, dev) for g2 in (False, True)}
    libs = {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(path)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.zk_point_add.argtypes = [i, i, p, p, p, p, p, p, p, i64, p]
        lib.zk_point_add.restype = i
        # K1 (under to_affine_ints) from the committed library
        libs[name] = types.SimpleNamespace(zk_mont_mul=real.zk_mont_mul,
                                           zk_point_add=lib.zk_point_add)
    rows = {name: {"ptxas": ptxas_report(built[name][1]),
                   "sass": sass_sizes(built[name][0])} for name in libs}
    timed = {}
    for g2, (p, q, exp, (lo, hi)) in cases.items():
        want = cuda_point.sw_add_complete_plain(p, q).to_affine_ints()
        idx = lo + torch.arange(32768, device=dev) % (hi - lo)
        timed[g2] = (p.map(lambda t: t.index_select(0, idx)),
                     q.map(lambda t: t.index_select(0, idx)))
        for name, lib in libs.items():
            K._lib = lib
            got = cuda_point.sw_add_complete_cuda(p, q).to_affine_ints()
            rows[name]["g2" if g2 else "g1"] = {"agrees": got == want == exp}
    # timing in turns: every variant once per round, 3 rounds
    for rnd in range(3):
        for g2, (pl, ql) in timed.items():
            for name, lib in libs.items():
                K._lib = lib
                ms = CS.cuda_time_ms(lambda: cuda_point.sw_add_complete_cuda(pl, ql), 10)
                rows[name]["g2" if g2 else "g1"].setdefault("ms", []).append(ms)
    K._lib = real
    for name, row in rows.items():
        print(json.dumps({"variant": name, **row}), flush=True)


if __name__ == "__main__":
    main()
