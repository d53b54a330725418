"""K1's word arithmetic (`zkmpc_tpu_torch/csrc/mont.cuh`) on the CPU.

Three checks of the Montgomery multiply that the CUDA kernel runs, at
FR, FQ and MNT4Q, on seeded inputs that include 0, 1, p-1 and 2p-1,
operands whose limbs are B+1 wherever the value bound allows it, pairs at
the contract's edge (c1·c2 as large as c1·c2·p <= R/2 allows) and a
constant b:

- a pure-Python model of the kernel's steps (packing with carries, the W-1
  word steps and the S-bit step, unpacking), held against the exact
  REDC_R(T) = (T + m p)/R and against the plain version modulo p;
- the header itself, compiled with g++ with its PTX carry primitives
  swapped for host functions that keep the carry flag in a variable, on
  the same inputs: its limbs must equal the model's;
- the wrapper's operands and merged batch layout
  (`cuda_fp.kernel_operands`), walked the way the kernel walks it, against
  the addresses of every element of strided and broadcast operands.

Tolerance is exact: modular integer arithmetic.  The kernel's output is
exactly REDC_R(a·b); the plain version may be that plus p.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import check_k1, k1_cases, k1_edge_limbs, k1_views
from torch_parity import CPU, rand_ints
from zkmpc_tpu_torch.ops import cuda_fp
from zkmpc_tpu_torch.ops import limbs as TL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "zkmpc_tpu_torch", "csrc")
FIELDS = [TL.FR, TL.FQ, TL.MNT4Q]
IDS = [s.name for s in FIELDS]
B, M32 = TL.B, (1 << 32) - 1


def cases(spec, seed):
    """`chip_smoke.k1_cases` (the inputs the card is held to) and 8 random
    canonical pairs: [(a limbs [k, n], b limbs [k, n])]."""
    rng = np.random.default_rng(seed)
    lim = lambda vals: np.stack([TL.int_to_limbs(v, spec.nlimbs) for v in vals])  # noqa: E731
    out = [(a, b) for _, a, b in k1_cases(spec, seed)]
    for a, b in out:
        for ra, rb in zip(a, b):
            assert TL.limbs_to_int(ra) * TL.limbs_to_int(rb) * 2 <= spec.R * spec.p
    assert any((a == B + 1).sum() > spec.nlimbs // 2 for a, _ in out)
    return out + [(lim(rand_ints(rng, spec.p, 8)), lim(rand_ints(rng, spec.p, 8)))]


def const_b_case(spec, seed):
    """Relaxed a (bound 2) against one constant row b (repr(1)), as tighten
    calls it, and the raw integer 1, as int_limbs calls it."""
    rng = np.random.default_rng(seed)
    a = np.stack([TL.int_to_limbs(v, spec.nlimbs) for v in
                  [x + spec.p for x in rand_ints(rng, spec.p, 5)]]
                 + [k1_edge_limbs(spec, 2)])
    return a, [spec.one_limbs, spec.int_one_limbs]


# ---- the model ----------------------------------------------------------


def pack(limbs, n, w):
    """The kernel's running 64-bit accumulator: word j leaves it once every
    limb below the word's top bit has come in; the last word is what is
    left."""
    words, acc = [], 0
    for i in range(n):
        acc += int(limbs[i]) << (15 * i - 32 * len(words))
        assert acc < 2**64
        if 15 * (i + 1) >= 32 * (len(words) + 1):
            words.append(acc & M32)
            acc >>= 32
    assert len(words) == w - 1 and acc <= M32
    return words + [acc]


def unpack(words, n):
    w = len(words)
    out = []
    for i in range(n):
        wi, sh = (15 * i) // 32, (15 * i) % 32
        v = words[wi] >> sh
        if sh > 17 and wi + 1 < w:
            v |= (words[wi + 1] << (32 - sh)) & M32
        out.append(v & 0x7FFF)
    return out


def model(spec, a_limbs, b_limbs):
    """REDC_R(a·b) the kernel's way; returns (limbs, value)."""
    n, p = spec.nlimbs, spec.p
    w, s = cuda_fp.kernel_shape(n)
    consts = cuda_fp.kernel_consts_list(spec)
    np32, nps = consts[w], consts[w + 1]
    x, y = pack(a_limbs, n, w), pack(b_limbs, n, w)
    val = lambda ws: sum(v << (32 * j) for j, v in enumerate(ws))  # noqa: E731
    t = val(x) * val(y)
    for i in range(w - 1):
        k = ((t >> (32 * i)) & M32) * np32 & M32
        t += (k * p) << (32 * i)
        assert (t >> (32 * i)) & M32 == 0 and t < 2 ** (64 * w)
    k = ((t >> (32 * (w - 1))) & ((1 << s) - 1)) * nps & ((1 << s) - 1)
    t += (k * p) << (32 * (w - 1))
    assert t % spec.R == 0 and t < 2 ** (64 * w)
    r = t >> (32 * (w - 1) + s)
    words = [(r >> (32 * j)) & M32 for j in range(w)]
    assert val(words) == r
    return unpack(words, n), r


def exact_redc(spec, a, b):
    t = a * b
    m = -t * pow(spec.p, -1, spec.R) % spec.R
    assert (t + m * spec.p) % spec.R == 0
    return (t + m * spec.p) // spec.R


@pytest.mark.parametrize("spec", FIELDS, ids=IDS)
def test_consts_and_shape(spec):
    w, s = cuda_fp.kernel_shape(spec.nlimbs)
    assert (w, s) == {18: (9, 14), 26: (13, 6), 51: (24, 29)}[spec.nlimbs]
    assert 32 * (w - 1) + s == 15 * spec.nlimbs
    c = cuda_fp.kernel_consts_list(spec)
    assert sum(v << (32 * j) for j, v in enumerate(c[:w])) == spec.p
    assert c[w] * spec.p % 2**32 == M32 and (c[w + 1] * spec.p + 1) % 2**s == 0
    assert list(cuda_fp._kernel_consts(spec)) == c


@pytest.mark.parametrize("spec", FIELDS, ids=IDS)
def test_word_model_is_exact_redc_and_agrees_with_plain(spec):
    p = spec.p
    for a, b in cases(spec, seed=7):
        plain = cuda_fp.mont_mul_plain(spec, torch.as_tensor(a), torch.as_tensor(b)).numpy()
        for row_a, row_b, row_plain in zip(a, b, plain):
            va, vb = TL.limbs_to_int(row_a), TL.limbs_to_int(row_b)
            assert va * vb * 2 <= spec.R * p
            limbs, r = model(spec, row_a, row_b)
            assert r == exact_redc(spec, va, vb)
            assert r < 3 * p // 2 and max(limbs) < 2**15 and TL.limbs_to_int(limbs) == r
            vp = TL.limbs_to_int(row_plain)
            assert vp < 2 * p and (vp - r) % p == 0 and vp - r in (0, p)
    a, consts = const_b_case(spec, seed=8)
    for cb in consts:
        plain = cuda_fp.mont_mul_plain(spec, torch.as_tensor(a), torch.as_tensor(cb)).numpy()
        for row_a, row_plain in zip(a, plain):
            limbs, r = model(spec, row_a, cb)
            assert r == exact_redc(spec, TL.limbs_to_int(row_a), TL.limbs_to_int(cb))
            assert max(limbs) < 2**15 and (TL.limbs_to_int(row_plain) - r) % p == 0


# ---- the header, built with g++ -----------------------------------------

HOST_SHIM = r"""
// mont.cuh on the host: the PTX carry primitives become functions that keep
// the carry flag in a variable.
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define ZK_CARRY_CUH
namespace zk {
static uint32_t cf;
inline uint32_t put(uint64_t s, bool keep) { if (keep) cf = uint32_t(s >> 32); return uint32_t(s); }
inline uint64_t lo(uint32_t a, uint32_t b) { return uint32_t(uint64_t(a) * b); }
inline uint64_t hi(uint32_t a, uint32_t b) { return (uint64_t(a) * b) >> 32; }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return put(uint64_t(a) + b + cf, true); }
inline uint32_t addc(uint32_t a, uint32_t b) { return put(uint64_t(a) + b + cf, false); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return put(lo(a, b) + c, true); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return put(lo(a, b) + c + cf, true); }
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return put(hi(a, b) + c, true); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return put(hi(a, b) + c + cf, true); }
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return put(hi(a, b) + c + cf, false); }
}  // namespace zk
#include "mont.cuh"

template <int N>
static void rows(const int64_t* a, const int64_t* b, int b_const, const int64_t* k,
                 int64_t* out, int64_t count) {
  constexpr int W = zk::MontShape<N>::W;
  zk::MontConsts<W> c;
  for (int j = 0; j < W; ++j) c.p[j] = uint32_t(k[j]);
  c.np = uint32_t(k[W]);
  c.nps = uint32_t(k[W + 1]);
  for (int64_t e = 0; e < count; ++e) {
    uint32_t la[N], lb[N], x[W], y[W], r[W], lo[N];
    for (int i = 0; i < N; ++i) {
      la[i] = uint32_t(a[e * N + i]);
      lb[i] = uint32_t(b[(b_const ? 0 : e) * N + i]);
    }
    zk::pack<N>(la, x);
    zk::pack<N>(lb, y);
    zk::mont_mul<N>(x, y, c, r);
    zk::unpack<N>(r, lo);
    for (int i = 0; i < N; ++i) out[e * N + i] = lo[i];
  }
}

extern "C" int host_mont_mul(int n, const int64_t* a, const int64_t* b, int b_const,
                             const int64_t* k, int64_t* out, int64_t count) {
  switch (n) {
    case 18: rows<18>(a, b, b_const, k, out, count); return 0;
    case 26: rows<26>(a, b, b_const, k, out, count); return 0;
    case 51: rows<51>(a, b, b_const, k, out, count); return 0;
    default: return 1;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("mont_host")
    src, lib = d / "mont_host.cpp", d / "mont_host.so"
    src.write_text(HOST_SHIM)
    out = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                          "-o", str(lib), str(src)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    so = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    so.host_mont_mul.argtypes = [ctypes.c_int, p, p, ctypes.c_int, p, p, ctypes.c_int64]
    so.host_mont_mul.restype = ctypes.c_int
    return so


def _host(so, spec, a, b):
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    k = np.asarray(cuda_fp.kernel_consts_list(spec), dtype=np.int64)
    out = np.zeros_like(a)
    rc = so.host_mont_mul(spec.nlimbs, a.ctypes.data, b.ctypes.data, int(b.ndim == 1),
                          k.ctypes.data, out.ctypes.data, a.shape[0])
    assert rc == 0
    return out


@pytest.mark.parametrize("spec", FIELDS, ids=IDS)
def test_header_built_for_the_host_matches_the_model(spec, host_lib):
    for a, b in cases(spec, seed=9):
        got = _host(host_lib, spec, a, b)
        want = np.asarray([model(spec, ra, rb)[0] for ra, rb in zip(a, b)])
        np.testing.assert_array_equal(got, want)
    a, consts = const_b_case(spec, seed=10)
    for cb in consts:
        got = _host(host_lib, spec, a, cb)
        want = np.asarray([model(spec, ra, cb)[0] for ra in a])
        np.testing.assert_array_equal(got, want)


# ---- the wrapper's layout ------------------------------------------------


def _walk(dims, e):
    """Limb offsets of elements e (a tensor) in a and b, as `row_offsets` in
    mont_mul.cu computes them (innermost dimension last)."""
    oa = ob = 0
    for size, sa, sb in reversed(dims[1:]):
        e, i = e // size, e % size
        oa, ob = oa + i * sa, ob + i * sb
    return oa + e * dims[0][1], ob + e * dims[0][2]


def _assert_walk_reaches(a, b, ka, kb, dims, swapped=False):
    """Every element's limbs sit where the kernel's walk of ``dims`` looks
    for them in the storage of ka and kb."""
    n = a.shape[-1]
    want = torch.broadcast_tensors(a, b)[::-1] if swapped else torch.broadcast_tensors(a, b)
    assert ka.stride(-1) == 1 and kb.stride(-1) == 1
    oa, ob = _walk(dims, torch.arange(want[0][..., 0].numel()))
    limb = torch.arange(n)
    for k, off, rows in ((ka, oa, want[0]), (kb, ob, want[1])):
        store = torch.empty(0, dtype=torch.int64).set_(k.untyped_storage())
        got = store[k.storage_offset() + off[:, None] + limb]
        assert torch.equal(got, rows.reshape(-1, n))


def _layout_cases():
    """name -> (a, b, copies the wrapper makes, most dimensions left)."""
    n = TL.FR.nlimbs
    x = torch.arange(3 * 64 * n, dtype=torch.int64).reshape(3, 64, n)
    y = x.reshape(3, 4, 16, n)
    tw = torch.arange(8 * n, dtype=torch.int64).reshape(8, n)
    wide = torch.arange(3 * 64 * 2 * n, dtype=torch.int64).reshape(3, 64, 2 * n)
    six = torch.arange(3 ** 6 * n, dtype=torch.int64).reshape((3,) * 6 + (n,))
    return {
        "ntt-odd-x-twiddles": (y[..., 8:, :], tw, 0, 2),
        "3x1-by-1x5": (x[0, :3, None, :], x[1, None, :5, :], 0, 2),
        "sliced-a": (x[:, 1::3, :], x[:, :21, :], 0, 2),
        "const-b": (x, tw[3], 0, 1),
        "const-a": (tw[2], x[1:, ::2, :], 0, 2),
        "six-dims": (six[:, ::2, :, ::2, :, ::2], tw[5], 1, 1),
        "limb-stride-2": (wide[..., ::2], wide[1, :, ::2], 2, 2),
    }


@pytest.mark.parametrize("name", list(_layout_cases()))
def test_layout_reaches_every_element(name):
    """`cuda_fp.kernel_operands` on strided and broadcast views: the
    kernel's walk of the merged layout finds every element's limbs, and only
    a limb axis off stride 1 or a layout past 4 dimensions costs a copy."""
    from zkmpc_tpu_torch.ops import build as K
    a, b, copies, ndims = _layout_cases()[name]
    n = a.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    K.reset_launches()
    ka, kb, dims = cuda_fp.kernel_operands(batch, a, b)
    assert K.LAUNCHES[cuda_fp.COPY_COUNT] == copies
    assert len(dims) <= ndims and not (any(d[2] for d in dims) and not any(d[1] for d in dims))
    _assert_walk_reaches(a, b, ka, kb, dims, swapped=name == "const-a")


@pytest.mark.parametrize("spec", FIELDS, ids=IDS)
def test_layout_of_the_views_the_card_is_held_to(spec):
    """`chip_smoke.k1_views` (a sliced a, NTT odd views times twiddles,
    [3, 1] x [1, 5]) need no copy and are walked right."""
    from zkmpc_tpu_torch.ops import build as K
    for name, a, b in k1_views(spec, CPU, seed=3):
        batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        K.reset_launches()
        ka, kb, dims = cuda_fp.kernel_operands(batch, a, b)
        assert sum(K.LAUNCHES.values()) == 0, name
        assert len(dims) <= 2, (name, dims)
        _assert_walk_reaches(a, b, ka, kb, dims)


@pytest.mark.parametrize("spec", FIELDS, ids=IDS)
def test_chip_check_takes_the_model_and_refuses_wrong_outputs(spec):
    """`chip_smoke.check_k1`, which holds the card's K1 to its plain
    version, passes the model's outputs and refuses a value off by one, a
    value at or above 2p and a limb of 2^15."""
    a, b = next((a, b) for name, a, b in k1_cases(spec, seed=11) if name.startswith("edge"))
    want = cuda_fp.mont_mul_plain(spec, torch.as_tensor(a), torch.as_tensor(b))
    vals = [model(spec, ra, rb)[1] for ra, rb in zip(a, b)]
    got = torch.as_tensor(np.stack([TL.int_to_limbs(v, spec.nlimbs) for v in vals]))
    assert check_k1(spec, got, want) == 0
    bad = [TL.int_to_limbs(vals[0] + 1, spec.nlimbs),
           TL.int_to_limbs(vals[0] + 2 * spec.p, spec.nlimbs),
           TL.int_to_limbs(vals[0], spec.nlimbs) + np.eye(1, spec.nlimbs, 0, dtype=np.int64)
           * (1 << 15) - np.eye(1, spec.nlimbs, 1, dtype=np.int64)]
    for row in bad:
        wrong = got.clone()
        wrong[0] = torch.as_tensor(row)
        with pytest.raises(AssertionError):
            check_k1(spec, wrong, want)
