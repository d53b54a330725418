// K2/K3: complete short-Weierstrass (a = 0) Jacobian point addition over
// FQ (G1, K2) and over Fq2 = FQ[u]/(u^2 + 5) (G2, K3), for the H100 (sm_90a).
//
// Replaces zkmpc_tpu/ops/pallas_point.py `_point_add_kernel` (K2) and
// `_point_add_kernel_g2` (K3), built by `_point_add_call`, called by
// `sw_add_complete_pallas`.  It computes what `_complete_add` computes:
// add-2007-bl, exact h == 0 and r == 0 tests, dbl-2009-l for p == q, the
// q == -p case and both infinity fallbacks.  The same points come out (equal
// affine values and infinity flags), not the same limbs.
//
// What bounds it on this card: 32-bit integer multiply-adds.  A 377-bit
// Montgomery product is about 600 IMADs; a lane of K2 does ~16 of them and
// a lane of K3 ~44, against ~2 KB (K2) or ~4 KB (K3) of limbs in and out,
// so both kernels sit on the compute side of the roofline.  The design
// spends nothing else:
//
// - 32-bit words.  The tensors hold 26 relaxed 15-bit limbs (the TPU's
//   exact-matmul layout) in Montgomery form with R1 = 2^390.  A lane packs
//   each coordinate into 12 words and moves it to R2 = 2^384 once at load
//   ((v + k*p) / 2^6 with k = -v * p^-1 mod 64), and back once at store (6
//   modular doublings, then 15-bit limbs).
// - The Montgomery product is a 12-word CIOS on PTX carry chains
//   (mad.lo.cc / madc.hi.cc / addc.cc).  Since 4p < 2^379 < R2, a product of
//   two values below 2p is below 2p without a final subtraction, and an add
//   or sub brings its result back below 2p with one conditional correction
//   by 2p.  That fixed invariant (every value < 2p) replaces per-value
//   bounds; only the exact zero tests and the store reduce below p.
// - Values in registers.  The converted input coordinates sit in shared
//   memory (one column per lane, conflict-free), read where the formula
//   uses them; the temporaries are ordered for liveness and stay in
//   registers (ptxas: K2 128 registers, K3 244, no spills).  Every helper is
//   inlined.
// - Code that fits the instruction cache.  The CIOS outer loop and the
//   per-coordinate load and store loops stay rolled: fully unrolled, K3 is
//   some 87,000 SASS instructions of straight-line code (18,000 rolled) and
//   ran 1.8x slower (tools/point_add_variants.py).
// - Branches where the TPU selected.  Lanes with an input at infinity skip
//   the formula; dbl-2009-l runs only under `if (h == 0 && r == 0)`, which
//   is rare in a Pippenger stream.
//
// Constants (p, 2p, -p^-1 mod 2^32, p^-1 mod 64) come from the wrapper
// (`cuda_point._kernel_consts`) in host memory and ride in the kernel's
// parameter bank, so the products read them as operands.
#include <cuda_runtime.h>

#include <cstdint>

#include "carry.cuh"

namespace {

constexpr int NW = 12;        // 32-bit words of an FQ element
constexpr int NL = 26;        // 15-bit limbs of an FQ element in the tensors
constexpr int kThreads = 64;  // lanes per block

struct Consts {
  uint32_t p[NW];
  uint32_t p2[NW];    // 2p
  uint32_t np;        // -p^-1 mod 2^32
  uint32_t pinv6;     // p^-1 mod 64
};

using namespace zk;  // the PTX carry-chain primitives of carry.cuh

// ---- FQ in 12 words, Montgomery radix 2^384, values < 2p ----------------

struct Fq {
  uint32_t w[NW];
};

// r = s >= m ? s - m : s  (s < 2m)
__device__ __forceinline__ Fq csub(const Fq& s, const uint32_t (&m)[NW]) {
  Fq d;
  d.w[0] = sub_cc(s.w[0], m[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(s.w[j], m[j]);
  const uint32_t borrow = subc(0u, 0u);
#pragma unroll
  for (int j = 0; j < NW; ++j) d.w[j] = borrow ? s.w[j] : d.w[j];
  return d;
}

__device__ __forceinline__ Fq add(const Fq& a, const Fq& b, const Consts& c) {
  Fq s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) s.w[j] = addc_cc(a.w[j], b.w[j]);
  s.w[NW - 1] = addc(a.w[NW - 1], b.w[NW - 1]);
  return csub(s, c.p2);
}

__device__ __forceinline__ Fq sub(const Fq& a, const Fq& b, const Consts& c) {
  Fq d;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(a.w[j], b.w[j]);
  const uint32_t mask = subc(0u, 0u);     // all ones iff a < b: add 2p back
  d.w[0] = add_cc(d.w[0], c.p2[0] & mask);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) d.w[j] = addc_cc(d.w[j], c.p2[j] & mask);
  d.w[NW - 1] = addc(d.w[NW - 1], c.p2[NW - 1] & mask);
  return d;
}

__device__ __forceinline__ Fq dbl(const Fq& a, const Consts& c) { return add(a, a, c); }

// CIOS Montgomery product a*b/2^384 mod p.  t stays below a + p < 2^380
// between rounds, so 13 words hold every partial sum and the result needs
// no 13th word; for a, b < 2p the result is below p + p/32.  The outer loop
// stays rolled (b's words rotate through bw[0]) to keep the code small.
__device__ __forceinline__ Fq mul(const Fq& a, const Fq& b, const Consts& c) {
  uint32_t t[NW + 1], bw[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    t[j] = 0u;
    bw[j] = b.w[j];
  }
#pragma unroll 1
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = bw[0];
    t[0] = mad_lo_cc(a.w[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(a.w[j], bi, t[j]);
    t[NW] = addc(0u, 0u);
    t[1] = mad_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < NW - 1; ++j) t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
    t[NW] = madc_hi(a.w[NW - 1], bi, t[NW]);
    const uint32_t m = t[0] * c.np;
    t[0] = mad_lo_cc(c.p[0], m, t[0]);          // 0, with its carry
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(c.p[j], m, t[j]);
    t[NW] = addc(t[NW], 0u);
    t[1] = mad_hi_cc(c.p[0], m, t[1]);
#pragma unroll
    for (int j = 1; j < NW - 1; ++j) t[j + 1] = madc_hi_cc(c.p[j], m, t[j + 1]);
    t[NW] = madc_hi(c.p[NW - 1], m, t[NW]);
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) bw[j] = bw[j + 1];
  }
  Fq r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
  return r;
}

__device__ __forceinline__ Fq sqr(const Fq& a, const Consts& c) { return mul(a, a, c); }

__device__ __forceinline__ bool is_zero(const Fq& a, const Consts& c) {
  const Fq r = csub(a, c.p);
  uint32_t acc = r.w[0];
#pragma unroll
  for (int j = 1; j < NW; ++j) acc |= r.w[j];
  return acc == 0u;
}

// 26 relaxed 15-bit limbs (value < 2p, Montgomery radix 2^390) -> 12 words
// at radix 2^384: (v + k*p) / 64 with v + k*p = 0 mod 64, < 65p/64.
__device__ __forceinline__ Fq load_fq(const int64_t* src, const Consts& c) {
  uint32_t v[NW];
  uint64_t acc = 0;
  int w = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    acc += static_cast<uint64_t>(static_cast<uint32_t>(src[i])) << (15 * i - 32 * w);
    if (w < NW && 15 * (i + 1) >= 32 * (w + 1)) {
      v[w++] = static_cast<uint32_t>(acc);
      acc >>= 32;
    }
  }
  const uint32_t k = (0u - v[0] * c.pinv6) & 63u;
  uint32_t u[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s = static_cast<uint64_t>(v[j]) +
                       static_cast<uint64_t>(c.p[j]) * k + carry;
    u[j] = static_cast<uint32_t>(s);
    carry = s >> 32;
  }
  Fq r;
#pragma unroll
  for (int j = 0; j < NW - 1; ++j) r.w[j] = (u[j] >> 6) | (u[j + 1] << 26);
  r.w[NW - 1] = u[NW - 1] >> 6;
  return r;
}

// 12 words at radix 2^384 (< 2p) -> canonical 15-bit limbs at radix 2^390:
// reduce below p, then 6 doublings mod p.
__device__ __forceinline__ void store_fq(int64_t* dst, const Fq& a, const Consts& c) {
  Fq x = csub(a, c.p);
#pragma unroll 1
  for (int s = 0; s < 6; ++s) {
    Fq d;
    d.w[0] = add_cc(x.w[0], x.w[0]);
#pragma unroll
    for (int j = 1; j < NW - 1; ++j) d.w[j] = addc_cc(x.w[j], x.w[j]);
    d.w[NW - 1] = addc(x.w[NW - 1], x.w[NW - 1]);
    x = csub(d, c.p);
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int wi = (15 * i) / 32, sh = (15 * i) % 32;
    uint32_t v = x.w[wi] >> sh;
    if (sh > 17 && wi + 1 < NW) v |= x.w[wi + 1] << (32 - sh);
    dst[i] = static_cast<int64_t>(v & 0x7FFFu);
  }
}

// ---- coordinate fields: F1 = FQ, F2 = Fq2 (u^2 = -5), same interface ----

struct F1 {
  Fq a;
  static constexpr int kParts = 1;
};

__device__ __forceinline__ F1 add(const F1& x, const F1& y, const Consts& c) {
  return {add(x.a, y.a, c)};
}
__device__ __forceinline__ F1 sub(const F1& x, const F1& y, const Consts& c) {
  return {sub(x.a, y.a, c)};
}
__device__ __forceinline__ F1 dbl(const F1& x, const Consts& c) { return {dbl(x.a, c)}; }
__device__ __forceinline__ F1 mul(const F1& x, const F1& y, const Consts& c) {
  return {mul(x.a, y.a, c)};
}
__device__ __forceinline__ F1 sqr(const F1& x, const Consts& c) { return {sqr(x.a, c)}; }
__device__ __forceinline__ bool is_zero(const F1& x, const Consts& c) {
  return is_zero(x.a, c);
}

struct F2 {
  Fq c0, c1;
  static constexpr int kParts = 2;
};

__device__ __forceinline__ F2 add(const F2& x, const F2& y, const Consts& c) {
  return {add(x.c0, y.c0, c), add(x.c1, y.c1, c)};
}
__device__ __forceinline__ F2 sub(const F2& x, const F2& y, const Consts& c) {
  return {sub(x.c0, y.c0, c), sub(x.c1, y.c1, c)};
}
__device__ __forceinline__ F2 dbl(const F2& x, const Consts& c) {
  return {dbl(x.c0, c), dbl(x.c1, c)};
}
__device__ __forceinline__ Fq times5(const Fq& x, const Consts& c) {
  return add(dbl(dbl(x, c), c), x, c);
}
// Karatsuba: c0 = x0 y0 - 5 x1 y1, c1 = (x0 + x1)(y0 + y1) - x0 y0 - x1 y1
__device__ __forceinline__ F2 mul(const F2& x, const F2& y, const Consts& c) {
  const Fq v0 = mul(x.c0, y.c0, c);
  const Fq v1 = mul(x.c1, y.c1, c);
  const Fq s = mul(add(x.c0, x.c1, c), add(y.c0, y.c1, c), c);
  return {sub(v0, times5(v1, c), c), sub(sub(s, v0, c), v1, c)};
}
// c0 = (x0 + x1)(x0 - 5 x1) + 4 x0 x1, c1 = 2 x0 x1
__device__ __forceinline__ F2 sqr(const F2& x, const Consts& c) {
  const Fq v0 = mul(x.c0, x.c1, c);
  const Fq l = mul(add(x.c0, x.c1, c), sub(x.c0, times5(x.c1, c), c), c);
  const Fq v2 = dbl(v0, c);
  return {add(l, dbl(v2, c), c), v2};
}
__device__ __forceinline__ bool is_zero(const F2& x, const Consts& c) {
  return is_zero(x.c0, c) & is_zero(x.c1, c);
}

// ---- one lane ------------------------------------------------------------

// This lane's converted input coordinates in shared memory: word j of part
// `slot` at s[(slot * NW + j) * kThreads].  Slots 0..NC-1 hold P, NC..2NC-1
// hold Q, in the tensors' order (x0 x1 y0 y1 z0 z1 for G2).
struct Stash {
  uint32_t* s;

  __device__ __forceinline__ void put(int slot, const Fq& v) const {
#pragma unroll
    for (int j = 0; j < NW; ++j) s[(slot * NW + j) * kThreads] = v.w[j];
  }
  __device__ __forceinline__ Fq get(int slot) const {
    Fq v;
#pragma unroll
    for (int j = 0; j < NW; ++j) v.w[j] = s[(slot * NW + j) * kThreads];
    return v;
  }
};

// coordinate `coord` (0 x, 1 y, 2 z) of point `pt` (0 P, 1 Q)
__device__ __forceinline__ void get(F1& f, const Stash& st, int pt, int coord) {
  f.a = st.get(pt * 3 + coord);
}
__device__ __forceinline__ void get(F2& f, const Stash& st, int pt, int coord) {
  f.c0 = st.get(pt * 6 + 2 * coord);
  f.c1 = st.get(pt * 6 + 2 * coord + 1);
}
template <class F>
__device__ __forceinline__ F coord(const Stash& st, int pt, int c) {
  F f;
  get(f, st, pt, c);
  return f;
}

__device__ __forceinline__ void store(int64_t* dst, const F1& x, const Consts& c) {
  store_fq(dst, x.a, c);
}
__device__ __forceinline__ void store(int64_t* dst, const F2& x, const Consts& c) {
  store_fq(dst, x.c0, c);
  store_fq(dst + NL, x.c1, c);
}

// dbl-2009-l (a = 0) of P
template <class F>
__device__ __forceinline__ void double_p(const Stash& st, F& x3, F& y3, F& z3,
                                         const Consts& c) {
  const F x = coord<F>(st, 0, 0);
  const F y = coord<F>(st, 0, 1);
  const F a = sqr(x, c);
  const F b = sqr(y, c);
  const F cc = sqr(b, c);
  const F d = dbl(sub(sub(sqr(add(x, b, c), c), a, c), cc, c), c);
  const F e = add(dbl(a, c), a, c);
  x3 = sub(sqr(e, c), dbl(d, c), c);
  y3 = sub(mul(e, sub(d, x3, c), c), dbl(dbl(dbl(cc, c), c), c), c);
  z3 = dbl(mul(y, coord<F>(st, 0, 2), c), c);
}

template <class F>
__device__ __forceinline__ void lane(const int64_t* p, bool pinf, const int64_t* q,
                                     bool qinf, int64_t* out, uint8_t* oinf,
                                     const Stash& st, const Consts& c) {
  constexpr int NC = 3 * F::kParts;
#pragma unroll 1
  for (int k = 0; k < NC; ++k) {
    st.put(k, load_fq(p + k * NL, c));
    st.put(NC + k, load_fq(q + k * NL, c));
  }
  F x3, y3, z3;
  bool inf;
  if (!pinf && !qinf) {
    // add-2007-bl, ordered so that few values are live at once;
    // z3 = ((z1 + z2)^2 - z1z1 - z2z2) * h as in the reference
    const F z1 = coord<F>(st, 0, 2);
    const F z2 = coord<F>(st, 1, 2);
    const F z1z1 = sqr(z1, c);
    const F z2z2 = sqr(z2, c);
    const F w = sub(sub(sqr(add(z1, z2, c), c), z1z1, c), z2z2, c);
    const F u2 = mul(coord<F>(st, 1, 0), z1z1, c);
    const F s2 = mul(mul(coord<F>(st, 1, 1), z1, c), z1z1, c);
    const F u1 = mul(coord<F>(st, 0, 0), z2z2, c);
    const F s1 = mul(mul(coord<F>(st, 0, 1), z2, c), z2z2, c);
    const F h = sub(u2, u1, c);
    const F r = dbl(sub(s2, s1, c), c);
    const bool h0 = is_zero(h, c);
    const bool r0 = is_zero(r, c);
    z3 = mul(w, h, c);
    const F i = sqr(dbl(h, c), c);
    const F j = mul(h, i, c);
    const F v = mul(u1, i, c);
    x3 = sub(sub(sqr(r, c), j, c), dbl(v, c), c);
    const F s1j = mul(s1, j, c);
    y3 = sub(mul(r, sub(v, x3, c), c), dbl(s1j, c), c);
    inf = h0 && !r0;                  // q == -p
    if (h0 && r0) double_p<F>(st, x3, y3, z3, c);
  } else {
    // p at infinity -> q; q at infinity -> p
    const int pt = pinf ? 1 : 0;
    x3 = coord<F>(st, pt, 0);
    y3 = coord<F>(st, pt, 1);
    z3 = coord<F>(st, pt, 2);
    inf = pinf && qinf;
  }
  store(out, x3, c);
  store(out + F::kParts * NL, y3, c);
  store(out + 2 * F::kParts * NL, z3, c);
  *oinf = inf ? 1 : 0;
}

template <class F>
__global__ void __launch_bounds__(kThreads)
point_add_kernel(const int64_t* __restrict__ p, const uint8_t* __restrict__ pinf,
                 const int64_t* __restrict__ q, const uint8_t* __restrict__ qinf,
                 int64_t* __restrict__ out, uint8_t* __restrict__ oinf,
                 const __grid_constant__ Consts c, int64_t size) {
  constexpr int NC = 3 * F::kParts;
  __shared__ uint32_t stash[2 * NC * NW * kThreads];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= size) return;
  const Stash st{stash + threadIdx.x};
  lane<F>(p + i * NC * NL, pinf[i] != 0, q + i * NC * NL, qinf[i] != 0,
          out + i * NC * NL, oinf + i, st, c);
}

}  // namespace

// consts: host memory, int64 [2 * 12 + 2]: p and 2p as 32-bit words (low
// word first), -p^-1 mod 2^32, p^-1 mod 64 (`cuda_point._kernel_consts`).
extern "C" int zk_point_add(int nlimbs, int g2, const void* p, const void* pinf,
                            const void* q, const void* qinf, void* out,
                            void* oinf, const void* consts, int64_t size,
                            void* stream) {
  if (nlimbs != NL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = static_cast<const int64_t*>(consts);
  Consts c;
  for (int j = 0; j < NW; ++j) {
    c.p[j] = static_cast<uint32_t>(k[j]);
    c.p2[j] = static_cast<uint32_t>(k[NW + j]);
  }
  c.np = static_cast<uint32_t>(k[2 * NW]);
  c.pinv6 = static_cast<uint32_t>(k[2 * NW + 1]);
  const int64_t blocks = (size + kThreads - 1) / kThreads;
  auto S = static_cast<cudaStream_t>(stream);
  auto P = static_cast<const int64_t*>(p);
  auto Q = static_cast<const int64_t*>(q);
  auto PI = static_cast<const uint8_t*>(pinf);
  auto QI = static_cast<const uint8_t*>(qinf);
  auto O = static_cast<int64_t*>(out);
  auto OI = static_cast<uint8_t*>(oinf);
  if (g2) {
    point_add_kernel<F2><<<static_cast<unsigned>(blocks), kThreads, 0, S>>>(
        P, PI, Q, QI, O, OI, c, size);
  } else {
    point_add_kernel<F1><<<static_cast<unsigned>(blocks), kThreads, 0, S>>>(
        P, PI, Q, QI, O, OI, c, size);
  }
  return static_cast<int>(cudaGetLastError());
}
