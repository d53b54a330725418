// K2/K3: complete short-Weierstrass (a = 0) Jacobian point addition over
// FQ (G1, K2) and over Fq2 = FQ[u]/(u^2 + 5) (G2, K3), for the H100 (sm_90a).
//
// Replaces zkmpc_tpu/ops/pallas_point.py `_point_add_kernel` (K2) and
// `_point_add_kernel_g2` (K3), built by `_point_add_call`, called by
// `sw_add_complete_pallas`.  The whole complete add runs in one kernel, as
// there: add-2007-bl, dbl-2009-l for p == q, exact canonical h == 0 and
// r == 0 tests (`KCtx.is_zero`), the negation case, and both infinity
// fallbacks.  The lazy-bound field arithmetic mirrors `KCtx`/`KF2`
// (pallas_point.py:109-272): every value carries a bound (value < bound*p),
// and `tighten` runs exactly where KCtx.mul/add/sub/smul run it.  Bounds
// are the same for every thread (they depend only on the formula), so the
// bound branches never diverge.
//
// Design: one thread per lane (one point pair).  Inputs are [size, NC, N]
// int64 coordinate limbs at bound <= 2 (NC = 3 for G1, 6 for G2: x0 x1 y0
// y1 z0 z1) plus uint8 infinity flags.  What bounds it on the card is
// integer multiply-adds per lane -- about 30 Montgomery multiplies (G1) or
// 80 (G2) of ~2,100 IMADs each -- and register pressure: a lane holds
// dozens of 26-limb values, far beyond 255 registers, so they live in local
// memory (cached in L1).  Every helper is inlined into the kernel except
// the Montgomery REDC (`fe_redc`) and, for K3, the Fq2 multiply and square:
// the REDC's unrolled code is one out-of-line copy that the ~30 / ~80
// multiplies call, with its columns in registers.  Inlining the REDC as
// well ran nvcc for over 15 minutes on K3.  With the Fq2 products inlined,
// ptxas gave K3 32 registers and ~85 KB of spill traffic a lane (44 ms at
// 32,768 lanes on the H100); out of line, 17 ms.  Keep the rest inlined: a
// layout that called the whole complete add out of line gave wrong x
// coordinates on G1 for lanes of full warps on the H100 (cause not found;
// this layout agrees with the plain version on every lane).  The field
// constants (p, p', repr(1), the borrow-free subtraction digits for bounds
// 0..16) sit in shared memory.  Register-resident tiling, coalesced limb
// layouts and fewer bytes per limb are later work.
#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int N = 26;          // FQ limbs
constexpr int kMaxSubBound = 16;

struct Ctx {
  uint32_t p[N];
  uint32_t pp[N];
  uint32_t one[N];
  uint32_t sub_d[kMaxSubBound + 1][N];
  int sub_k[kMaxSubBound + 1];
  int budget;
};

struct Fe {
  uint32_t v[N];
  int bound;
};

__device__ __noinline__ void fe_redc(Fe& o, const uint32_t* a,
                                     const uint32_t* b, const Ctx& c) {
  uint32_t x[N], y[N], r[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = a[k];
    y[k] = b[k];
  }
  zk::mont_mul<N>(x, y, c.pp, c.p, r);
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = r[k];
  o.bound = 2;
}

// KCtx.tighten: one REDC by repr(1) unless already at bound <= 2.
__device__ __forceinline__ Fe fe_tighten(const Fe& a, const Ctx& c,
                                         bool force = false) {
  if (a.bound <= 2 && !force) return a;
  Fe o;
  fe_redc(o, a.v, c.one, c);
  return o;
}

// KCtx.mul
__device__ __forceinline__ Fe fe_mul(const Fe& a0, const Fe& b0, const Ctx& c) {
  Fe a = a0, b = b0;
  if (a.bound * b.bound > c.budget) {
    if (a.bound >= b.bound) a = fe_tighten(a, c, true);
    else b = fe_tighten(b, c, true);
  }
  Fe o;
  fe_redc(o, a.v, b.v, c);
  return o;
}

__device__ __forceinline__ void fe_resolve_cols(Fe& o, const uint32_t* cols) {
  uint32_t z[N + 1];
  zk::resolve2<N>(cols, z);
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = z[k];
}

// KCtx.add
__device__ __forceinline__ Fe fe_add(const Fe& a0, const Fe& b0, const Ctx& c) {
  Fe a = a0, b = b0;
  if (a.bound + b.bound > c.budget) {
    if (a.bound >= b.bound) a = fe_tighten(a, c);
    else b = fe_tighten(b, c);
  }
  uint32_t cols[N];
#pragma unroll
  for (int k = 0; k < N; ++k) cols[k] = a.v[k] + b.v[k];
  Fe o;
  fe_resolve_cols(o, cols);
  o.bound = a.bound + b.bound;
  return o;
}

// KCtx.sub: a + (k*p digits - b), borrow-free
__device__ __forceinline__ Fe fe_sub(const Fe& a0, const Fe& b0, const Ctx& c) {
  Fe a = a0, b = b0;
  if (b.bound > kMaxSubBound) b = fe_tighten(b, c);
  const int k = c.sub_k[b.bound];
  if (a.bound + k > c.budget) a = fe_tighten(a, c);
  const uint32_t* d = c.sub_d[b.bound];
  uint32_t cols[N];
#pragma unroll
  for (int j = 0; j < N; ++j) cols[j] = a.v[j] + (d[j] - b.v[j]);
  Fe o;
  fe_resolve_cols(o, cols);
  o.bound = a.bound + k;
  return o;
}

// KCtx.smul (1 <= k < 256)
__device__ __forceinline__ Fe fe_smul(const Fe& a0, int k, const Ctx& c) {
  if (k == 1) return a0;
  Fe a = a0;
  if (a.bound * k > c.budget) a = fe_tighten(a, c);
  uint32_t cols[N];
#pragma unroll
  for (int j = 0; j < N; ++j) cols[j] = a.v[j] * static_cast<uint32_t>(k);
  Fe o;
  fe_resolve_cols(o, cols);
  o.bound = a.bound * k;
  return o;
}

// KCtx.is_zero: exact canonical zero test -> 0/1.
__device__ __forceinline__ uint32_t fe_is_zero_raw(const uint32_t* v,
                                                const Ctx& c) {
  uint32_t y[N + 1];
#pragma unroll
  for (int k = 0; k < N; ++k) y[k] = v[k];
  y[N] = 0u;
  for (int pass = 0; pass < N + 2; ++pass) {
#pragma unroll
    for (int k = N; k >= 1; --k) y[k] = (y[k] & ZK_MASK) + (y[k - 1] >> ZK_W);
    y[0] &= ZK_MASK;
  }
  // lexicographic y >= p (p extended by a zero top limb)
  bool gt_any = false, all_eq = true;
#pragma unroll
  for (int i = N; i >= 0; --i) {
    const uint32_t pi = (i < N) ? c.p[i] : 0u;
    gt_any = gt_any || (all_eq && y[i] > pi);
    all_eq = all_eq && (y[i] == pi);
  }
  const bool ge = gt_any || all_eq;
  int32_t yi[N + 1];
#pragma unroll
  for (int i = 0; i <= N; ++i) {
    const int32_t pi = (i < N) ? static_cast<int32_t>(c.p[i]) : 0;
    yi[i] = static_cast<int32_t>(y[i]) - (ge ? pi : 0);
  }
  for (int pass = 0; pass < N + 2; ++pass) {
#pragma unroll
    for (int k = N; k >= 1; --k)
      yi[k] = (yi[k] & static_cast<int32_t>(ZK_MASK)) + (yi[k - 1] >> ZK_W);
    yi[0] &= static_cast<int32_t>(ZK_MASK);
  }
  int32_t nz = yi[0];
#pragma unroll
  for (int k = 1; k < N; ++k) nz = max(nz, yi[k]);
  return nz == 0 ? 1u : 0u;
}

__device__ __forceinline__ uint32_t fe_is_zero(const Fe& a, const Ctx& c) {
  const Fe t = fe_tighten(a, c);
  return fe_is_zero_raw(t.v, c);
}

__device__ __forceinline__ Fe fe_select(bool m, const Fe& a, const Fe& b) {
  Fe o = m ? a : b;
  o.bound = max(a.bound, b.bound);
  return o;
}

// ---- coordinate fields: F1 = FQ, F2 = Fq2 (u^2 = -5), same interface ----

struct F1 {
  Fe a;
};

__device__ __forceinline__ F1 operator_add(const F1& x, const F1& y, const Ctx& c) {
  return {fe_add(x.a, y.a, c)};
}
__device__ __forceinline__ F1 operator_sub(const F1& x, const F1& y, const Ctx& c) {
  return {fe_sub(x.a, y.a, c)};
}
__device__ __forceinline__ F1 operator_mul(const F1& x, const F1& y, const Ctx& c) {
  return {fe_mul(x.a, y.a, c)};
}
__device__ __forceinline__ F1 smul(const F1& x, int k, const Ctx& c) {
  return {fe_smul(x.a, k, c)};
}
__device__ __forceinline__ F1 square(const F1& x, const Ctx& c) {
  return {fe_mul(x.a, x.a, c)};
}
__device__ __forceinline__ F1 tighten(const F1& x, const Ctx& c) {
  return {fe_tighten(x.a, c)};
}
__device__ __forceinline__ uint32_t is_zero(const F1& x, const Ctx& c) {
  return fe_is_zero(x.a, c);
}
__device__ __forceinline__ F1 select(bool m, const F1& x, const F1& y) {
  return {fe_select(m, x.a, y.a)};
}

struct F2 {
  Fe c0, c1;
};

__device__ __forceinline__ F2 operator_add(const F2& x, const F2& y, const Ctx& c) {
  return {fe_add(x.c0, y.c0, c), fe_add(x.c1, y.c1, c)};
}
__device__ __forceinline__ F2 operator_sub(const F2& x, const F2& y, const Ctx& c) {
  return {fe_sub(x.c0, y.c0, c), fe_sub(x.c1, y.c1, c)};
}
// Karatsuba, mirrors KF2.__mul__
__device__ __noinline__ F2 operator_mul(const F2& x, const F2& y, const Ctx& c) {
  const Fe v0 = fe_mul(x.c0, y.c0, c);
  const Fe v1 = fe_mul(x.c1, y.c1, c);
  const Fe c0 = fe_sub(v0, fe_smul(v1, 5, c), c);
  const Fe s = fe_mul(fe_add(x.c0, x.c1, c), fe_add(y.c0, y.c1, c), c);
  const Fe c1 = fe_sub(fe_sub(s, v0, c), v1, c);
  return {c0, c1};
}
__device__ __forceinline__ F2 smul(const F2& x, int k, const Ctx& c) {
  return {fe_smul(x.c0, k, c), fe_smul(x.c1, k, c)};
}
// mirrors KF2.square: c0 = (a0 + a1)(a0 - 5 a1) + 4 a0 a1, c1 = 2 a0 a1
__device__ __noinline__ F2 square(const F2& x, const Ctx& c) {
  const Fe v0 = fe_mul(x.c0, x.c1, c);
  const Fe l = fe_add(x.c0, x.c1, c);
  const Fe r = fe_sub(x.c0, fe_smul(x.c1, 5, c), c);
  const Fe c0 = fe_add(fe_mul(l, r, c), fe_smul(v0, 4, c), c);
  return {c0, fe_smul(v0, 2, c)};
}
__device__ __forceinline__ F2 tighten(const F2& x, const Ctx& c) {
  return {fe_tighten(x.c0, c), fe_tighten(x.c1, c)};
}
__device__ __forceinline__ uint32_t is_zero(const F2& x, const Ctx& c) {
  return fe_is_zero(x.c0, c) * fe_is_zero(x.c1, c);
}
__device__ __forceinline__ F2 select(bool m, const F2& x, const F2& y) {
  return {fe_select(m, x.c0, y.c0), fe_select(m, x.c1, y.c1)};
}

// dbl-2009-l (a = 0), mirrors pallas_point._kdouble / curve.sw_double
template <class F>
__device__ __forceinline__ void kdouble(const F& x, const F& y, const F& z, F& x3, F& y3,
                        F& z3, const Ctx& c) {
  const F a = square(x, c);
  const F b = square(y, c);
  const F cc = square(b, c);
  const F d = smul(operator_sub(operator_sub(square(operator_add(x, b, c), c),
                                             a, c), cc, c), 2, c);
  const F e = smul(a, 3, c);
  const F f = square(e, c);
  const F xx = operator_sub(f, smul(d, 2, c), c);
  const F yy = operator_sub(operator_mul(e, operator_sub(d, xx, c), c),
                            smul(cc, 8, c), c);
  const F zz = smul(operator_mul(y, z, c), 2, c);
  x3 = tighten(xx, c);
  y3 = tighten(yy, c);
  z3 = tighten(zz, c);
}

// add-2007-bl + case tests + fallbacks, mirrors pallas_point._complete_add
template <class F>
__device__ __forceinline__ void complete_add(const F& px, const F& py, const F& pz,
                             uint32_t pinf, const F& qx, const F& qy,
                             const F& qz, uint32_t qinf, F& ox, F& oy, F& oz,
                             uint32_t& oinf, const Ctx& c) {
  const F z1z1 = square(pz, c);
  const F z2z2 = square(qz, c);
  const F u1 = operator_mul(px, z2z2, c);
  const F u2 = operator_mul(qx, z1z1, c);
  const F s1 = operator_mul(operator_mul(py, qz, c), z2z2, c);
  const F s2 = operator_mul(operator_mul(qy, pz, c), z1z1, c);
  const F h = operator_sub(u2, u1, c);
  const F i = square(smul(h, 2, c), c);
  const F j = operator_mul(h, i, c);
  const F r = smul(operator_sub(s2, s1, c), 2, c);
  const F v = operator_mul(u1, i, c);
  F x3 = operator_sub(operator_sub(square(r, c), j, c), smul(v, 2, c), c);
  F y3 = operator_sub(operator_mul(r, operator_sub(v, x3, c), c),
                      smul(operator_mul(s1, j, c), 2, c), c);
  F z3 = operator_mul(
      operator_sub(operator_sub(square(operator_add(pz, qz, c), c), z1z1, c),
                   z2z2, c),
      h, c);
  x3 = tighten(x3, c);
  y3 = tighten(y3, c);
  z3 = tighten(z3, c);

  const uint32_t h0 = is_zero(h, c);
  const uint32_t r0 = is_zero(r, c);
  const uint32_t finite = (1u - pinf) * (1u - qinf);
  const uint32_t is_dbl = finite * h0 * r0;
  const uint32_t is_neg = finite * h0 * (1u - r0);

  F dx, dy, dz;
  kdouble(px, py, pz, dx, dy, dz, c);
  ox = select(is_dbl != 0u, dx, x3);
  oy = select(is_dbl != 0u, dy, y3);
  oz = select(is_dbl != 0u, dz, z3);
  uint32_t of = (pinf * qinf) | is_neg;
  // infinity fallbacks: q at infinity -> p; p at infinity -> q
  ox = select(qinf != 0u, px, ox);
  oy = select(qinf != 0u, py, oy);
  oz = select(qinf != 0u, pz, oz);
  of = qinf ? pinf : of;
  ox = select(pinf != 0u, qx, ox);
  oy = select(pinf != 0u, qy, oy);
  oz = select(pinf != 0u, qz, oz);
  of = pinf ? qinf : of;
  oinf = of;
}

__device__ __forceinline__ void load_fe(Fe& f, const int64_t* src) {
#pragma unroll
  for (int k = 0; k < N; ++k) f.v[k] = static_cast<uint32_t>(src[k]);
  f.bound = 2;
}

__device__ __forceinline__ void store_fe(int64_t* dst, const Fe& f) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = static_cast<int64_t>(f.v[k]);
}

__device__ __forceinline__ void load(F1 (&x)[3], const int64_t* src) {
  for (int t = 0; t < 3; ++t) load_fe(x[t].a, src + t * N);
}
__device__ __forceinline__ void store(int64_t* dst, const F1& x, const F1& y, const F1& z) {
  store_fe(dst, x.a);
  store_fe(dst + N, y.a);
  store_fe(dst + 2 * N, z.a);
}
__device__ __forceinline__ void load(F2 (&x)[3], const int64_t* src) {
  for (int t = 0; t < 3; ++t) {
    load_fe(x[t].c0, src + (2 * t) * N);
    load_fe(x[t].c1, src + (2 * t + 1) * N);
  }
}
__device__ __forceinline__ void store(int64_t* dst, const F2& x, const F2& y, const F2& z) {
  store_fe(dst, x.c0);
  store_fe(dst + N, x.c1);
  store_fe(dst + 2 * N, y.c0);
  store_fe(dst + 3 * N, y.c1);
  store_fe(dst + 4 * N, z.c0);
  store_fe(dst + 5 * N, z.c1);
}

template <class F, int NC>
__global__ void __launch_bounds__(kThreads)
point_add_kernel(const int64_t* __restrict__ p, const uint8_t* __restrict__ pinf,
                 const int64_t* __restrict__ q, const uint8_t* __restrict__ qinf,
                 int64_t* __restrict__ out, uint8_t* __restrict__ oinf,
                 const int64_t* __restrict__ consts, int64_t size) {
  __shared__ Ctx c;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    c.p[k] = static_cast<uint32_t>(consts[k]);
    c.pp[k] = static_cast<uint32_t>(consts[N + k]);
    c.one[k] = static_cast<uint32_t>(consts[2 * N + k]);
  }
  for (int k = threadIdx.x; k < (kMaxSubBound + 1) * N; k += blockDim.x)
    c.sub_d[k / N][k % N] = static_cast<uint32_t>(consts[3 * N + k]);
  for (int k = threadIdx.x; k <= kMaxSubBound; k += blockDim.x)
    c.sub_k[k] = static_cast<int>(consts[(3 + kMaxSubBound + 1) * N + k]);
  if (threadIdx.x == 0)
    c.budget = static_cast<int>(consts[(3 + kMaxSubBound + 1) * N + kMaxSubBound + 1]);
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size) return;
  F P[3], Q[3], O[3];
  load(P, p + i * NC * N);
  load(Q, q + i * NC * N);
  uint32_t of;
  complete_add<F>(P[0], P[1], P[2], pinf[i] ? 1u : 0u, Q[0], Q[1], Q[2],
                  qinf[i] ? 1u : 0u, O[0], O[1], O[2], of, c);
  store(out + i * NC * N, O[0], O[1], O[2]);
  oinf[i] = static_cast<uint8_t>(of);
}

}  // namespace

extern "C" int zk_point_add(int nlimbs, int g2, const void* p, const void* pinf,
                            const void* q, const void* qinf, void* out,
                            void* oinf, const void* consts, int64_t size,
                            void* stream) {
  if (nlimbs != N) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (size + kThreads - 1) / kThreads;
  auto S = static_cast<cudaStream_t>(stream);
  auto P = static_cast<const int64_t*>(p);
  auto Q = static_cast<const int64_t*>(q);
  auto PI = static_cast<const uint8_t*>(pinf);
  auto QI = static_cast<const uint8_t*>(qinf);
  auto O = static_cast<int64_t*>(out);
  auto OI = static_cast<uint8_t*>(oinf);
  auto C = static_cast<const int64_t*>(consts);
  if (g2) {
    point_add_kernel<F2, 6><<<static_cast<unsigned>(blocks), kThreads, 0, S>>>(
        P, PI, Q, QI, O, OI, C, size);
  } else {
    point_add_kernel<F1, 3><<<static_cast<unsigned>(blocks), kThreads, 0, S>>>(
        P, PI, Q, QI, O, OI, C, size);
  }
  return static_cast<int>(cudaGetLastError());
}
