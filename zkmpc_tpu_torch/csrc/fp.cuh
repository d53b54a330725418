// Field arithmetic on 15-bit limbs, one field element per thread.
//
// Shared by mont_mul.cu (K1) and point_add.cu (K2/K3).  The limb algorithm
// is the reference's (zkmpc_tpu/ops/pallas_fp.py `_mont_kernel`, and
// zkmpc_tpu/ops/limbs.py `_mont_mul_limbs`): every limb product a_i*b_j
// (< 2^31, limbs <= B+1) splits into its low 15 bits, summed into column
// i+j, and its high part, summed into column i+j+1; columns stay < 2^26 in
// 32-bit registers; two relaxed carry passes bring them back to limbs <= B.
// Summing the same integers in a different order gives the same columns,
// so the output limbs are bit-identical to the XLA and Pallas paths.
#pragma once

#include <cstdint>

#define ZK_W 15
#define ZK_MASK 0x7FFFu

namespace zk {

// cols[2*NA... ] full convolution columns of x[NA] and y[NB], TOTAL columns
// kept (contributions to columns >= TOTAL are dropped).
template <int NA, int NB, int TOTAL>
__device__ __forceinline__ void conv(const uint32_t* x, const uint32_t* y,
                                     uint32_t* cols) {
#pragma unroll
  for (int k = 0; k < TOTAL; ++k) cols[k] = 0u;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (i + j < TOTAL) {
        const uint32_t p = x[i] * y[j];
        cols[i + j] += p & ZK_MASK;
        if (i + j + 1 < TOTAL) cols[i + j + 1] += p >> ZK_W;
      }
    }
  }
}

// Two relaxed carry passes (limbs._resolve2): L columns -> L+1 limbs <= B.
template <int L>
__device__ __forceinline__ void resolve2(const uint32_t* cols, uint32_t* z) {
  uint32_t y[L + 1];
  y[0] = cols[0] & ZK_MASK;
#pragma unroll
  for (int k = 1; k < L; ++k) y[k] = (cols[k] & ZK_MASK) + (cols[k - 1] >> ZK_W);
  y[L] = cols[L - 1] >> ZK_W;
  z[0] = y[0] & ZK_MASK;
#pragma unroll
  for (int k = 1; k <= L; ++k) z[k] = (y[k] & ZK_MASK) + (y[k - 1] >> ZK_W);
}

// Montgomery REDC(a*b) (< 2p, limbs <= B) given p' and p limbs.
template <int N>
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b,
                                         const uint32_t* pp, const uint32_t* p,
                                         uint32_t* out) {
  uint32_t tc[2 * N];
  conv<N, N, 2 * N>(a, b, tc);
  uint32_t t[2 * N + 1];
  resolve2<2 * N>(tc, t);
  uint32_t mc[N];
  conv<N, N, N>(t, pp, mc);          // m = T*p' mod R: low half only
  uint32_t m[N + 1];
  resolve2<N>(mc, m);
  uint32_t uc[2 * N];
  conv<N, N, 2 * N>(m, p, uc);
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) uc[k] += tc[k];
  uint32_t u[2 * N + 1];
  resolve2<2 * N>(uc, u);
  // the low half is 0 or exactly R: carry one into the result iff nonzero
  uint32_t any = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) any |= u[k];
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = u[N + k];
  out[0] += (any != 0u) ? 1u : 0u;
}

}  // namespace zk
