// K1's arithmetic on one field element: REDC_R(a*b) = (a*b + m*p) / R at
// R = 2^(15N), in 32-bit words on PTX carry chains.
//
// The tensors hold N relaxed 15-bit limbs (each <= 2^15 + 1, so a limb may
// overlap the next one) and values up to R/2.  A lane
// - packs each operand into W = ceil(15N/32) words, adding the limbs into a
//   running 64-bit accumulator (an OR would lose the overlapping bits);
// - forms T = a*b in 2W words, row by row (mad.lo.cc / madc.hi.cc chains);
// - reduces in W-1 word steps, k = T_i * (-p^-1 mod 2^32), then one step of
//   S = 15N - 32(W-1) bits, k = T_{W-1} * (-p^-1 mod 2^S) mod 2^S: together
//   the k's are m = -T p^-1 mod R, below R, so the result is exactly
//   REDC_R(T), below (R p/2 + R p)/R = 1.5p;
// - shifts the top W+1 words down by S bits and unpacks canonical 15-bit
//   limbs.
// T + m*p < 1.5 R p < 2^(64W), so 2W words and one pending carry word hold
// every partial sum for operands up to R/2.
//
//   N (field)     W   S    R
//   18 (FR)       9   14   8 words + 14 bits
//   26 (FQ)       13  6    12 words + 6 bits
//   51 (MNT4Q)    24  29   23 words + 29 bits
#ifndef ZK_MONT_CUH
#define ZK_MONT_CUH

#include <cstdint>

#include "carry.cuh"

namespace zk {

template <int N>
struct MontShape {
  static constexpr int W = (15 * N + 31) / 32;      // words of a value < R
  static constexpr int S = 15 * N - 32 * (W - 1);   // bits of the last step
  static_assert(S > 0 && S < 32, "R must end inside a word");
};

template <int W>
struct MontConsts {
  uint32_t p[W];
  uint32_t np;    // -p^-1 mod 2^32
  uint32_t nps;   // -p^-1 mod 2^S
};

// N limbs (each < 2^32, value < 2^(32W)) -> W words.  Word w leaves the
// accumulator once every limb below its top bit has come in; only the last
// word is still in it after the loop.
template <int N>
__device__ __forceinline__ void pack(const uint32_t* limbs, uint32_t* x) {
  constexpr int W = MontShape<N>::W;
  static_assert((15 * N) / 32 == W - 1, "one word left after the limbs");
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int w = (15 * i) / 32;      // words out before limb i
    acc += static_cast<uint64_t>(limbs[i]) << (15 * i - 32 * w);
    if ((15 * (i + 1)) / 32 > w) {
      x[w] = static_cast<uint32_t>(acc);
      acc >>= 32;
    }
  }
  x[W - 1] = static_cast<uint32_t>(acc);
}

// W words (value < 2^(15N)) -> N canonical 15-bit limbs.
template <int N>
__device__ __forceinline__ void unpack(const uint32_t* x, uint32_t* limbs) {
  constexpr int W = MontShape<N>::W;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int wi = (15 * i) / 32, sh = (15 * i) % 32;
    uint32_t v = x[wi] >> sh;
    if (sh > 17 && wi + 1 < W) v |= x[wi + 1] << (32 - sh);
    limbs[i] = v & 0x7FFFu;
  }
}

// r = REDC_R(x*y) for x, y < 2^(32W) with x*y < R p/2; r < 1.5p.
template <int N>
__device__ __forceinline__ void mont_mul(const uint32_t* x, const uint32_t* y,
                                         const MontConsts<MontShape<N>::W>& c,
                                         uint32_t* r) {
  constexpr int W = MontShape<N>::W, S = MontShape<N>::S;
  uint32_t t[2 * W];
  // T = x*y: row i adds x*y[i] at word i.  After row i the sum is below
  // 2^(32(W+i+1)), so no carry leaves word i+W.
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = x[j] * y[0];
  t[W] = 0u;
  t[1] = mad_hi_cc(x[0], y[0], t[1]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) t[j + 1] = madc_hi_cc(x[j], y[0], t[j + 1]);
  t[W] = madc_hi(x[W - 1], y[0], t[W]);
#pragma unroll
  for (int i = 1; i < W; ++i) {
    const uint32_t yi = y[i];
    t[i] = mad_lo_cc(x[0], yi, t[i]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[i + j] = madc_lo_cc(x[j], yi, t[i + j]);
    t[i + W] = addc(0u, 0u);
    t[i + 1] = mad_hi_cc(x[0], yi, t[i + 1]);
#pragma unroll
    for (int j = 1; j < W - 1; ++j) t[i + j + 1] = madc_hi_cc(x[j], yi, t[i + j + 1]);
    t[i + W] = madc_hi(x[W - 1], yi, t[i + W]);
  }
  // T += k*p at word i, for W-1 word steps and one S-bit step.  `carry`
  // is what step i still owes word i+W+1 (at most 2).
  uint32_t carry = 0u;
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const uint32_t k = t[i] * c.np;
    t[i] = mad_lo_cc(k, c.p[0], t[i]);                // 0
#pragma unroll
    for (int j = 1; j < W; ++j) t[i + j] = madc_lo_cc(k, c.p[j], t[i + j]);
    t[i + W] = addc_cc(t[i + W], carry);
    carry = addc(0u, 0u);
    t[i + 1] = mad_hi_cc(k, c.p[0], t[i + 1]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[i + j + 1] = madc_hi_cc(k, c.p[j], t[i + j + 1]);
    carry = addc(carry, 0u);
  }
  {
    constexpr int i = W - 1;
    const uint32_t k = (t[i] * c.nps) & ((1u << S) - 1u);
    t[i] = mad_lo_cc(k, c.p[0], t[i]);                // low S bits 0
#pragma unroll
    for (int j = 1; j < W; ++j) t[i + j] = madc_lo_cc(k, c.p[j], t[i + j]);
    t[i + W] = addc(t[i + W], carry);
    t[i + 1] = mad_hi_cc(k, c.p[0], t[i + 1]);
#pragma unroll
    for (int j = 1; j < W - 1; ++j) t[i + j + 1] = madc_hi_cc(k, c.p[j], t[i + j + 1]);
    t[2 * W - 1] = madc_hi(k, c.p[W - 1], t[2 * W - 1]);
  }
  // (T + m p) / R: words W-1 .. 2W-1 shifted down by S bits
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = (t[W - 1 + j] >> S) | (t[W + j] << (32 - S));
}

}  // namespace zk

#endif  // ZK_MONT_CUH
