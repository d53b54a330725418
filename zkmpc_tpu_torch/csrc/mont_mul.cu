// K1: batched Montgomery multiplication, REDC_R(a*b) at R = 2^(15N), for
// the H100 (sm_90a).
//
// Replaces zkmpc_tpu/ops/pallas_fp.py `_mont_kernel` (built by `_mont_call`,
// called by `mont_mul_pallas`, routed from limbs._mont_mul_limbs).  It gives
// the same values, not the same limbs: the output is exactly REDC_R(a*b),
// below 1.5p, as canonical 15-bit limbs; the plain version and the
// reference may return that value plus p.
//
// What bounds it on this card: bytes.  The tensors hold 15-bit limbs in
// int64, about 4.3x the bytes the values need, and a product in 32-bit
// words (mont.cuh) is about 4W^2 IMADs: 324 for FR against 432 B in and out
// per element, some 0.75 IMAD a byte where the card does about 5.  The
// design spends nothing but the bytes it must move:
//
// - Coalesced traffic through shared memory.  A block stages its tile of a,
//   and of b unless b is one constant row, with the threads reading
//   consecutive limbs together: 16-byte loads where every row of the
//   operand is 16-byte aligned, 8-byte loads otherwise.  The low 32 bits of
//   each limb go to shared memory with the row stride padded to an odd
//   count of words, so each thread then reads its own row without bank
//   conflicts.  The output is staged the same way and written back as one
//   contiguous run.  Plain vector loads, not a TMA bulk copy: a tile's
//   rows may be strided or broadcast, which a 1-D bulk copy cannot gather.
// - Strided and broadcast operands in the kernel.  Each operand comes with
//   its batch sizes and strides (up to 4 batch dimensions, after the
//   wrapper merges the ones it can; stride 0 for a broadcast dimension), so
//   a sliced view or a broadcast table is read where it lies, with no copy.
// - All loads of a tile issued before any is used: a and b each have their
//   own tile (FR and FQ: 128 lanes a block; MNT4Q: 64, to stay within 48 KB
//   of static shared memory).
// - The arithmetic fully unrolled: the product and reduction are a few
//   thousand instructions even at N = 51, far from the instruction-cache
//   trouble of K3's straight-line code.
//
// Constants (p in words, -p^-1 mod 2^32, -p^-1 mod 2^S) and the operands'
// layout come from the wrapper (`cuda_fp._kernel_consts`, `cuda_fp._layout_array`)
// in host memory and ride in the kernel's parameters.
#include <cuda_runtime.h>

#include <cstdint>

#include "mont.cuh"

namespace {

using zk::MontConsts;
using zk::MontShape;

constexpr int kMaxDims = 4;

// lanes (field elements) of a block
template <int N>
constexpr int kTileRows = N > 32 ? 64 : 128;

// batch layout of the two operands, outermost dimension first; strides in
// int64 limbs, the limb axis at stride 1
struct Layout {
  int ndim;
  uint32_t size[kMaxDims];
  int64_t sa[kMaxDims];
  int64_t sb[kMaxDims];
};

enum : int { kVecA = 1, kVecB = 2, kConstB = 4, kVecOut = 8 };

// limb offsets of element e's rows in a and b
__device__ __forceinline__ void row_offsets(const Layout& L, uint32_t e, int64_t& oa,
                                            int64_t& ob) {
  int64_t a = 0, b = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d < L.ndim) {
      const uint32_t q = e / L.size[d];
      const uint32_t i = e - q * L.size[d];
      a += static_cast<int64_t>(i) * L.sa[d];
      b += static_cast<int64_t>(i) * L.sb[d];
      e = q;
    }
  }
  oa = a + static_cast<int64_t>(e) * L.sa[0];
  ob = b + static_cast<int64_t>(e) * L.sb[0];
}

// The tile's rows of one operand -> low 32 bits in shared memory, row r at
// dst[r * PAD].  Thread t takes limbs t, t + T, t + 2T, ... of the tile.
template <int N, int T>
__device__ __forceinline__ void stage(const int64_t* __restrict__ src, const int64_t* off,
                                      int rows, bool vec, uint32_t* dst) {
  constexpr int PAD = N | 1;
  if constexpr (N % 2 == 0) {
    if (vec) {                         // every row 16-byte aligned
      constexpr int H = N / 2;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const int f = threadIdx.x + k * T;
        const int r = f / H, l = 2 * (f - r * H);
        if (r < rows) {
          const longlong2 v = *reinterpret_cast<const longlong2*>(src + off[r] + l);
          dst[r * PAD + l] = static_cast<uint32_t>(v.x);
          dst[r * PAD + l + 1] = static_cast<uint32_t>(v.y);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int f = threadIdx.x + k * T;
    const int r = f / N, l = f - r * N;
    if (r < rows) dst[r * PAD + l] = static_cast<uint32_t>(src[off[r] + l]);
  }
}

// The tile's output rows (shared memory, stride PAD) -> one contiguous run
// of rows * N int64 limbs at dst.
template <int N, int T>
__device__ __forceinline__ void store(int64_t* __restrict__ dst, const uint32_t* s, int rows,
                                      bool vec) {
  constexpr int PAD = N | 1;
  const int total = rows * N;
  if (vec) {                           // dst 16-byte aligned
    constexpr int K = (N * T / 2 + T - 1) / T;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int f = 2 * (threadIdx.x + k * T);
      if (f >= total) continue;
      const int r0 = f / N, l0 = f - r0 * N;
      const int64_t v0 = s[r0 * PAD + l0];
      if (f + 1 < total) {
        const int r1 = l0 + 1 == N ? r0 + 1 : r0, l1 = l0 + 1 == N ? 0 : l0 + 1;
        *reinterpret_cast<longlong2*>(dst + f) = make_longlong2(v0, s[r1 * PAD + l1]);
      } else {
        dst[f] = v0;
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int f = threadIdx.x + k * T;
    const int r = f / N, l = f - r * N;
    if (f < total) dst[f] = s[r * PAD + l];
  }
}

template <int N>
__global__ void __launch_bounds__(kTileRows<N>)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out,
                const __grid_constant__ MontConsts<MontShape<N>::W> c,
                const __grid_constant__ Layout L, int64_t size, int flags) {
  constexpr int T = kTileRows<N>, PAD = N | 1, W = MontShape<N>::W;
  __shared__ uint32_t sa[T * PAD];
  __shared__ uint32_t sb[T * PAD];
  __shared__ int64_t oa[T];
  __shared__ int64_t ob[T];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * T;
  const int rows = static_cast<int>(size - base < T ? size - base : T);
  const bool const_b = flags & kConstB;
  if (t < rows) row_offsets(L, static_cast<uint32_t>(base + t), oa[t], ob[t]);
  __syncthreads();
  stage<N, T>(a, oa, rows, flags & kVecA, sa);
  if (const_b) {
    for (int l = t; l < N; l += T) sb[l] = static_cast<uint32_t>(b[l]);
  } else {
    stage<N, T>(b, ob, rows, flags & kVecB, sb);
  }
  __syncthreads();
  uint32_t r[W];
  if (t < rows) {
    uint32_t x[W], y[W];
    zk::pack<N>(sa + t * PAD, x);
    zk::pack<N>(sb + (const_b ? 0 : t * PAD), y);
    zk::mont_mul<N>(x, y, c, r);
  }
  __syncthreads();                     // every row of sa read: reuse it
  if (t < rows) zk::unpack<N>(r, sa + t * PAD);
  __syncthreads();
  store<N, T>(out + base * N, sa, rows, flags & kVecOut);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int N>
int launch(const int64_t* a, const int64_t* b, int64_t* out, const int64_t* consts,
           const int64_t* layout, int64_t size, cudaStream_t stream) {
  constexpr int W = MontShape<N>::W, T = kTileRows<N>;
  MontConsts<W> c;
  for (int j = 0; j < W; ++j) c.p[j] = static_cast<uint32_t>(consts[j]);
  c.np = static_cast<uint32_t>(consts[W]);
  c.nps = static_cast<uint32_t>(consts[W + 1]);
  Layout L;
  L.ndim = static_cast<int>(layout[0]);
  if (L.ndim < 1 || L.ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  bool even_a = N % 2 == 0, even_b = N % 2 == 0, const_b = true;
  for (int d = 0; d < kMaxDims; ++d) {
    const bool used = d < L.ndim;
    L.size[d] = used ? static_cast<uint32_t>(layout[1 + d]) : 1u;
    L.sa[d] = used ? layout[1 + kMaxDims + d] : 0;
    L.sb[d] = used ? layout[1 + 2 * kMaxDims + d] : 0;
    even_a = even_a && L.sa[d] % 2 == 0;
    even_b = even_b && L.sb[d] % 2 == 0;
    const_b = const_b && L.sb[d] == 0;
  }
  const int flags = (even_a && aligned16(a) ? kVecA : 0) |
                    (even_b && aligned16(b) ? kVecB : 0) | (const_b ? kConstB : 0) |
                    (aligned16(out) ? kVecOut : 0);
  const int64_t blocks = (size + T - 1) / T;
  mont_mul_kernel<N><<<static_cast<unsigned>(blocks), T, 0, stream>>>(a, b, out, c, L,
                                                                      size, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: host memory, int64 [W + 2]: p as 32-bit words (low word first),
// -p^-1 mod 2^32, -p^-1 mod 2^S (`cuda_fp._kernel_consts`).
// layout: host memory, int64 [1 + 3 * 4]: the batch dimension count, then
// the sizes, a's strides and b's strides of 4 dimensions, outermost first
// (`cuda_fp._layout`).  size < 2^31 elements; out is contiguous.
extern "C" int zk_mont_mul(int nlimbs, const void* a, const void* b, void* out,
                           const void* consts, const void* layout, int64_t size,
                           void* stream) {
  auto A = static_cast<const int64_t*>(a);
  auto Bp = static_cast<const int64_t*>(b);
  auto O = static_cast<int64_t*>(out);
  auto C = static_cast<const int64_t*>(consts);
  auto L = static_cast<const int64_t*>(layout);
  auto S = static_cast<cudaStream_t>(stream);
  switch (nlimbs) {
    case 18: return launch<18>(A, Bp, O, C, L, size, S);
    case 26: return launch<26>(A, Bp, O, C, L, size, S);
    case 51: return launch<51>(A, Bp, O, C, L, size, S);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
