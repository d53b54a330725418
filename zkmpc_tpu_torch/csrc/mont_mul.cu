// K1: batched Montgomery multiplication, REDC(a*b), for the H100 (sm_90a).
//
// Replaces zkmpc_tpu/ops/pallas_fp.py `_mont_kernel` (built by `_mont_call`,
// called by `mont_mul_pallas`, routed from limbs._mont_mul_limbs).  Same
// limb algorithm (see fp.cuh), so its limbs equal the reference's XLA path
// bit for bit.
//
// Design: one thread per field element; limbs are read from and written to
// int64 tensors [size, N] and held as uint32 in registers.  What bounds it
// on the card is integer multiply-adds per lane -- three N x N limb
// convolutions, about 3*N^2 IMADs plus ~8*N carry ops (N = 26: ~2,100) --
// and register pressure: the column and limb arrays are fully unrolled
// into registers (about 6*N words live), which fits for N = 18 and 26 and
// spills to local memory at N = 51.  p and p' sit in shared memory, read
// by every thread of the block at the same address (a broadcast).  The
// 1-D constant-b path (tighten's repr(1)) reads b at offset 0 for every
// lane.  Coalesced layouts, narrower storage and tensor-core products are
// later work.
#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 128;

template <int N>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int b_const, int64_t* __restrict__ out,
                const int64_t* __restrict__ consts, int64_t size) {
  __shared__ uint32_t s_p[N];
  __shared__ uint32_t s_pp[N];
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    s_p[k] = static_cast<uint32_t>(consts[k]);
    s_pp[k] = static_cast<uint32_t>(consts[N + k]);
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const int64_t* ai = a + i * N;
  const int64_t* bi = b + (b_const ? 0 : i * N);
  uint32_t x[N], y[N], o[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = static_cast<uint32_t>(ai[k]);
    y[k] = static_cast<uint32_t>(bi[k]);
  }
  zk::mont_mul<N>(x, y, s_pp, s_p, o);
  int64_t* oi = out + i * N;
#pragma unroll
  for (int k = 0; k < N; ++k) oi[k] = static_cast<int64_t>(o[k]);
}

template <int N>
void launch(const int64_t* a, const int64_t* b, int b_const, int64_t* out,
            const int64_t* consts, int64_t size, cudaStream_t stream) {
  const int64_t blocks = (size + kThreads - 1) / kThreads;
  mont_mul_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, b, b_const, out, consts, size);
}

}  // namespace

extern "C" int zk_mont_mul(int nlimbs, const void* a, const void* b,
                           int b_const, void* out, const void* consts,
                           int64_t size, void* stream) {
  auto A = static_cast<const int64_t*>(a);
  auto Bp = static_cast<const int64_t*>(b);
  auto O = static_cast<int64_t*>(out);
  auto C = static_cast<const int64_t*>(consts);
  auto S = static_cast<cudaStream_t>(stream);
  switch (nlimbs) {
    case 18: launch<18>(A, Bp, b_const, O, C, size, S); break;
    case 26: launch<26>(A, Bp, b_const, O, C, size, S); break;
    case 51: launch<51>(A, Bp, b_const, O, C, size, S); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
