// What the two split-K decode kernels share (decode_attention.cu and
// decode_attention_q8.cu): element conversions, the softmax-merge helper and
// the second pass, decode_combine_kernel, which merges the per-piece
// partials (m, l, acc[Dv]) of every query head into o.
//
// Partials layout (f32, written by a first pass): part_ml (B, Hq, NS, 2) holds
// each piece's running max m (log2 units; -inf for a piece with no row) and
// sum l; part_acc (B, Hq, NS, Dv) its unnormalised accumulator.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the base a softmax state of max m subtracts: a state with no row yet has
// m = -inf and must subtract 0, so that its weight exp2(-inf - 0) is 0
__device__ __forceinline__ float merge_base(float m) { return m == -INFINITY ? 0.f : m; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one block per (KV head group, sequence): o[h] = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp2(m_s - max m), for each of the group's G heads at once.
// The pieces that hold a row (l > 0) are a prefix of the NS pieces, the
// same for every head of a sequence; only they are read for acc, with
// independent loads (unrolled by 4; the minimum of one block per SM lets
// ptxas give that loop 40 registers instead of spilling at 32).  No live
// piece (length 0): zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) decode_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc, T* __restrict__ o,
    int Hq, int Hkv, int Dv, int NS) {
  extern __shared__ float wts[];  // G x NS
  __shared__ int live_s;
  const int G = Hq / Hkv, hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t head0 = (size_t)b * Hq + (size_t)hk * G;
  for (int g = warp; g < G; g += WARPS) {  // a warp per head: the weights
    const float* ml = part_ml + (head0 + g) * NS * 2;
    float mx = -INFINITY;
    int live = 0;
    for (int s0 = 0; s0 < NS; s0 += 32) {
      const int s = s0 + lane;
      const bool has = s < NS && ml[2 * s + 1] > 0.f;
      if (has) mx = fmaxf(mx, ml[2 * s]);
      live += __popc(__ballot_sync(0xffffffffu, has));
    }
    const float bs = merge_base(warp_max(mx));
    float lsum = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float w = exp2f(ml[2 * s] - bs);
      wts[g * NS + s] = w;
      lsum += w * ml[2 * s + 1];
    }
    lsum = warp_sum(lsum);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    for (int s = lane; s < live; s += 32) wts[g * NS + s] *= inv;
    if (g == 0 && lane == 0) live_s = live;
  }
  __syncthreads();
  const int live = live_s;
  for (int i = tid; i < G * Dv; i += THREADS) {
    const int g = i / Dv, c = i % Dv;
    const float* a = part_acc + (head0 + g) * NS * Dv + c;
    const float* w = wts + g * NS;
    float sum = 0.f;
#pragma unroll 4
    for (int s = 0; s < live; ++s) sum = fmaf(w[s], a[(size_t)s * Dv], sum);
    o[(head0 + g) * Dv + c] = from_f<T>(sum);
  }
}

template <typename T>
cudaError_t launch_combine(const float* part_ml, const float* part_acc, void* o, int B, int Hq,
                           int Hkv, int Dv, int NS, cudaStream_t stream) {
  auto comb = decode_combine_kernel<T>;
  const size_t cs = sizeof(float) * (size_t)(Hq / Hkv) * NS;
  if (cs > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(comb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cs);
    if (err != cudaSuccess) return err;
  }
  comb<<<dim3(Hkv, B), THREADS, cs, stream>>>(part_ml, part_acc, static_cast<T*>(o), Hq, Hkv,
                                              Dv, NS);
  return cudaGetLastError();
}

}  // namespace
