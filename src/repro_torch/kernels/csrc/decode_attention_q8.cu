// Flash-decoding over an int8 KV cache for Hopper, sm_90a.
//
// Replaces: repro/kernels/decode_attention.py, decode_attention_q8_pallas
// (kernel body _dec_q8_kernel).  Same function: one query token per
// sequence against a cache of int8 K and V with one f32 scale per (token,
// KV head), k = k_q * k_s and v = v_q * v_s; the G = Hq / Hkv query heads
// of a KV group are packed together and attend over cache slots
// [0, min(length[b], Smax)) with an online softmax in f32; slots past the
// length are never read.  length is per sequence (ragged continuous
// batching); a scalar length arrives broadcast by the wrapper.
//
// The scales are never applied to a tile: score t is (q . k_q[t]) * k_s[t],
// and probability t is multiplied by v_s[t] before the PV product (the
// running sum takes it unscaled), so the int8 values are only widened.
//
// What bounds it on an H100: the cache is read once, D + Dv bytes plus 8
// bytes of scales per (slot, KV head), for 2 * G * (D + Dv) operations, about
// G operations per byte: far below the ~295 that would make the tensor cores
// the limit, so HBM bytes bound it, at about half the bytes of the bf16
// cache.  The design is the bf16 decode kernel's (decode_attention.cu): one
// thread block per (KV head, sequence) streams its cache in 64-slot tiles
// through shared memory, the packed heads share each tile, and the running
// max, sum and accumulator stay in shared memory.  Split-K and 16-byte loads
// of the int8 rows are left for later work.
//
// C interface, called through ctypes; returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;  // cache slots per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_q8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k, const float* __restrict__ k_s,
    const int8_t* __restrict__ v, const float* __restrict__ v_s,
    const int* __restrict__ length, T* __restrict__ o, int Smax, int Hq, int Hkv, int D,
    int Dv, float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv, ldk = D + 1, ldp = BK + 1;
  float* Qs = smem;            // G x D, pre-scaled by 1/sqrt(D)
  float* Ks = Qs + G * D;      // BK x ldk, int8 values widened
  float* Vs = Ks + BK * ldk;   // BK x Dv, int8 values widened
  float* Ksc = Vs + BK * Dv;   // BK, k_s of the tile
  float* Vsc = Ksc + BK;       // BK, v_s of the tile
  float* Ps = Vsc + BK;        // G x ldp: scores, then probabilities * v_s
  float* acc = Ps + G * ldp;   // G x Dv
  float* m = acc + G * Dv;     // G running max
  float* l = m + G;            // G running sum
  float* alpha = l + G;        // G rescale of this tile

  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = min(max(length[b], 0), Smax);
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;  // the group's G heads

  for (int e = tid; e < G * D; e += THREADS) Qs[e] = to_f(qb[e]) * scale;
  for (int e = tid; e < G * Dv; e += THREADS) acc[e] = 0.f;
  for (int g = tid; g < G; g += THREADS) { m[g] = NEG; l[g] = 0.f; }

  for (int k0 = 0; k0 < len; k0 += BK) {
    const int n = min(BK, len - k0);
    __syncthreads();  // the previous tile is consumed (and Qs staged)
    for (int e = tid; e < n * D; e += THREADS) {
      const int j = e / D, d = e % D;
      Ks[j * ldk + d] = (float)k[((size_t)(b * Smax + k0 + j) * Hkv + hk) * D + d];
    }
    for (int e = tid; e < n * Dv; e += THREADS) {
      const int j = e / Dv, c = e % Dv;
      Vs[j * Dv + c] = (float)v[((size_t)(b * Smax + k0 + j) * Hkv + hk) * Dv + c];
    }
    for (int j = tid; j < n; j += THREADS) {
      const size_t r = (size_t)(b * Smax + k0 + j) * Hkv + hk;
      Ksc[j] = k_s[r];
      Vsc[j] = v_s[r];
    }
    __syncthreads();

    for (int e = tid; e < G * BK; e += THREADS) {
      const int g = e / BK, j = e % BK;
      float s = NEG;
      if (j < n) {
        const float* qr = Qs + g * D;
        const float* kr = Ks + j * ldk;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        s *= Ksc[j];
      }
      Ps[g * ldp + j] = s;
    }
    __syncthreads();

    // one warp per packed head: online-softmax update over this tile
    for (int g = warp; g < G; g += WARPS) {
      float* pg = Ps + g * ldp;
      const float m_old = m[g];
      const float s0 = pg[lane], s1 = pg[lane + 32];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      pg[lane] = lane < n ? p0 * Vsc[lane] : 0.f;
      pg[lane + 32] = lane + 32 < n ? p1 * Vsc[lane + 32] : 0.f;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l[g] = a * l[g] + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * Dv; e += THREADS) {
      const int g = e / Dv, c = e % Dv;
      const float* pg = Ps + g * ldp;
      float a = acc[e] * alpha[g];
      for (int j = 0; j < n; ++j) a = fmaf(pg[j], Vs[j * Dv + c], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  T* ob = o + ((size_t)b * Hq + (size_t)hk * G) * Dv;
  for (int e = tid; e < G * Dv; e += THREADS) ob[e] = from_f<T>(acc[e] / fmaxf(l[e / Dv], 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* k_s, const void* v,
                   const void* v_s, const void* length, void* o, int B, int Smax, int Hq,
                   int Hkv, int D, int Dv, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)BK * (D + 1) +
                                       (size_t)BK * Dv + 2 * (size_t)BK +
                                       (size_t)G * (BK + 1) + (size_t)G * Dv + 3 * (size_t)G);
  auto kern = decode_q8_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), static_cast<const float*>(k_s),
      static_cast<const int8_t*>(v), static_cast<const float*>(v_s),
      static_cast<const int*>(length), static_cast<T*>(o), Smax, Hq, Hkv, D, Dv, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16.  Layouts (contiguous):
// q (B,1,Hq,D), k (B,Smax,Hkv,D) int8, k_s (B,Smax,Hkv) f32, v (B,Smax,Hkv,Dv)
// int8, v_s (B,Smax,Hkv) f32, length int32 (B,), o (B,1,Hq,Dv).
extern "C" int decode_attention_q8_fwd(const void* q, const void* k, const void* k_s,
                                       const void* v, const void* v_s, const void* length,
                                       void* o, int dtype, int B, int Smax, int Hq, int Hkv,
                                       int D, int Dv, float scale, void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || Dv <= 0 ||
      Dv > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(q, k, k_s, v, v_s, length, o, B, Smax, Hq, Hkv, D, Dv,
                                         scale, st)
      : dtype == 0 ? launch<float>(q, k, k_s, v, v_s, length, o, B, Smax, Hq, Hkv, D, Dv, scale,
                                   st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
