// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (kernel body _fa_kernel).  Same function: softmax(q k^T / sqrt(D)) v with
// an online softmax in f32, GQA (query head h reads KV head h / G), the
// end-aligned causal mask kpos <= qpos + (Sk - Sq), an optional sliding
// window kpos > qpos - window, and tiles that are fully masked skipped.
// Unlike the TPU kernel it takes Sq != Sk and any S (the ragged tail is
// masked), and Dv != D up to 256.
//
// What bounds it on an H100: for a causal prefill the work is
// 2 * (D + Dv) * Hq * B * Sq*(Sq+1)/2 operations on q, k, v read once and o
// written once (smollm-135m at S=1024: 1.2 GFLOP against 3.1 MB), so the
// tensor-core rate (989 TFLOP/s bf16) is the bound, not the 3.35 TB/s of
// HBM.  This first version is written to be right and simple, not fast:
// both products run on the CUDA cores in f32, one thread block per
// (64-row query tile, query head, batch) walks the key tiles in order
// through shared memory, and each row's running max, running sum and
// accumulator stay in registers so no score or probability tile ever
// reaches device memory.  K/V are never replicated across the G heads of a
// group: every block reads its KV head in place.  Tensor cores (mma.sync /
// wgmma), TMA and split-K are left for later work.
//
// C interface, called through ctypes; returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int SPT = BK / TPR;  // scores per thread per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DVT: accumulator columns per thread, >= ceil(Dv / TPR); a compile-time
// bound so the accumulator lives in registers.
template <typename T, int DVT>
__global__ void __launch_bounds__(THREADS) fa_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
    int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldq = D + 1, ldk = D + 1, ldp = BK + 1;  // +1: no bank conflicts
  float* Qs = smem;             // BQ x ldq, pre-scaled by 1/sqrt(D)
  float* Ks = Qs + BQ * ldq;    // BK x ldk
  float* Vs = Ks + BK * ldk;    // BK x Dv
  float* Ps = Vs + BK * Dv;     // BQ x ldp, this tile's probabilities

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, r = tid / TPR, sub = tid % TPR;
  const int off = Sk - Sq;  // query row i sits at key position i + off

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int rr = e / D, d = e % D, s = q0 + rr;
    Qs[rr * ldq + d] =
        s < Sq ? to_f(q[((size_t)(b * Sq + s) * Hq + h) * D + d]) * scale : 0.f;
  }

  // key range any row of this tile can see; tiles outside it are skipped
  const int q_last = min(q0 + BQ, Sq) - 1 + off;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int qpos = q0 + r + off;

  float m_run = NEG, l_run = 0.f;
  float acc[DVT];
#pragma unroll
  for (int i = 0; i < DVT; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Qs staged)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D, s = k0 + j;
      Ks[j * ldk + d] = s < Sk ? to_f(k[((size_t)(b * Sk + s) * Hkv + hk) * D + d]) : 0.f;
    }
    for (int e = tid; e < BK * Dv; e += THREADS) {
      const int j = e / Dv, c = e % Dv, s = k0 + j;
      Vs[j * Dv + c] = s < Sk ? to_f(v[((size_t)(b * Sk + s) * Hkv + hk) * Dv + c]) : 0.f;
    }
    __syncthreads();

    // scores for keys sub, sub+4, ... of this row
    float sc[SPT];
    unsigned ok_bits = 0;
    float mx = NEG;
    const float* qr = Qs + r * ldq;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int j = sub + TPR * i, kpos = k0 + j;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      const float* kr = Ks + j * ldk;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      sc[i] = ok ? dot : NEG;
      ok_bits |= (ok ? 1u : 0u) << i;
      mx = fmaxf(mx, sc[i]);
    }
    // the TPR threads of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const float p = (ok_bits >> i) & 1u ? expf(sc[i] - m_new) : 0.f;
      Ps[r * ldp + sub + TPR * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = alpha * l_run + sum;
    m_run = m_new;
    __syncwarp();  // the row's probabilities are written by its own warp

    const float* pr = Ps + r * ldp;
#pragma unroll
    for (int i = 0; i < DVT; ++i) {
      const int c = sub + TPR * i;
      if (c < Dv) {
        float a = acc[i] * alpha;
        for (int j = 0; j < BK; ++j) a = fmaf(pr[j], Vs[j * Dv + c], a);
        acc[i] = a;
      }
    }
  }

  if (q0 + r < Sq) {
    const float l = fmaxf(l_run, 1e-30f);
    T* orow = o + ((size_t)(b * Sq + q0 + r) * Hq + h) * Dv;
#pragma unroll
    for (int i = 0; i < DVT; ++i) {
      const int c = sub + TPR * i;
      if (c < Dv) orow[c] = from_f<T>(acc[i] / l);
    }
  }
}

template <typename T, int DVT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int Hq, int Hkv, int D, int Dv, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                                       (size_t)BK * Dv + (size_t)BQ * (BK + 1));
  auto kern = fa_fwd_kernel<T, DVT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, D, Dv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v, void* o, int B,
                        int Sq, int Sk, int Hq, int Hkv, int D, int Dv, int causal,
                        int window, float scale, cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, scale, stream);
  if (Dv <= 128)
    return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, scale, stream);
  return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Layouts (contiguous): q (B,Sq,Hq,D),
// k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv), o (B,Sq,Hq,Dv).  window <= 0: no window.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int Dv, int causal, int window, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 ||
      Dv <= 0 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? dispatch_dv<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv,
                                              causal, window, scale, st)
      : dtype == 0 ? dispatch_dv<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal,
                                        window, scale, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
