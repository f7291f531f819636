// Chunked Mamba-2 SSD scan for Hopper, sm_90a.
//
// Replaces: repro/kernels/ssd_scan.py, ssd_scan_pallas (kernel body
// _ssd_kernel).  Same function: the selective state-space recurrence
//   h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// computed chunk by chunk as in Mamba-2.  Inside a chunk of L steps, with
// cum the inclusive cumsum of A dt over the chunk,
//   w[t,u]  = (C_t . B_u) exp(cum_t - cum_u) dt_u   for u <= t,
//   y[t]    = sum_u w[t,u] x_u + exp(cum_t) C_t h^T,
//   h      <- h exp(cum_last) + sum_u exp(cum_last - cum_u) dt_u x_u B_u^T,
// the state h (P x N, f32) carried from chunk to chunk.  y is written in x's
// type, the final state in f32; the initial state is optional (null: zeros).
//
// Where it departs from the TPU kernel:
//   * any S: the last chunk may be short (the Pallas kernel asserts
//     S % chunk == 0), so recurrent prefills run at their exact length;
//   * exp is taken only for u <= t (never exp(cum_t - cum_u) > 1 of the
//     upper triangle, whose inf * 0 would be NaN);
//   * its own time tile, L = 64: the L x L weights take 16 KB of shared
//     memory in f32, where the TPU's 256-step chunk was sized for VMEM;
//   * x, B and C are read through their batch and sequence strides, so the
//     model hands over slices of its convolution output without a copy.
//
// What bounds it on an H100: per (batch, head) and step the work is about
// 4 P N + L (P + N) operations on P + 2N + 1 input values and P outputs
// (zamba2-1.2b: P 128, N 64), about 85 operations per byte in bf16, under
// the ~295 the tensor cores need to be the limit, so in principle HBM
// bytes bound it: x and y once each, B, C and dt once per head.  This first
// version is written to be right and simple, not fast: one thread block per
// (32 rows of P, head, batch) walks the chunks in order; B, C, x, the
// weights w and the block's 32 x N slice of the state live in shared
// memory in f32, and all three products run on the CUDA cores.  Splitting P
// over 4 blocks gives 128 blocks at zamba2's batch 1 (H 32, P 128), about
// one per SM, at the price of computing C.B four times per head.  Tensor
// cores, a C.B shared across heads and TMA loads are left for later work.
//
// C interface, called through ctypes; returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;    // time steps per chunk
constexpr int PB = 32;   // rows of P (head dim) per block
constexpr int THREADS = 256;
constexpr int MAX_N = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hT, int S, int H, int P, int N,
    long long x_sb, long long x_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldl = L + 1, ldp = PB + 1;  // +1: no bank conflicts
  float* Bs = smem;              // L x ldn
  float* Cs = Bs + L * ldn;      // L x ldn
  float* Xs = Cs + L * ldn;      // L x ldp, this block's PB columns of x
  float* Ws = Xs + L * ldp;      // L x ldl, w[t,u] for u <= t
  float* Hs = Ws + L * ldl;      // PB x ldn, the state h[p,n]
  float* dts = Hs + PB * ldn;    // L
  float* cum = dts + L;          // L, inclusive cumsum of A dt
  float* tail = cum + L;         // L, exp(cum_last - cum_u) dt_u

  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int pb = min(PB, P - p0);
  const float a = A[h];
  const size_t hoff = (((size_t)b * H + h) * P + p0) * N;

  for (int e = tid; e < pb * N; e += THREADS) {
    const int p = e / N, n = e % N;
    Hs[p * ldn + n] = h0 ? h0[hoff + e] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += L) {
    const int nt = min(L, S - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < nt * N; e += THREADS) {
      const int t = e / N, n = e % N;
      Bs[t * ldn + n] = to_f(Bm[b * b_sb + (long long)(c0 + t) * b_ss + n]);
      Cs[t * ldn + n] = to_f(Cm[b * c_sb + (long long)(c0 + t) * c_ss + n]);
    }
    for (int e = tid; e < nt * pb; e += THREADS) {
      const int t = e / pb, p = e % pb;
      Xs[t * ldp + p] = to_f(x[b * x_sb + (long long)(c0 + t) * x_ss + (long long)h * P + p0 + p]);
    }
    if (tid < 32) {  // one warp: inclusive scan of A dt, two steps a lane
      const int i0 = 2 * tid, i1 = 2 * tid + 1;
      const size_t base = ((size_t)b * S + c0) * H + h;
      const float d0 = i0 < nt ? dt[base + (size_t)i0 * H] : 0.f;
      const float d1 = i1 < nt ? dt[base + (size_t)i1 * H] : 0.f;
      const float l0 = a * d0, l1 = a * d1;
      float s = l0 + l1;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      dts[i0] = d0;
      dts[i1] = d1;
      cum[i0] = s - l1;
      cum[i1] = s;
    }
    __syncthreads();

    const float cum_last = cum[nt - 1];
    for (int u = tid; u < nt; u += THREADS) tail[u] = expf(cum_last - cum[u]) * dts[u];
    for (int e = tid; e < nt * L; e += THREADS) {
      const int t = e / L, u = e % L;
      if (u > t) continue;  // the upper triangle is never read
      const float* cr = Cs + t * ldn;
      const float* br = Bs + u * ldn;
      float dot = 0.f;
      for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
      Ws[t * ldl + u] = dot * expf(cum[t] - cum[u]) * dts[u];
    }
    __syncthreads();

    for (int e = tid; e < nt * pb; e += THREADS) {
      const int t = e / pb, p = e % pb;
      const float* wr = Ws + t * ldl;
      float intra = 0.f;
      for (int u = 0; u <= t; ++u) intra = fmaf(wr[u], Xs[u * ldp + p], intra);
      const float* cr = Cs + t * ldn;
      const float* hr = Hs + p * ldn;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(cr[n], hr[n], inter);
      y[(((size_t)b * S + c0 + t) * H + h) * P + p0 + p] =
          from_f<T>(fmaf(expf(cum[t]), inter, intra));
    }
    __syncthreads();  // every y has read the state entering this chunk

    const float decay = expf(cum_last);
    for (int e = tid; e < pb * N; e += THREADS) {
      const int p = e / N, n = e % N;
      float upd = 0.f;
      for (int u = 0; u < nt; ++u) upd = fmaf(Xs[u * ldp + p] * tail[u], Bs[u * ldn + n], upd);
      Hs[p * ldn + n] = fmaf(Hs[p * ldn + n], decay, upd);
    }
  }
  __syncthreads();
  for (int e = tid; e < pb * N; e += THREADS) hT[hoff + e] = Hs[(e / N) * ldn + e % N];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   const void* h0, void* y, void* hT, int Bt, int S, int H, int P, int N,
                   long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)L * (N + 1) + (size_t)L * (PB + 1) +
                                       (size_t)L * (L + 1) + (size_t)PB * (N + 1) + 3 * L);
  auto kern = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((P + PB - 1) / PB, H, Bt), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hT), S, H, P, N, x_sb, x_ss, b_sb, b_ss, c_sb,
      c_ss);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  x (Bt,S,H,P) with
// (H,P) contiguous, read at x_sb * b + x_ss * s; B, C (Bt,S,N) with N
// contiguous, likewise; dt (Bt,S,H) f32 and A (H,) f32 contiguous; h0 and
// hT (Bt,H,P,N) f32 contiguous, h0 may be null; y (Bt,S,H,P) contiguous.
// Strides are in elements.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* hT, int dtype,
                            int Bt, int S, int H, int P, int N, long long x_sb, long long x_ss,
                            long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                            void* stream) {
  if (Bt <= 0 || S < 0 || H <= 0 || H > 65535 || Bt > 65535 || P <= 0 || N <= 0 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hT, Bt, S, H, P, N, x_sb, x_ss,
                                         b_sb, b_ss, c_sb, c_ss, st)
      : dtype == 0 ? launch<float>(x, dt, A, Bm, Cm, h0, y, hT, Bt, S, H, P, N, x_sb, x_ss, b_sb,
                                   b_ss, c_sb, c_ss, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
