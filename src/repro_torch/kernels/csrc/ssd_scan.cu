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
// the ~295 the tensor cores need to be the limit, so HBM bytes bound it:
// x and y once each, B, C and dt once (13.4 MB, 4.0 us, at zamba2's
// 673-token prompt).  The sequential walk over chunks is what stands in the
// way; two bodies, chosen by the wrapper by shape, never by a fallback:
//
// * The tensor-core body (ssd_scan_tc_fwd): bf16 with P % 16 == 0,
//   N % 16 == 0, P <= 256 and 16-byte aligned x, B, C rows.  It breaks the
//   chain as Mamba-2's GPU algorithm does, in three launches:
//   1. ssd_chunk_state_kernel, one block per (chunk, group of heads, batch):
//      per head, cum by a warp scan, then the chunk's own state
//      S_c = (x o tail)^T B with tail_u = exp(cum_last - cum_u) dt_u, a
//      P x N product of depth L on mma.sync m16n8k16 (x's fragments come
//      by ldmatrix.trans and are scaled by tail in registers), written in
//      f32 to a scratch tensor (Bt, n_chunks, H, P, N) with cum_last
//      beside it (Bt, n_chunks, H).
//   2. ssd_state_pass_kernel, one block per (tile of P x N, head, batch),
//      walks the chunks in order in f32: h <- h exp(cum_last_c) + S_c from
//      the initial state (or zeros), overwriting each S_c with the state
//      entering chunk c, and writes the final state.  Its loads do not
//      depend on h, so eight chunks' loads are in flight at once.
//   3. ssd_chunk_scan_kernel, one block per (chunk, group of heads, batch):
//      CB = C B^T (L x L, depth N) once per block, since B and C are one
//      group shared by all heads, held in accumulator fragments; per head,
//      W = CB o exp(cum_t - cum_u) dt_u for u <= t (exp only there) packed
//      to bf16 A fragments in registers, then y = W x (only the k-steps at
//      or below the diagonal) + (exp(cum_t) C) h_enter^T on mma.sync, with
//      h_enter rounded to bf16 in shared memory, written in x's type.
//   The group of heads per block is 1 unless the chunks alone give two
//   blocks per SM, so short prompts still spread over the card.  Scratch is
//   written and read within the call (11.5 MB at zamba2's longest prompt,
//   mostly L2-resident).
// * ssd_kernel (ssd_scan_fwd): f32, and bf16 at any other shape.  One
//   thread block per (32 rows of P, head, batch) walks the chunks in order;
//   B, C, x, the weights w and the block's 32 x N slice of the state live in
//   shared memory in f32, and all three products run on the CUDA cores.  It
//   keeps f32 to 5e-5 of the plain version, which no tensor-core type does.
//
// C interface, called through ctypes; each entry point returns the
// cudaError_t of its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_sm80.cuh"

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


// ---------------------------------------------------------------------------
// Tensor-core body (bf16; P, N multiples of 16; 16-byte aligned rows)
// ---------------------------------------------------------------------------
constexpr int TC_THREADS = 128;  // four warps
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int PASS_THREADS = 256;
constexpr int PASS_PREFETCH = 8;  // chunks whose loads are in flight at once

// One warp: the inclusive cumsum of A dt over a chunk's L = 64 steps, two
// steps a lane (dt = 0 past nt, so the cumsum stays flat there).  Writes
// dt and cum of the chunk to shared memory; returns cum_last to every lane.
__device__ __forceinline__ float chunk_cumsum(const float* __restrict__ dt, size_t base, int H,
                                              int nt, float a, int lane, float* dts,
                                              float* cum) {
  const int i0 = 2 * lane, i1 = 2 * lane + 1;
  const float d0 = i0 < nt ? dt[base + (size_t)i0 * H] : 0.f;
  const float d1 = i1 < nt ? dt[base + (size_t)i1 * H] : 0.f;
  const float l0 = a * d0, l1 = a * d1;
  float s = l0 + l1;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  dts[i0] = d0;
  dts[i1] = d1;
  cum[i0] = s - l1;
  cum[i1] = s;
  return __shfl_sync(0xffffffffu, s, 31);
}

// rows [0, L) of a (rows x width) bf16 slice with row stride `stride` ->
// shared memory with row pitch ld, zero past row nt
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, long long stride, int nt,
                                          int width, int tid) {
  const int chunks = width / 8;
  for (int i = tid; i < L * chunks; i += TC_THREADS) {
    const int r = i / chunks, col = (i % chunks) * 8;
    const bool ok = r < nt;
    cp_async16(smem_addr(dst + r * ld + col), ok ? src + r * stride + col : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float s0, float s1) {
  const float2 f = unpack_bf16(w);
  return pack_bf16(f.x * s0, f.y * s1);
}

// NMAX: N rounded up to 64 or 128 (accumulator width); P % 16 == 0.
template <int NMAX>
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_state_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ cum_last, int S, int H, int P, int N,
    int HG, long long x_sb, long long x_ss, long long b_sb, long long b_ss) {
  constexpr int NT = NMAX / 8;  // accumulator n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDN = N + 8, LDP = P + 8;  // 16-byte row padding: conflict-free ldmatrix
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // L x LDN
  __nv_bfloat16* Xs = Bs + L * LDN;                                 // L x LDP
  float* tail = reinterpret_cast<float*>(Xs + L * LDP);             // L
  float* dts = tail + L;                                            // L
  float* cum = dts + L;                                             // L

  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.z;
  const int c0 = c * L, nt = min(L, S - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3, mat = lane >> 3, mr = lane & 7;

  load_rows(Bs, LDN, Bm + b * b_sb + c0 * b_ss, b_ss, nt, N, tid);
  for (int hi = 0; hi < HG; ++hi) {
    const int h = blockIdx.y * HG + hi;
    if (h >= H) break;
    load_rows(Xs, LDP, x + b * x_sb + c0 * x_ss + (long long)h * P, x_ss, nt, P, tid);
    cp_async_commit();
    if (warp == 0) {
      const float cl = chunk_cumsum(dt, ((size_t)b * S + c0) * H + h, H, nt, A[h], lane, dts, cum);
      tail[2 * lane] = expf(cl - cum[2 * lane]) * dts[2 * lane];
      tail[2 * lane + 1] = expf(cl - cum[2 * lane + 1]) * dts[2 * lane + 1];
      if (lane == 0) cum_last[((size_t)b * nc + c) * H + h] = cl;
    }
    cp_async_wait_all();
    __syncthreads();

    float* out = states + (((size_t)b * nc + c) * H + h) * (size_t)P * N;
    for (int mt = warp; mt < P / 16; mt += TC_WARPS) {  // 16 rows of P per step
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < L / 16; ++ks) {
        if (ks * 16 >= nt) break;
        // A = (x o tail)^T: x^T's fragment by ldmatrix.trans, scaled along k
        uint32_t a[4];
        ldsm_x4_trans(a, smem_addr(Xs + (ks * 16 + mr + (mat >> 1) * 8) * LDP + mt * 16 +
                                   (mat & 1) * 8));
        const int u = ks * 16 + 2 * tq;
        a[0] = scale_bf16x2(a[0], tail[u], tail[u + 1]);
        a[1] = scale_bf16x2(a[1], tail[u], tail[u + 1]);
        a[2] = scale_bf16x2(a[2], tail[u + 8], tail[u + 9]);
        a[3] = scale_bf16x2(a[3], tail[u + 8], tail[u + 9]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          if (jp * 16 >= N) break;
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_addr(Bs + (ks * 16 + mr + (mat & 1) * 8) * LDN + jp * 16 +
                                      (mat >> 1) * 8));
          mma_bf16(acc[2 * jp], a, bf[0], bf[1]);
          mma_bf16(acc[2 * jp + 1], a, bf[2], bf[3]);
        }
      }
      const int p0 = mt * 16 + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 >= N) break;
        const int n = j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + (size_t)p0 * N + n) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(out + (size_t)(p0 + 8) * N + n) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();  // Xs and tail are consumed before the next head's
  }
}

// states (Bt, nc, H, P, N): S_c in, the state entering chunk c out.
// P * N % 4 == 0.
__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass_kernel(
    float* states, const float* __restrict__ cum_last, const float* __restrict__ h0,
    float* __restrict__ hT, int nc, int H, int PN) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = (blockIdx.x * PASS_THREADS + threadIdx.x) * 4;
  if (i >= PN) return;
  const size_t head = ((size_t)b * H + h) * PN + i;
  float4 hv = h0 ? *reinterpret_cast<const float4*>(h0 + head) : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t cstride = (size_t)H * PN;
  float* st = states + ((size_t)b * nc * H + h) * PN + i;
  const float* cl = cum_last + (size_t)b * nc * H + h;
  for (int c0 = 0; c0 < nc; c0 += PASS_PREFETCH) {
    float4 sv[PASS_PREFETCH];
    float dv[PASS_PREFETCH];
#pragma unroll
    for (int k = 0; k < PASS_PREFETCH; ++k) {
      if (c0 + k < nc) {
        sv[k] = *reinterpret_cast<const float4*>(st + (c0 + k) * cstride);
        dv[k] = cl[(size_t)(c0 + k) * H];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_PREFETCH; ++k) {
      if (c0 + k < nc) {
        *reinterpret_cast<float4*>(st + (c0 + k) * cstride) = hv;
        const float d = expf(dv[k]);
        hv = make_float4(fmaf(hv.x, d, sv[k].x), fmaf(hv.y, d, sv[k].y), fmaf(hv.z, d, sv[k].z),
                         fmaf(hv.w, d, sv[k].w));
      }
    }
  }
  *reinterpret_cast<float4*>(hT + head) = hv;
}

template <int NMAX>
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_scan_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ h_enter,
    __nv_bfloat16* __restrict__ y, int S, int H, int P, int N, int HG, long long x_sb,
    long long x_ss, long long b_sb, long long b_ss, long long c_sb, long long c_ss) {
  constexpr int KN = NMAX / 16;  // k-steps of depth N
  constexpr int PT = 64;         // columns of P per output tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDN = N + 8, LDP = P + 8;
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // L x LDN
  __nv_bfloat16* Bs = Cs + L * LDN;                                 // L x LDN
  __nv_bfloat16* Xs = Bs + L * LDN;                                 // L x LDP
  __nv_bfloat16* Hs = Xs + L * LDP;                                 // P x LDN, h_enter
  float* dts = reinterpret_cast<float*>(Hs + P * LDN);              // L
  float* cum = dts + L;                                             // L

  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.z;
  const int c0 = c * L, nt = min(L, S - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3, mat = lane >> 3, mr = lane & 7;
  const int t0 = warp * 16 + g, t1 = t0 + 8;  // this thread's two rows of the chunk
  const bool rows_live = warp * 16 < nt;

  load_rows(Cs, LDN, Cm + b * c_sb + c0 * c_ss, c_ss, nt, N, tid);
  load_rows(Bs, LDN, Bm + b * b_sb + c0 * b_ss, b_ss, nt, N, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // C's A fragments (this warp's 16 rows), and CB = C B^T for columns
  // u <= the warp's last row, once for all the block's heads
  uint32_t cf[KN][4];
  float cb[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    if (kk * 16 >= N) break;
    ldsm_x4(cf[kk], smem_addr(Cs + (warp * 16 + mr + (mat & 1) * 8) * LDN + kk * 16 +
                              (mat >> 1) * 8));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > warp) break;
      uint32_t bf[4];
      ldsm_x4(bf, smem_addr(Bs + (jp * 16 + mr + (mat >> 1) * 8) * LDN + kk * 16 +
                            (mat & 1) * 8));
      mma_bf16(cb[2 * jp], cf[kk], bf[0], bf[1]);
      mma_bf16(cb[2 * jp + 1], cf[kk], bf[2], bf[3]);
    }
  }

  for (int hi = 0; hi < HG; ++hi) {
    const int h = blockIdx.y * HG + hi;
    if (h >= H) break;
    load_rows(Xs, LDP, x + b * x_sb + c0 * x_ss + (long long)h * P, x_ss, nt, P, tid);
    cp_async_commit();
    const float* he = h_enter + (((size_t)b * nc + c) * H + h) * (size_t)P * N;
    for (int i = tid * 4; i < P * N; i += TC_THREADS * 4) {
      const float4 v = *reinterpret_cast<const float4*>(he + i);
      uint2 w = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      *reinterpret_cast<uint2*>(Hs + (i / N) * LDN + i % N) = w;
    }
    if (warp == 0) chunk_cumsum(dt, ((size_t)b * S + c0) * H + h, H, nt, A[h], lane, dts, cum);
    cp_async_wait_all();
    __syncthreads();

    if (rows_live) {
      // W = CB o exp(cum_t - cum_u) dt_u for u <= t, as bf16 A fragments:
      // accumulator n-tiles 2ks and 2ks + 1 are k-step ks
      const float ct0 = cum[t0], ct1 = cum[t1];
      uint32_t wf[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks > warp) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * ks + half, u0 = j * 8 + 2 * tq, u1 = u0 + 1;
          const float e00 = u0 <= t0 ? expf(ct0 - cum[u0]) * dts[u0] : 0.f;
          const float e01 = u1 <= t0 ? expf(ct0 - cum[u1]) * dts[u1] : 0.f;
          const float e10 = u0 <= t1 ? expf(ct1 - cum[u0]) * dts[u0] : 0.f;
          const float e11 = u1 <= t1 ? expf(ct1 - cum[u1]) * dts[u1] : 0.f;
          wf[ks][2 * half] = pack_bf16(cb[j][0] * e00, cb[j][1] * e01);
          wf[ks][2 * half + 1] = pack_bf16(cb[j][2] * e10, cb[j][3] * e11);
        }
      }
      // exp(cum_t) C: rows g (fragment words 0, 2) and g + 8 (1, 3)
      const float d0 = expf(ct0), d1 = expf(ct1);
      uint32_t cs[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk * 16 >= N) break;
        cs[kk][0] = scale_bf16x2(cf[kk][0], d0, d0);
        cs[kk][1] = scale_bf16x2(cf[kk][1], d1, d1);
        cs[kk][2] = scale_bf16x2(cf[kk][2], d0, d0);
        cs[kk][3] = scale_bf16x2(cf[kk][3], d1, d1);
      }
      __nv_bfloat16* y0 = y + (((size_t)b * S + c0 + t0) * H + h) * P;
      __nv_bfloat16* y1 = y + (((size_t)b * S + c0 + t1) * H + h) * P;
      for (int pt = 0; pt < P; pt += PT) {
        float acc[PT / 8][4];
#pragma unroll
        for (int j = 0; j < PT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        // W x: only the k-steps at or below the diagonal
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks > warp) break;
#pragma unroll
          for (int jp = 0; jp < PT / 16; ++jp) {
            if (pt + jp * 16 >= P) break;
            uint32_t bf[4];
            ldsm_x4_trans(bf, smem_addr(Xs + (ks * 16 + mr + (mat & 1) * 8) * LDP + pt +
                                        jp * 16 + (mat >> 1) * 8));
            mma_bf16(acc[2 * jp], wf[ks], bf[0], bf[1]);
            mma_bf16(acc[2 * jp + 1], wf[ks], bf[2], bf[3]);
          }
        }
        // (exp(cum_t) C) h_enter^T
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          if (kk * 16 >= N) break;
#pragma unroll
          for (int jp = 0; jp < PT / 16; ++jp) {
            if (pt + jp * 16 >= P) break;
            uint32_t bf[4];
            ldsm_x4(bf, smem_addr(Hs + (pt + jp * 16 + mr + (mat >> 1) * 8) * LDN + kk * 16 +
                                  (mat & 1) * 8));
            mma_bf16(acc[2 * jp], cs[kk], bf[0], bf[1]);
            mma_bf16(acc[2 * jp + 1], cs[kk], bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < PT / 8; ++j) {
          const int col = pt + j * 8 + 2 * tq;
          if (col >= P) break;
          if (t0 < nt)
            *reinterpret_cast<uint32_t*>(y0 + col) = pack_bf16(acc[j][0], acc[j][1]);
          if (t1 < nt)
            *reinterpret_cast<uint32_t*>(y1 + col) = pack_bf16(acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();  // Xs, Hs and cum are consumed before the next head's
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

template <int NMAX>
cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* h0, void* y, void* hT, float* scratch, int Bt,
                      int S, int H, int P, int N, long long x_sb, long long x_ss,
                      long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                      cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  float* states = scratch;
  float* cum_last = scratch + (size_t)Bt * nc * H * P * N;
  // heads per block: 1 unless the chunks alone give two blocks per SM
  int hg = 1;
  while (hg < H && (long long)nc * ((H + 2 * hg - 1) / (2 * hg)) * Bt >= 2LL * sm_count())
    hg *= 2;
  const dim3 grid(nc, (H + hg - 1) / hg, Bt);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(Cm);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  cudaError_t err;
  if (nc > 0) {
    const size_t s1 = sizeof(__nv_bfloat16) * (size_t)L * ((N + 8) + (P + 8)) + 3 * L * sizeof(float);
    auto k1 = ssd_chunk_state_kernel<NMAX>;
    if ((err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1)))
      return err;
    k1<<<grid, TC_THREADS, s1, stream>>>(xb, dtf, Af, bb, states, cum_last, S, H, P, N, hg, x_sb,
                                         x_ss, b_sb, b_ss);
    if ((err = cudaGetLastError())) return err;
  }
  const int pn = P * N;
  ssd_state_pass_kernel<<<dim3((pn / 4 + PASS_THREADS - 1) / PASS_THREADS, H, Bt), PASS_THREADS,
                          0, stream>>>(states, cum_last, static_cast<const float*>(h0),
                                       static_cast<float*>(hT), nc, H, pn);
  if ((err = cudaGetLastError()) || nc == 0) return err;
  const size_t s3 = sizeof(__nv_bfloat16) * ((size_t)2 * L * (N + 8) + (size_t)L * (P + 8) +
                                             (size_t)P * (N + 8)) + 2 * L * sizeof(float);
  auto k3 = ssd_chunk_scan_kernel<NMAX>;
  if ((err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3)))
    return err;
  k3<<<grid, TC_THREADS, s3, stream>>>(xb, dtf, Af, bb, cb, states,
                                       static_cast<__nv_bfloat16*>(y), S, H, P, N, hg, x_sb,
                                       x_ss, b_sb, b_ss, c_sb, c_ss);
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

// Tensor-core body: bf16 x, B, C and y; P % 16 == 0, P <= 256, N % 16 == 0;
// x, B, C base pointers and batch/sequence strides 16-byte aligned (the
// wrapper checks).  Other layouts as ssd_scan_fwd.  scratch: f32,
// Bt * ceil(S / 64) * H * (P * N + 1) elements.
extern "C" int ssd_scan_tc_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* h0, void* y, void* hT,
                               void* scratch, int Bt, int S, int H, int P, int N,
                               long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                               long long c_sb, long long c_ss, void* stream) {
  if (Bt <= 0 || S < 0 || H <= 0 || H > 65535 || Bt > 65535 || P <= 0 || P % 16 != 0 ||
      P > 256 || N <= 0 || N % 16 != 0 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t err =
      N <= 64 ? launch_tc<64>(x, dt, A, Bm, Cm, h0, y, hT, sc, Bt, S, H, P, N, x_sb, x_ss, b_sb,
                              b_ss, c_sb, c_ss, st)
              : launch_tc<128>(x, dt, A, Bm, Cm, h0, y, hT, sc, Bt, S, H, P, N, x_sb, x_ss,
                               b_sb, b_ss, c_sb, c_ss, st);
  return (int)err;
}
