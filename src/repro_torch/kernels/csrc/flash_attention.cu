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
// bf16 tensor-core rate (989 TFLOP/s) is the bound, not the 3.35 TB/s of
// HBM.  Two bodies, chosen by the wrapper by shape, never by a fallback:
//
// * fa_tc_kernel (flash_attention_tc_fwd): bf16 with D % 16 == 0 and
//   Dv % 16 == 0 and 16-byte aligned q/k/v, the shapes every served model
//   gives it.  FA2-style: one block per (64-row query tile, query head,
//   batch), four warps of 16 query rows each.  Both products run on the
//   tensor cores (mma.sync m16n8k16 bf16 -> f32).  Q's A-fragments are
//   loaded once (ldmatrix) and stay in registers for the whole key loop.
//   K and V tiles arrive by 16-byte cp.async copies into a two-stage ring
//   in shared memory, the next tile in flight while this one is computed;
//   rows are padded by 16 bytes so the eight rows an ldmatrix (or
//   ldmatrix.trans, for V) reads fall in eight different bank groups.  The
//   online softmax runs on the accumulator fragments (row max and sum by
//   quad shuffles, exp2 with log2(e) folded into the scale), and the
//   probabilities are packed to bf16 A-fragments in registers for P.V: no
//   score or probability ever touches shared or device memory.  The mask
//   test runs per element only on the tiles that cross the causal
//   diagonal, the window edge or the ragged end of Sk; a warp skips the
//   tiles that are masked for all its rows.  The causal query tiles are
//   launched longest first.  Head dims are padded to a template width P in
//   {32, 64, 128, 256} (zero-filled columns), so the accumulators are
//   registers; D = Dv = 64 runs at P = 64 with no padding.
// * fa_fwd_kernel (flash_attention_fwd): f32, and bf16 at any other head
//   dim.  Both products on the CUDA cores in f32, one row's softmax state
//   per four threads, tiles staged in shared memory as f32.  It keeps f32
//   to 2e-5 of the plain version, which no tensor-core type does (bf16
//   keeps 8 bits, TF32 about 1e-3).
//
// K/V are never replicated across the G heads of a group: every block reads
// its KV head in place.  wgmma, TMA and warp specialisation (the FA3
// structure) are left for later work.
//
// C interface, called through ctypes; each entry point returns the
// cudaError_t of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_sm80.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core body (bf16, D and Dv multiples of 16)
// ---------------------------------------------------------------------------
// P: head dims padded to P (both D and Dv <= P); four warps of 16 query rows
// per block (eight warps of 128 rows measured slower at smollm-135m's
// prefill: half the blocks on 132 SMs); BK keys per tile (32 at P = 256, to
// keep the accumulators in registers); rows padded by 8 bf16 = 16 bytes in
// shared memory.
template <int P>
struct TcCfg {
  static constexpr int WARPS = 4;
  static constexpr int BQ = WARPS * 16;
  static constexpr int BK = P <= 128 ? 64 : 32;
  static constexpr int LDS = P + 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * ((size_t)BQ + 4 * (size_t)BK) * LDS;
};

template <int P>
__global__ void __launch_bounds__(TcCfg<P>::THREADS) fa_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq, int Sk,
    int Hq, int Hkv, int D, int Dv, int causal, int window, float scale_log2) {
  using C = TcCfg<P>;
  constexpr int BQ = C::BQ, BKT = C::BK, LDS = C::LDS, NTHR = C::THREADS;
  constexpr int NT = BKT / 8;  // score n-tiles (8 keys each) per tile
  constexpr int KD = P / 16;   // k-steps of q k^T
  constexpr int NV = P / 8;    // output n-tiles (8 columns each)
  constexpr int CH = P / 8;    // 16-byte chunks per padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LDS
  __nv_bfloat16* Ks = Qs + BQ * LDS;                                // 2 x BKT x LDS
  __nv_bfloat16* Vs = Ks + 2 * BKT * LDS;                           // 2 x BKT x LDS

  // causal: the last query tiles see the most keys, so they start first
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, q0 = qt * BQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int off = Sk - Sq;  // query row i sits at key position i + off

  const size_t qs = (size_t)Hq * D, ks = (size_t)Hkv * D, vs = (size_t)Hkv * Dv;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * qs + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * ks + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * vs + (size_t)hk * Dv;

  // rows [row0, row0 + rows) of a (total x width) head slice -> dst, zero
  // past the last row and the head dim (width % 16 == 0: a chunk is all in
  // or all out)
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, size_t stride,
                       int row0, int total, int width, int rows) {
    for (int c = tid; c < rows * CH; c += NTHR) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool ok = row0 + r < total && col < width;
      cp_async16(smem_addr(dst + r * LDS + col),
                 ok ? src + (size_t)(row0 + r) * stride + col : src, ok ? 16 : 0);
    }
  };

  // key range any row of this tile can see; tiles outside it are skipped
  const int q_last = min(q0 + BQ, Sq) - 1 + off;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int t_first = k_lo / BKT, t_last = k_hi < k_lo ? t_first - 1 : k_hi / BKT;

  load_rows(Qs, qb, qs, q0, Sq, D, BQ);
  if (t_first <= t_last) {
    load_rows(Ks, kb, ks, t_first * BKT, Sk, D, BKT);
    load_rows(Vs, vb, vs, t_first * BKT, Sk, Dv, BKT);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows; the thread holds rows g and g + 8 of them
  const int g = lane >> 2, tq = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const int wq0 = q0 + warp * 16;
  const int wpos_lo = wq0 + off, wpos_hi = wq0 + 15 + off;
  const int rpos0 = wq0 + g + off, rpos1 = rpos0 + 8;
  const bool warp_live = wq0 < Sq;

  uint32_t qf[KD][4];
  {
    const __nv_bfloat16* base = Qs + (warp * 16 + mr + (mat & 1) * 8) * LDS + (mat >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], smem_addr(base + kk * 16));
  }

  float oacc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int stage = 0;
  for (int t = t_first; t <= t_last; ++t, stage ^= 1) {
    if (t > t_first) {
      cp_async_wait_all();  // tile t has landed ...
      __syncthreads();      // ... for every thread, and tile t - 1 is consumed
    }
    if (t < t_last) {
      const int nxt = stage ^ 1;
      load_rows(Ks + nxt * BKT * LDS, kb, ks, (t + 1) * BKT, Sk, D, BKT);
      load_rows(Vs + nxt * BKT * LDS, vb, vs, (t + 1) * BKT, Sk, Dv, BKT);
      cp_async_commit();
    }
    const int k0 = t * BKT;
    const bool skip = !warp_live || (causal && k0 > wpos_hi) ||
                      (window > 0 && k0 + BKT - 1 <= wpos_lo - window);
    if (skip) continue;
    const bool need_mask = !(k0 + BKT <= Sk && (!causal || k0 + BKT - 1 <= wpos_lo) &&
                             (window <= 0 || k0 > wpos_hi - window));
    const __nv_bfloat16* Kt = Ks + stage * BKT * LDS;
    const __nv_bfloat16* Vt = Vs + stage * BKT * LDS;

    // S = q k^T on the tensor cores
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk * 16 >= D) break;
      const __nv_bfloat16* kbase = Kt + (mr + (mat >> 1) * 8) * LDS + kk * 16 + (mat & 1) * 8;
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_addr(kbase + jp * 16 * LDS));
        mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale into log2 units; per-element mask only on edge tiles
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + tq * 2 + (e & 1);
          const int rp = e < 2 ? rpos0 : rpos1;
          const bool ok = key < Sk && (!causal || key <= rp) &&
                          (window <= 0 || key > rp - window);
          s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      }
    }

    // online softmax on the fragments: rows g (elements 0, 1) and g + 8 (2, 3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key yet keeps -inf: subtract 0, not -inf
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - base0), al1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - base0);
      s[j][1] = exp2f(s[j][1] - base0);
      s[j][2] = exp2f(s[j][2] - base1);
      s[j][3] = exp2f(s[j][3] - base1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + sum0;  // this thread's columns; the quad is summed at the end
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      oacc[j][0] *= al0;
      oacc[j][1] *= al0;
      oacc[j][2] *= al1;
      oacc[j][3] *= al1;
    }

    // O += P V: the score fragments of two n-tiles are the A-fragment of a
    // 16-key step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vbase =
          Vt + (kk * 16 + mr + (mat & 1) * 8) * LDS + (mat >> 1) * 8;
#pragma unroll
      for (int jp = 0; jp < NV / 2; ++jp) {
        if (jp * 16 >= Dv) break;
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_addr(vbase + jp * 16));
        mma_bf16(oacc[2 * jp], pa, bf[0], bf[1]);
        mma_bf16(oacc[2 * jp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row0 = wq0 + g, row1 = row0 + 8;
  __nv_bfloat16* o0 = o + ((size_t)(b * Sq + row0) * Hq + h) * Dv;
  __nv_bfloat16* o1 = o + ((size_t)(b * Sq + row1) * Hq + h) * Dv;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = j * 8 + tq * 2;
    if (col < Dv) {
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(oacc[j][0] * inv0, oacc[j][1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(oacc[j][2] * inv1, oacc[j][3] * inv1);
    }
  }
}

template <int P>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Sk, int Hq, int Hkv, int D, int Dv, int causal, int window,
                      float scale_log2, cudaStream_t stream) {
  using C = TcCfg<P>;
  auto kern = fa_tc_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, Hq, Hkv,
      D, Dv, causal, window, scale_log2);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 ||
         Dv <= 0 || Dv > 256;
}

}  // namespace

// Layouts (contiguous): q (B,Sq,Hq,D), k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv),
// o (B,Sq,Hq,Dv).  window <= 0: no window.

// CUDA-core body.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int Dv, int causal, int window, float scale,
                                   void* stream) {
  if (bad_shape(B, Sq, Sk, Hq, Hkv, D, Dv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? dispatch_dv<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv,
                                              causal, window, scale, st)
      : dtype == 0 ? dispatch_dv<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal,
                                        window, scale, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// Tensor-core body: bf16 only, D and Dv multiples of 16, 16-byte aligned
// pointers.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
                                      int causal, int window, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, Hq, Hkv, D, Dv) || D % 16 != 0 || Dv % 16 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const int p = D > Dv ? D : Dv;
  cudaError_t err;
  if (p <= 32)
    err = launch_tc<32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, sl2, st);
  else if (p <= 64)
    err = launch_tc<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, sl2, st);
  else if (p <= 128)
    err = launch_tc<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, sl2, st);
  else
    err = launch_tc<256>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, sl2, st);
  return (int)err;
}
