// Split-K flash-decoding over an int8 KV cache for Hopper, sm_90a.
//
// Replaces: repro/kernels/decode_attention.py, decode_attention_q8_pallas
// (kernel body _dec_q8_kernel).  Same function: one query token per
// sequence against a cache of int8 K and V with one f32 scale per (token,
// KV head), k = k_q * k_s and v = v_q * v_s; the G = Hq / Hkv query heads
// of a KV group are packed together and attend over cache slots
// [0, min(length[b], Smax)) with an online softmax in f32; slots past the
// length are never read.  length is per sequence (ragged continuous
// batching), clamped to [0, Smax] on the device; a scalar length arrives
// broadcast by the wrapper.  A sequence of length 0 gets zeros.
//
// The scales are never applied to a row: score t is (q . k_q[t]) * k_s[t],
// and probability t is multiplied by v_s[t] before the PV product (the
// running sum takes it unscaled), so the int8 values are only widened.
//
// What bounds it on an H100: the cache is read once, D + Dv bytes plus 8
// bytes of scales per (slot, KV head), for 2 * G * (D + Dv) operations, about
// G operations per byte: far below the ~295 that would make the tensor cores
// the limit, so HBM bytes bound it, at about half the bytes of the bf16
// cache (1.37 MB, 0.41 us, for 8 smollm-135m slots mid-generation).  The
// design is the bf16 split-K decode's (decode_attention.cu):
//
// * decode_q8_split_kernel: the grid is (Hkv x head chunks, B, NS) with
//   NS = ceil(Smax / split), sized from Smax with no host sync; block
//   (hk, b, s) takes cache rows [s * split, (s + 1) * split) of its slot,
//   and a block that starts at or past the slot's length writes an empty
//   partial (m = -inf, l = 0) and exits.  A 64-wide int8 row is 64 bytes:
//   a team of L lanes reads it with one 16-byte load each (L = 4 at
//   D = 64, so a warp reads 8 rows at once; L * 16 >= max(D, Dv) up to
//   256), the row's k_s and v_s beside it.  Each lane keeps U = 2 rows of K
//   and V in flight as raw words and widens the int8 values to f32 only
//   when it uses them.  The G dot products of a row are summed across its
//   team by shuffles.  The block's query heads sit pre-scaled in shared
//   memory, read with 16-byte loads where used; the running max and sum
//   and the accumulator stay in registers.  A lane holds 16 accumulator
//   columns of each of its heads, so a block takes at most 4 query heads;
//   further heads go to further blocks.  (Holding 16 query columns per head
//   in registers as well took 228 registers at 4 heads, two blocks per SM,
//   and ran slower than this.)  The teams, then the four warps, merge their softmax states,
//   and the block writes (m, l, acc[G][Dv]) in f32 to a scratch tensor the
//   wrapper allocates, in the bf16 decode's layout.
// * decode_combine_kernel (decode_split.cuh, the bf16 decode's own) merges
//   the partials and writes o in q's dtype.
//
// split = 64 (the wrapper's SPLIT): 8 smollm-135m slots at Smax = 2048
// launch 3 x 8 x 32 = 768 blocks, ~170 of them holding rows at a
// mid-generation batch's lengths, and at D = 64 the block's 32 teams take
// its 64 rows in one round of loads (8.7 KB in flight per block).
//
// C interface, called through ctypes; returns the cudaError_t of the
// launches.
#include "decode_split.cuh"

namespace {

constexpr int E = 16;  // int8 elements of a row per lane: one 16-byte load
constexpr int U = 2;   // rows in flight per team

// columns [c0, c0 + E) of an int8 row of `width` elements as four 32-bit
// words, zero past the width; vec: width % E == 0 and 16-byte aligned rows
__device__ __forceinline__ uint4 load_q8(const int8_t* row, int c0, int width, bool vec) {
  if (vec && c0 + E <= width) return *reinterpret_cast<const uint4*>(row + c0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (c0 + i < width) w[i / 4] |= (uint32_t)(uint8_t)row[c0 + i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void widen(const uint4& x, float (&f)[E]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = (float)(int8_t)(w[i] >> (8 * j));
  }
}

// GB: query heads per block (a chunk of the group); L: lanes per row (runtime,
// a power of two <= 32, L * E >= max(D, Dv)).
template <typename T, int GB>
__global__ void __launch_bounds__(THREADS) decode_q8_split_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k, const float* __restrict__ k_s,
    const int8_t* __restrict__ v, const float* __restrict__ v_s,
    const int* __restrict__ length, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int Smax, int Hq, int Hkv, int D, int Dv, int L, int split,
    int vec, float scale_log2) {
  extern __shared__ __align__(16) float red_acc[];  // WARPS x GB x Dv, then qs
  __shared__ float red_m[WARPS][GB], red_l[WARPS][GB];

  const int G = Hq / Hkv, nchunk = (G + GB - 1) / GB;
  const int hk = blockIdx.x / nchunk, g0 = (blockIdx.x % nchunk) * GB;
  const int Gb = min(GB, G - g0);
  const int b = blockIdx.y, sp = blockIdx.z, NS = gridDim.z;
  const int h0 = hk * G + g0;  // first query head of this block
  const int len = min(max(length[b], 0), Smax);
  const int s_begin = sp * split, s_end = min(s_begin + split, len);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (s_begin >= len) {  // nothing to read: an empty partial
    if (tid < Gb) {
      float* ml = part_ml + ((size_t)(b * Hq + h0 + tid) * NS + sp) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }

  const int teams = THREADS / L, team = tid / L, c0 = (lane % L) * E;
  const bool vc = vec != 0;
  const int W = L * E;  // query row pitch in shared memory: every lane's columns
  float* qs = red_acc + WARPS * GB * Dv;  // GB x W, pre-scaled, zero past D
  for (int i = tid; i < GB * W; i += THREADS) {
    const int g = i / W, c = i % W;
    qs[i] = g < Gb && c < D ? to_f(q[((size_t)b * Hq + h0 + g) * D + c]) * scale_log2 : 0.f;
  }
  __syncthreads();
  float acc[GB][E], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const size_t rk = (size_t)Hkv * D, rv = (size_t)Hkv * Dv;
  const int8_t* kb = k + (size_t)b * Smax * rk + (size_t)hk * D;
  const int8_t* vb = v + (size_t)b * Smax * rv + (size_t)hk * Dv;
  const float* ksb = k_s + (size_t)b * Smax * Hkv + hk;
  const float* vsb = v_s + (size_t)b * Smax * Hkv + hk;

  // every team runs the same number of iterations, so the shuffles below
  // always see the whole warp
  for (int base = s_begin; base < s_end; base += teams * U) {
    uint4 kr[U], vr[U];
    float ksc[U], vsc[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + team + u * teams;
      ok[u] = r < s_end;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 0.f;
      if (ok[u]) {
        kr[u] = load_q8(kb + (size_t)r * rk, c0, D, vc);
        vr[u] = load_q8(vb + (size_t)r * rv, c0, Dv, vc);
        ksc[u] = ksb[(size_t)r * Hkv];
        vsc[u] = vsb[(size_t)r * Hkv];
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= Gb) break;
      float sc[U];
      float mx = -INFINITY;
      float qr[E];
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 t = *reinterpret_cast<const float4*>(qs + g * W + c0 + e);
        qr[e] = t.x; qr[e + 1] = t.y; qr[e + 2] = t.z; qr[e + 3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[E];
        widen(kr[u], kf);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[e], kf[e], dot);
        for (int o = L / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[u] = ok[u] ? dot * ksc[u] : -INFINITY;
        mx = fmaxf(mx, sc[u]);
      }
      const float mn = fmaxf(m[g], mx), bs = merge_base(mn);
      const float al = exp2f(m[g] - bs);
      m[g] = mn;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] = exp2f(sc[u] - bs);
        sum += sc[u];
      }
      l[g] = l[g] * al + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= al;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[E];
        widen(vr[u], vf);
        const float pv = sc[u] * vsc[u];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
      }
    }
  }

  // merge the teams of a warp (lane offsets L, 2L, ... apart)
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= Gb) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo), bs = merge_base(mn);
      const float wa = exp2f(m[g] - bs), wb = exp2f(mo - bs);
      m[g] = mn;
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * wa + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * wb;
    }
  }
  // then the warps, through shared memory
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= Gb) break;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (c0 + e < Dv) red_acc[(warp * GB + g) * Dv + c0 + e] = acc[g][e];
      if (lane == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Gb * Dv; i += THREADS) {
    const int g = i / Dv, c = i % Dv;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, red_m[w][g]);
    const float bs = merge_base(mt);
    float a = 0.f, lt = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(red_m[w][g] - bs);
      a += wt * red_acc[(w * GB + g) * Dv + c];
      lt += wt * red_l[w][g];
    }
    const size_t row = (size_t)(b * Hq + h0 + g) * NS + sp;
    part_acc[row * Dv + c] = a;
    if (c == 0) {
      part_ml[row * 2] = mt;
      part_ml[row * 2 + 1] = lt;
    }
  }
}

template <typename T, int GB>
cudaError_t launch(const void* q, const void* k, const void* k_s, const void* v,
                   const void* v_s, const int* length, float* part_ml, float* part_acc,
                   void* o, int B, int Smax, int Hq, int Hkv, int D, int Dv, int L, int split,
                   int vec, float scale_log2, cudaStream_t stream) {
  const int G = Hq / Hkv, NS = (Smax + split - 1) / split;
  const size_t smem = sizeof(float) * (WARPS * GB * (size_t)Dv + (size_t)GB * L * E);
  decode_q8_split_kernel<T, GB>
      <<<dim3(Hkv * ((G + GB - 1) / GB), B, NS), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const int8_t*>(k),
          static_cast<const float*>(k_s), static_cast<const int8_t*>(v),
          static_cast<const float*>(v_s), length, part_ml, part_acc, Smax, Hq, Hkv, D, Dv, L,
          split, vec, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T>(part_ml, part_acc, o, B, Hq, Hkv, Dv, NS, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* k_s, const void* v,
                     const void* v_s, const int* length, float* part_ml, float* part_acc,
                     void* o, int B, int Smax, int Hq, int Hkv, int D, int Dv, int L, int split,
                     int vec, float sl2, cudaStream_t st) {
  const int G = Hq / Hkv;
  if (G == 1)
    return launch<T, 1>(q, k, k_s, v, v_s, length, part_ml, part_acc, o, B, Smax, Hq, Hkv, D,
                        Dv, L, split, vec, sl2, st);
  if (G == 2)
    return launch<T, 2>(q, k, k_s, v, v_s, length, part_ml, part_acc, o, B, Smax, Hq, Hkv, D,
                        Dv, L, split, vec, sl2, st);
  return launch<T, 4>(q, k, k_s, v, v_s, length, part_ml, part_acc, o, B, Smax, Hq, Hkv, D, Dv,
                      L, split, vec, sl2, st);
}

}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16.  Layouts (contiguous):
// q (B,1,Hq,D), k (B,Smax,Hkv,D) int8, k_s (B,Smax,Hkv) f32, v (B,Smax,Hkv,Dv)
// int8, v_s (B,Smax,Hkv) f32, length int32 (B,), o (B,1,Hq,Dv).
// scratch: f32, B * Hq * ceil(Smax / split) * (2 + Dv) elements.
extern "C" int decode_attention_q8_fwd(const void* q, const void* k, const void* k_s,
                                       const void* v, const void* v_s, const void* length,
                                       void* o, void* scratch, int dtype, int B, int Smax,
                                       int Hq, int Hkv, int D, int Dv, int split, float scale,
                                       void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || Dv <= 0 ||
      Dv > 256 || split <= 0 || (Smax + split - 1) / split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NS = (Smax + split - 1) / split;
  float* part_ml = static_cast<float*>(scratch);
  float* part_acc = part_ml + (size_t)B * Hq * NS * 2;
  const int width = D > Dv ? D : Dv;
  int L = 1;  // lanes per row: L * 16 >= the wider head dim
  while (L * E < width) L *= 2;
  const int vec = D % E == 0 && Dv % E == 0 && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const int* len = static_cast<const int*>(length);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, k_s, v, v_s, len, part_ml, part_acc, o, B,
                                           Smax, Hq, Hkv, D, Dv, L, split, vec, sl2, st)
      : dtype == 0 ? dispatch<float>(q, k, k_s, v, v_s, len, part_ml, part_acc, o, B, Smax, Hq,
                                     Hkv, D, Dv, L, split, vec, sl2, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
