// Split-K flash-decoding for Hopper, sm_90a: one query token per sequence
// against its KV cache.
//
// Replaces: repro/kernels/decode_attention.py, decode_attention_pallas
// (kernel body _dec_kernel).  Same function: the G = Hq / Hkv query heads of
// a KV group are packed together and attend over cache slots
// [0, min(length[b], Smax)) with an online softmax in f32; slots past the
// length are never read.  length is per sequence (ragged continuous
// batching), clamped to [0, Smax] on the device; a scalar length arrives
// broadcast by the wrapper.  A sequence of length 0 gets zeros.  G need not
// be a power of two (smollm-135m has G = 3).
//
// What bounds it on an H100: every cached K/V byte up to the length is read
// once and used for 2 * G * (D + Dv) operations per slot, about G / 2
// operations per byte in bf16, far below the ~295 the card needs to be
// compute-bound.  So it is bound by HBM bytes: sum(length) * Hkv *
// (D + Dv) * sizeof(T) at 3.35 TB/s (2.6 MB, 0.8 us, for 8 smollm-135m
// slots mid-generation).  Reaching that takes many blocks with many loads
// in flight, not one long walk per (sequence, KV head):
//
// * decode_split_kernel: the grid is (Hkv x head chunks, B, NS) with
//   NS = ceil(Smax / split); the lengths stay on the device, so the grid is
//   sized from Smax with no host sync.  Block (hk, b, s) takes cache rows
//   [s * split, (s + 1) * split) of its slot; a block that starts at or past
//   the slot's length writes an empty partial (m = -inf, l = 0) and exits.
//   Inside, a row of K (or V) is read by a team of L lanes with one 16-byte
//   load each (8 bf16; two loads for 8 f32): L = 8 for a 64-wide bf16 row,
//   so a warp reads 4 rows at once and each lane keeps 4 rows' loads in
//   flight, held as raw 16-byte words until used (77 registers at G = 1 in
//   bf16, so many blocks share an SM).  The G dot products of a row are
//   summed across its team by shuffles; the packed query heads, the running
//   max and sum and the accumulator stay in registers.  The teams, then the
//   four warps, merge their softmax states, and the block writes
//   (m, l, acc[G][Dv]) in f32 to a scratch tensor the wrapper allocates.
//   Query heads beyond 8 per group go to further blocks (head chunks).
// * decode_combine_kernel (decode_split.cuh, shared with the int8 decode):
//   one block per (KV head group, sequence) merges the NS partials of all
//   its G heads at once and writes o in q's dtype.  The live pieces (l > 0)
//   are a prefix, so their partials are read with independent loads, not
//   one dependent load per piece.
//
// split = 64 (the wrapper's SPLIT): 8 smollm-135m slots at Smax = 2048 launch
// 3 x 8 x 32 = 768 blocks (>= 2 x 132 SMs), and the ~3300 live rows of a
// mid-generation batch still give ~170 working blocks; a 64-row block is
// 16 KB of K/V for a 64-wide bf16 head, enough to amortise its partial
// (G x Dv x 4 bytes) and its share of the combine.
//
// C interface, called through ctypes; returns the cudaError_t of the
// launches.
#include "decode_split.cuh"

namespace {

constexpr int E = 8;  // elements of a row per lane

// A lane's 8 elements of a row as they sit in memory: one 16-byte word for
// bf16, two for f32.  Rows in flight stay in this form (4 registers per bf16
// row) and are widened to f32 only when used.
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 w; };
template <> struct Raw<float> { uint4 w0, w1; };

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 a, __nv_bfloat16 b) {
  __nv_bfloat162 v = __halves2bfloat162(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// columns [c0, c0 + E) of a row of `width` elements, zero past the width;
// vec: width % E == 0 and 16-byte aligned rows, so one chunk is one or two
// 16-byte loads
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* row, int c0, int width,
                                           bool vec, Raw<__nv_bfloat16>& x) {
  if (vec && c0 + E <= width) {
    x.w = *reinterpret_cast<const uint4*>(row + c0);
    return;
  }
  __nv_bfloat16 e[E];
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = c0 + i < width ? row[c0 + i] : __float2bfloat16(0.f);
  x.w = make_uint4(pack_bf16x2(e[0], e[1]), pack_bf16x2(e[2], e[3]), pack_bf16x2(e[4], e[5]),
                   pack_bf16x2(e[6], e[7]));
}
__device__ __forceinline__ void load_chunk(const float* row, int c0, int width, bool vec,
                                           Raw<float>& x) {
  if (vec && c0 + E <= width) {
    x.w0 = *reinterpret_cast<const uint4*>(row + c0);
    x.w1 = *reinterpret_cast<const uint4*>(row + c0 + 4);
    return;
  }
  float e[E];
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = c0 + i < width ? row[c0 + i] : 0.f;
  x.w0 = make_uint4(__float_as_uint(e[0]), __float_as_uint(e[1]), __float_as_uint(e[2]),
                    __float_as_uint(e[3]));
  x.w1 = make_uint4(__float_as_uint(e[4]), __float_as_uint(e[5]), __float_as_uint(e[6]),
                    __float_as_uint(e[7]));
}

__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& x, float (&f)[E]) {
  const uint32_t w[4] = {x.w.x, x.w.y, x.w.z, x.w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void widen(const Raw<float>& x, float (&f)[E]) {
  f[0] = __uint_as_float(x.w0.x); f[1] = __uint_as_float(x.w0.y);
  f[2] = __uint_as_float(x.w0.z); f[3] = __uint_as_float(x.w0.w);
  f[4] = __uint_as_float(x.w1.x); f[5] = __uint_as_float(x.w1.y);
  f[6] = __uint_as_float(x.w1.z); f[7] = __uint_as_float(x.w1.w);
}

// GB: query heads per block (a chunk of the group); L: lanes per row (runtime,
// a power of two <= 32, L * E >= max(D, Dv)).
template <typename T, int GB>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ length, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int Smax, int Hq, int Hkv, int D, int Dv, int L, int split,
    int vec, float scale_log2) {
  constexpr int U = GB >= 8 ? 2 : 4;  // rows in flight per team
  extern __shared__ float red_acc[];  // WARPS x GB x Dv
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
  float qr[GB][E], acc[GB][E], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    Raw<T> raw{};
    if (g < Gb) load_chunk(q + ((size_t)b * Hq + h0 + g) * D, c0, D, vc, raw);
    widen(raw, qr[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[g][e] *= scale_log2;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const size_t rk = (size_t)Hkv * D, rv = (size_t)Hkv * Dv;
  const T* kb = k + (size_t)b * Smax * rk + (size_t)hk * D;
  const T* vb = v + (size_t)b * Smax * rv + (size_t)hk * Dv;

  // every team runs the same number of iterations, so the shuffles below
  // always see the whole warp
  for (int base = s_begin; base < s_end; base += teams * U) {
    Raw<T> kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + team + u * teams;
      ok[u] = r < s_end;
      kr[u] = Raw<T>{};
      vr[u] = Raw<T>{};
      if (ok[u]) {
        load_chunk(kb + (size_t)r * rk, c0, D, vc, kr[u]);
        load_chunk(vb + (size_t)r * rv, c0, Dv, vc, vr[u]);
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= Gb) break;
      float sc[U];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[E];
        widen(kr[u], kf);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        for (int o = L / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[u] = ok[u] ? dot : -INFINITY;
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
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(sc[u], vf[e], acc[g][e]);
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
cudaError_t launch(const void* q, const void* k, const void* v, const int* length,
                   float* part_ml, float* part_acc, void* o, int B, int Smax, int Hq, int Hkv,
                   int D, int Dv, int L, int split, int vec, float scale_log2,
                   cudaStream_t stream) {
  const int G = Hq / Hkv, NS = (Smax + split - 1) / split;
  const size_t smem = sizeof(float) * WARPS * GB * (size_t)Dv;
  decode_split_kernel<T, GB><<<dim3(Hkv * ((G + GB - 1) / GB), B, NS), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      part_ml, part_acc, Smax, Hq, Hkv, D, Dv, L, split, vec, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T>(part_ml, part_acc, o, B, Hq, Hkv, Dv, NS, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* length,
                     float* part_ml, float* part_acc, void* o, int B, int Smax, int Hq,
                     int Hkv, int D, int Dv, int L, int split, int vec, float sl2,
                     cudaStream_t st) {
  const int G = Hq / Hkv;
  if (G == 1)
    return launch<T, 1>(q, k, v, length, part_ml, part_acc, o, B, Smax, Hq, Hkv, D, Dv, L,
                        split, vec, sl2, st);
  if (G <= 4)
    return launch<T, 4>(q, k, v, length, part_ml, part_acc, o, B, Smax, Hq, Hkv, D, Dv, L,
                        split, vec, sl2, st);
  return launch<T, 8>(q, k, v, length, part_ml, part_acc, o, B, Smax, Hq, Hkv, D, Dv, L, split,
                      vec, sl2, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Layouts (contiguous): q (B,1,Hq,D),
// k (B,Smax,Hkv,D), v (B,Smax,Hkv,Dv), length int32 (B,), o (B,1,Hq,Dv).
// scratch: f32, B * Hq * ceil(Smax / split) * (2 + Dv) elements.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* length, void* o, void* scratch, int dtype,
                                    int B, int Smax, int Hq, int Hkv, int D, int Dv, int split,
                                    float scale, void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || Dv <= 0 ||
      Dv > 256 || split <= 0 || (Smax + split - 1) / split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NS = (Smax + split - 1) / split;
  float* part_ml = static_cast<float*>(scratch);
  float* part_acc = part_ml + (size_t)B * Hq * NS * 2;
  const int width = D > Dv ? D : Dv;
  int L = 4;  // lanes per row: L * 8 >= the wider head dim
  while (L * E < width) L *= 2;
  const int vec = D % E == 0 && Dv % E == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const int* len = static_cast<const int*>(length);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, len, part_ml, part_acc, o, B, Smax, Hq, Hkv,
                                           D, Dv, L, split, vec, sl2, st)
      : dtype == 0 ? dispatch<float>(q, k, v, len, part_ml, part_acc, o, B, Smax, Hq, Hkv, D,
                                     Dv, L, split, vec, sl2, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
