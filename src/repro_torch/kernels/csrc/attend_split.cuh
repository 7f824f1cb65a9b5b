// The split-and-merge body of single-query GQA flash-decode, for Hopper:
// shared by the paged (paged_attn.cu) and the dense (decode_attn.cu)
// int8 / fp8 / bf16 KV kernels.
//
// A block of THREADS threads attends q (G query heads of one kv head) over
// one split of T tokens of one row: attend_split loads every code and
// scale of the split's live tokens into shared memory as one batch of
// cp.async copies (16-byte copies for codes, 4-byte for scales), then
// computes scores by SUB lanes per (token, query head), the split's max and
// sum by warp shuffles (one warp per query head), and P.V by threads over
// (query head, 4 columns) and token slices, the slices summed in a fixed
// order. Where token t of the split lives is the caller's map ``rows``:
// rows(t) is the row of the (rows, d) view of the codes and of the (rows,)
// view of the scales. finish_split writes the (G, d) output: directly
// when the row has one live split, else through an f32 workspace, the
// last block of the (row, kv head) to finish (a counter after
// __threadfence) merging the live splits in split order, so reruns are
// bit-identical.
//
// The shared-memory layout (make_layout) is mirrored in Python by
// kernels/split_attn.py::smem_bytes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int SUB = 4;         // lanes per (token, query head) score
constexpr int PAD = 16;        // bytes after each K/V row in shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr float kNegInf = -1e30f;

enum Kv { BF16 = 0, INT8 = 1, FP8 = 2 };

template <int KV> struct KvBytes { static constexpr int value = KV == BF16 ? 2 : 1; };

// ---------------------------------------------------------------------------
// shared-memory layout of one block (mirrored by split_attn.py::smem_bytes)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// token slices of the P.V step: threads over (query head, 4 columns),
// the rest of the block over tokens
__host__ __device__ __forceinline__ int pv_slices(int G, int d) {
  const int cols4 = G * d / 4;
  return cols4 >= THREADS ? 1 : THREADS / cols4;
}

struct Layout {
  size_t k, v, ks, vs, q, p, red, m, l, pages, flag, total, rs;
};

__host__ __device__ inline Layout make_layout(int T, int G, int d, int kv_bytes, int pps) {
  Layout L;
  L.rs = (size_t)d * kv_bytes + PAD;
  size_t o = 0;
  L.k = o;     o = align16(o + (size_t)T * L.rs);          // K codes (T, rs)
  L.v = o;     o = align16(o + (size_t)T * L.rs);          // V codes (T, rs)
  L.ks = o;    o = align16(o + 4 * (size_t)T);             // K scales (T,)
  L.vs = o;    o = align16(o + 4 * (size_t)T);             // V scales (T,)
  L.q = o;     o = align16(o + 4 * (size_t)G * d);         // q (G, d) f32
  L.p = o;     o = align16(o + 4 * (size_t)G * T);         // scores, then probabilities
  L.red = o;   o = align16(o + 4 * (size_t)pv_slices(G, d) * G * d);  // P.V per slice
  L.m = o;     o = align16(o + 4 * (size_t)G);             // split max (G,)
  L.l = o;     o = align16(o + 4 * (size_t)G);             // split denominator (G,)
  L.pages = o; o = align16(o + 4 * (size_t)pps);           // the split's page ids
  L.flag = o;  o = align16(o + 4);                         // "this block merges"
  L.total = o;
  return L;
}

struct Smem {
  unsigned char *k, *v;
  float *ks, *vs, *q, *p, *red, *m, *l;
  int *pages, *flag;
  int rs;
  __device__ Smem(unsigned char* base, const Layout& L)
      : k(base + L.k), v(base + L.v), ks((float*)(base + L.ks)), vs((float*)(base + L.vs)),
        q((float*)(base + L.q)), p((float*)(base + L.p)), red((float*)(base + L.red)),
        m((float*)(base + L.m)), l((float*)(base + L.l)), pages((int*)(base + L.pages)),
        flag((int*)(base + L.flag)), rs((int)L.rs) {}
};

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// byte j of a word of int8 / fp8 codes, as f32
template <int KV>
__device__ __forceinline__ float code_at(uint32_t w, int j) {
  const uint32_t byte = (w >> (8 * j)) & 0xffu;
  if (KV == INT8) return (float)(int8_t)byte;
  __nv_fp8_e4m3 v;
  v.__x = (__nv_fp8_storage_t)byte;
  return float(v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// q (16 bytes of codes' worth of f32, 16-byte aligned) . one 16-byte chunk
template <int KV>
__device__ __forceinline__ float dot_word(uint32_t w, float4 a, float s) {
  s = fmaf(a.x, code_at<KV>(w, 0), s);
  s = fmaf(a.y, code_at<KV>(w, 1), s);
  s = fmaf(a.z, code_at<KV>(w, 2), s);
  return fmaf(a.w, code_at<KV>(w, 3), s);
}

__device__ __forceinline__ float dot_bf16(uint32_t w0, uint32_t w1, float4 a, float s) {
  s = fmaf(a.x, bf16_lo(w0), s);
  s = fmaf(a.y, bf16_hi(w0), s);
  s = fmaf(a.z, bf16_lo(w1), s);
  return fmaf(a.w, bf16_hi(w1), s);
}

template <int KV>
__device__ __forceinline__ float dot_chunk(uint4 c, const float* __restrict__ qv) {
  const float4* q4 = reinterpret_cast<const float4*>(qv);
  if (KV == BF16)                      // 8 values
    return dot_bf16(c.z, c.w, q4[1], dot_bf16(c.x, c.y, q4[0], 0.f));
  float s = dot_word<KV>(c.x, q4[0], 0.f);   // 16 values
  s = dot_word<KV>(c.y, q4[1], s);
  s = dot_word<KV>(c.z, q4[2], s);
  return dot_word<KV>(c.w, q4[3], s);
}

// 4 consecutive values of a shared-memory K/V row, as f32
template <int KV>
__device__ __forceinline__ float4 load4(const unsigned char* p) {
  if (KV == BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
  }
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float4(code_at<KV>(u, 0), code_at<KV>(u, 1), code_at<KV>(u, 2), code_at<KV>(u, 3));
}

// ---------------------------------------------------------------------------
// the split body
// ---------------------------------------------------------------------------

// Attention of q (already in s.q) over the split's ntok >= 1 tokens, whose
// cache rows ``rows`` gives. Leaves the split's max and denominator in
// s.m, s.l (G,) and its unnormalised accumulator in s.red[0 : G*d].
template <int KV, typename Rows>
__device__ void attend_split(const Rows& rows, int ntok, const void* __restrict__ k_codes,
                             const float* __restrict__ k_scales,
                             const void* __restrict__ v_codes,
                             const float* __restrict__ v_scales, const Smem& s, int G,
                             int d, int T, float sm_scale) {
  constexpr int EPC = 16 / KvBytes<KV>::value;   // values per 16-byte chunk
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rowbytes = d * KvBytes<KV>::value, chunks = rowbytes / 16;

  // round trip 2: every code and scale of the split's live tokens at once
  const unsigned char* kg = static_cast<const unsigned char*>(k_codes);
  const unsigned char* vg = static_cast<const unsigned char*>(v_codes);
  for (int i = tid; i < ntok * chunks; i += THREADS) {
    const int t = i / chunks, c = i - t * chunks;
    const size_t src = rows(t) * rowbytes + (size_t)c * 16;
    cp_async16(s.k + t * s.rs + c * 16, kg + src);
    cp_async16(s.v + t * s.rs + c * 16, vg + src);
  }
  if (KV != BF16) {
    for (int t = tid; t < ntok; t += THREADS) {
      const size_t r = rows(t);
      cp_async4(s.ks + t, k_scales + r);
      cp_async4(s.vs + t, v_scales + r);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // scores: SUB lanes per (token, query head), one 16-byte chunk each at a
  // time; the loop runs the same trips on every thread (for the shuffles)
  const int pairs = ntok * G;
  for (int base = 0; base < pairs * SUB; base += THREADS) {
    const int i = base + tid, pair = i / SUB, sub = i % SUB;
    float part = 0.f;
    if (pair < pairs) {
      const int t = pair / G, g = pair - t * G;
      const unsigned char* krow = s.k + t * s.rs;
      for (int c = sub; c < chunks; c += SUB)
        part += dot_chunk<KV>(*reinterpret_cast<const uint4*>(krow + c * 16),
                              s.q + g * d + c * EPC);
    }
#pragma unroll
    for (int o = 1; o < SUB; o <<= 1) part += __shfl_xor_sync(FULL, part, o);
    if (pair < pairs && sub == 0) {
      const int t = pair / G, g = pair - t * G;
      const float ks = (KV == BF16) ? 1.f : s.ks[t];
      s.p[g * T + t] = part * ks * sm_scale;
    }
  }
  __syncthreads();

  // the split's softmax: one warp per query head, lanes over tokens
  for (int g = warp; g < G; g += NWARPS) {
    float* pg = s.p + g * T;
    float mx = kNegInf;
    for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, pg[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < ntok; t += 32) {
      const float e = expf(pg[t] - mx);
      pg[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      s.m[g] = mx;
      s.l[g] = sum;
    }
  }
  __syncthreads();

  // P.V: threads over (query head, 4 columns) and token slices
  const int cols4 = G * d / 4, nsl = pv_slices(G, d), gd = G * d;
  for (int i = tid; i < nsl * cols4; i += THREADS) {
    const int sl = i / cols4, c4 = i - sl * cols4;
    const int g = (4 * c4) / d, col = 4 * c4 - g * d;
    const float* pg = s.p + g * T;
    const unsigned char* vcol = s.v + col * KvBytes<KV>::value;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = sl; t < ntok; t += nsl) {
      const float w = (KV == BF16) ? pg[t] : pg[t] * s.vs[t];
      const float4 v = load4<KV>(vcol + t * s.rs);
      a.x = fmaf(w, v.x, a.x);
      a.y = fmaf(w, v.y, a.y);
      a.z = fmaf(w, v.z, a.z);
      a.w = fmaf(w, v.w, a.w);
    }
    *reinterpret_cast<float4*>(s.red + sl * gd + 4 * c4) = a;
  }
  __syncthreads();
  if (nsl > 1) {
    for (int i = tid; i < gd; i += THREADS) {
      float a = s.red[i];
      for (int sl = 1; sl < nsl; ++sl) a += s.red[sl * gd + i];
      s.red[i] = a;
    }
    __syncthreads();
  }
}

// Write out (G, d) for one (row, kv head): directly when the row has one
// live split; else through the workspace, the last split to finish
// merging all live splits in split order.
template <typename OT>
__device__ void finish_split(const Smem& s, int z, int live, int G, int d,
                             OT* __restrict__ out, float* __restrict__ ws, int* counter) {
  const int tid = threadIdx.x, gd = G * d;
  if (live == 1) {
    for (int i = tid; i < gd; i += THREADS)
      store(out + i, s.red[i] / fmaxf(s.l[i / d], 1e-30f));
    return;
  }
  const int stride = gd + 2 * G;       // one split's partials: m (G), l (G), acc (G, d)
  float* mine = ws + (size_t)z * stride;
  for (int g = tid; g < G; g += THREADS) {
    mine[g] = s.m[g];
    mine[G + g] = s.l[g];
  }
  for (int i = tid; i < gd; i += THREADS) mine[2 * G + i] = s.red[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) *s.flag = atomicAdd(counter, 1) == live - 1;
  __syncthreads();
  if (!*s.flag) return;
  __threadfence();
  // one pass over the splits in order (an online merge), so that the
  // loads of several splits are in flight together
  for (int i = tid; i < gd; i += THREADS) {
    const int g = i / d;
    float mx = kNegInf, den = 0.f, acc = 0.f;
#pragma unroll 4
    for (int zz = 0; zz < live; ++zz) {
      const float* part = ws + (size_t)zz * stride;
      const float m = __ldcg(part + g), l = __ldcg(part + G + g);
      const float a = __ldcg(part + 2 * G + i);
      const float mn = fmaxf(mx, m);
      const float keep = expf(mx - mn), w = expf(m - mn);
      den = fmaf(den, keep, l * w);
      acc = fmaf(acc, keep, a * w);
      mx = mn;
    }
    store(out + i, acc / fmaxf(den, 1e-30f));
  }
  if (tid == 0) *counter = 0;
}

}  // namespace
