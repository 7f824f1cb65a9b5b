// Single-query GQA flash-decode over a block-paged KV pool, for Hopper.
//
// Replaces the TPU kernel kernels/paged_attn.py::paged_attn_call (body
// _kernel) of the JAX package.
//
// Inputs: q (B, Hkv, G, d); pages in their native pool layout
// (P, ps, Hkv, d) as int8 or fp8-e4m3 codes with (P, ps, Hkv) f32 scales,
// or bf16 with no scales; block_tables (B, maxp) int32; lengths (B,) int32.
// Token t of row b lives at (block_tables[b, t / ps], t % ps).
//
// Semantics (as the TPU kernel): scores = (q . k) * sm_scale in f32 with
// k = code * scale; a softmax over the chain in f32; positions at or past
// lengths[b] take no part; the final denominator is clamped at 1e-30, so
// a row of length 0 returns zeros.
//
// What bounds it on the H100: every K/V byte of the live chains is read
// once and used for 2*G*d operations per token, so past a few thousand
// tokens a row the kernel is bound by the bytes of the pool it reads. At
// serving lengths (tens to hundreds of tokens) the bytes take well under a
// microsecond; what costs is latency: the launch, and every dependent
// round trip to device memory (the length, the block-table entries, the
// pages). A block that walks a chain page after page pays one round trip
// per page, and (B, Hkv) blocks leave most of the 132 SMs idle.
//
// What the design does about it: the grid is (B, Hkv, splits) (the plan,
// kernels/paged_attn.py::paged_attn_plan, is chosen on the host from
// shapes only). Split z takes the chain's tokens [z*T, (z+1)*T), T a whole
// number of pages sized so that the split's K, V and scales fit shared
// memory at once. A block makes two round trips before it computes:
//   1. the length, its split's block-table entries and q, all at once;
//   2. every K/V code and scale of its live tokens, issued as 16-byte
//      (scales 4-byte) cp.async copies into shared memory, then one wait.
// Splits that start at or past lengths[b] return at once; tokens at or
// past the length are never read, so their probability is exactly zero
// and a poisoned trash page cannot change one output bit. Within a split:
// scores by threads over (token, query head), 4 lanes each, from shared
// memory; max and sum by warp shuffles, one warp per query head; P.V by
// threads over (query head, 4 columns) and token slices, the slices
// summed in a fixed order. A row whose live tokens fit one split writes
// out directly. Otherwise each live split writes f32 partials (max,
// denominator, the (G, d) accumulator) to a workspace; the last block of
// the (row, kv head) to finish (a per-(b, h) counter after __threadfence)
// merges the live splits in split order (one online pass, the loads of
// several splits in flight at once), writes out and puts the counter
// back to 0. One launch a call; reruns are bit-identical.
//
// The split body (attend_split) takes the token -> cache-row map as a
// parameter (PagedRows here): a dense (B, S, Hkv, d) cache is the map
// row(t) = (b*S + z*T + t)*Hkv + h, with the same loads, math and merge.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
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
// shared-memory layout of one block (mirrored by paged_attn.py::_smem_bytes)
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

// Where token t of the split lives in the pool: row (page * ps + slot) * Hkv
// + h of the (P*ps*Hkv, d) view, the pages read from shared memory.
struct PagedRows {
  const int* pages;
  int ps, Hkv, h;
  __device__ __forceinline__ size_t operator()(int t) const {
    return ((size_t)pages[t / ps] * ps + t % ps) * Hkv + h;
  }
};

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

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k_pages;
  const float* k_scales;
  const void* v_pages;
  const float* v_scales;
  const int* tables;
  const int* lengths;
  void* out;
  float* ws;          // (B, Hkv, splits, 2G + G*d) f32 partials (splits > 1)
  int* counters;      // (B, Hkv) int32, all 0 between launches (splits > 1)
  int Hkv, G, d, ps, maxp, pps, splits;
  float sm_scale;
};

template <int KV, typename QT, typename OT>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = a.pps * a.ps;
  const Smem s(smem_raw, make_layout(T, a.G, a.d, KvBytes<KV>::value, a.pps));
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z, tid = threadIdx.x;
  const int gd = a.G * a.d;
  const size_t bh = (size_t)b * a.Hkv + h;
  OT* out = static_cast<OT*>(a.out) + bh * gd;

  // round trip 1: the length, the split's block-table entries (cp.async)
  // and q, all in flight together
  const int raw_len = a.lengths[b];
  const int first_page = z * a.pps;
  const int npg = min(a.pps, a.maxp - first_page);
  for (int i = tid; i < npg; i += THREADS)
    cp_async4(s.pages + i, a.tables + (size_t)b * a.maxp + first_page + i);
  const QT* q = static_cast<const QT*>(a.q) + bh * gd;
  for (int i = tid; i < gd; i += THREADS) s.q[i] = to_float(q[i]);
  cp_async_wait_all();
  const int len = min(max(raw_len, 0), a.maxp * a.ps);
  const int live = (len + T - 1) / T;
  if (live == 0) {                     // an idle row: zeros, from split 0
    if (z == 0)
      for (int i = tid; i < gd; i += THREADS) store(out + i, 0.f);
    return;
  }
  if (z >= live) return;               // wholly past the length
  __syncthreads();

  const int ntok = min(T, len - z * T);
  const PagedRows rows{s.pages, a.ps, a.Hkv, h};
  attend_split<KV>(rows, ntok, a.k_pages, a.k_scales, a.v_pages, a.v_scales, s, a.G, a.d,
                   T, a.sm_scale);
  finish_split(s, z, live, a.G, a.d, out,
               a.ws + bh * a.splits * (size_t)(gd + 2 * a.G), a.counters + bh);
}

template <int KV, typename QT, typename OT>
int launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  dim3 grid(B, a.Hkv, a.splits);
  paged_attn_kernel<KV, QT, OT><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KV>
int launch_kv(const Args& a, int q_bf16, int out_bf16, int B, size_t smem, cudaStream_t s) {
  if (q_bf16 && out_bf16) return launch<KV, __nv_bfloat16, __nv_bfloat16>(a, B, smem, s);
  if (q_bf16) return launch<KV, __nv_bfloat16, float>(a, B, smem, s);
  if (out_bf16) return launch<KV, float, __nv_bfloat16>(a, B, smem, s);
  return launch<KV, float, float>(a, B, smem, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The grid is
// (B, Hkv, splits); each split takes pages_per_split pages of the chain.
// With splits > 1, workspace holds B*Hkv*splits*(2G + G*d) f32 and
// counters B*Hkv int32 that are 0 (each launch leaves them 0).
extern "C" int paged_attn_launch(const void* q, int q_bf16, const void* k_pages,
                                 const float* k_scales, const void* v_pages,
                                 const float* v_scales, const int* block_tables,
                                 const int* lengths, void* out, int out_bf16,
                                 int B, int Hkv, int G, int d, int ps, int maxp,
                                 int kv_kind, float sm_scale, int pages_per_split,
                                 int splits, float* workspace, int* counters,
                                 void* stream) {
  if (kv_kind < BF16 || kv_kind > FP8 || pages_per_split < 1 || splits < 1 ||
      (long long)pages_per_split * splits < maxp || (d * (kv_kind == BF16 ? 2 : 1)) % 16 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(pages_per_split * ps, G, d, kv_kind == BF16 ? 2 : 1,
                                  pages_per_split).total;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, k_scales, v_pages, v_scales, block_tables, lengths, out,
               workspace, counters, Hkv, G, d, ps, maxp, pages_per_split, splits, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case BF16: return launch_kv<BF16>(a, q_bf16, out_bf16, B, smem, s);
    case INT8: return launch_kv<INT8>(a, q_bf16, out_bf16, B, smem, s);
    default: return launch_kv<FP8>(a, q_bf16, out_bf16, B, smem, s);
  }
}
