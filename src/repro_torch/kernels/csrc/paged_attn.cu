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
// The split body (attend_split) and the merge (finish_split) live in
// attend_split.cuh, shared with decode_attn.cu; they take the token ->
// cache-row map as a parameter (PagedRows here, DenseRows there).

#include "attend_split.cuh"

namespace {

// Where token t of the split lives in the pool: row (page * ps + slot) * Hkv
// + h of the (P*ps*Hkv, d) view, the pages read from shared memory.
struct PagedRows {
  const int* pages;
  int ps, Hkv, h;
  __device__ __forceinline__ size_t operator()(int t) const {
    return ((size_t)pages[t / ps] * ps + t % ps) * Hkv + h;
  }
};

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
