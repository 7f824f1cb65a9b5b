// Single-query GQA flash-decode over a dense int8 KV cache, for Hopper.
//
// Replaces the TPU kernel kernels/decode_attn.py::decode_attn_call (body
// _kernel) of the JAX package.
//
// Inputs, in the dense serving cache's native layout: q (B, Hkv, G, d)
// f32 or bf16; codes (B, S, Hkv, d) int8 with (B, S, Hkv) f32 scales;
// lengths (B,) int32. Output (B, Hkv, G, d) f32 or bf16.
//
// Semantics (as the TPU kernel): scores = (q . k) * sm_scale in f32 with
// k = code * scale; a softmax over the row in f32; positions at or past
// lengths[b] take no part; the final denominator is clamped at 1e-30, so
// a row of length 0 returns exact zeros.
//
// What bounds it on the H100: each valid K/V byte is read once and used
// for 2*G*d operations per token, so past a few thousand tokens a row the
// kernel is bound by the bytes of the cache it reads. At serving lengths
// (tens to hundreds of tokens) the bytes take well under a microsecond;
// what costs is latency: the launch and every dependent round trip to
// device memory. One block per (row, kv head) walking its row tile after
// tile pays a round trip per tile and leaves most of the 132 SMs idle.
//
// What the design does about it: the split-and-merge body of the paged
// kernel (attend_split.cuh) over the map DenseRows, row(t) = (b*S + z*T +
// t)*Hkv + h of the cache's (B*S*Hkv, d) view: nothing is transposed or
// padded. The grid is (B, Hkv, splits); split z takes the row's tokens
// [z*T, (z+1)*T), T chosen on the host from shapes only
// (kernels/decode_attn.py::decode_attn_plan) so that the split's K, V and
// scales fit shared memory at once and the grid reaches two blocks per
// SM where S allows. A block makes two round trips before it computes:
//   1. the length and q, together;
//   2. every code and scale of its live tokens, as 16-byte (scales
//      4-byte) cp.async copies into shared memory, then one wait.
// A split that starts at or past lengths[b] returns at once (an idle row
// gets zeros from split 0); tokens at or past the length are never read.
// A row with one live split writes out directly; otherwise the last block
// of the (row, kv head) to finish merges the live splits in split order
// (finish_split). One launch a call; reruns are bit-identical.

#include "attend_split.cuh"

namespace {

// Where token t of split z of row b lives: row (b*S + z*T + t)*Hkv + h of
// the (B*S*Hkv, d) view of the codes, and of the (B*S*Hkv,) view of the
// scales.
struct DenseRows {
  size_t first;       // the row of the split's token 0
  int Hkv;
  __device__ __forceinline__ size_t operator()(int t) const {
    return first + (size_t)t * Hkv;
  }
};

struct Args {
  const void* q;
  const int8_t* k_codes;
  const float* k_scales;
  const int8_t* v_codes;
  const float* v_scales;
  const int* lengths;
  void* out;
  float* ws;          // (B, Hkv, splits, 2G + G*d) f32 partials (splits > 1)
  int* counters;      // (B, Hkv) int32, all 0 between launches (splits > 1)
  int S, Hkv, G, d, T, splits;
  float sm_scale;
};

template <typename QT, typename OT>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s(smem_raw, make_layout(a.T, a.G, a.d, 1, 0));
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z, tid = threadIdx.x;
  const int gd = a.G * a.d;
  const size_t bh = (size_t)b * a.Hkv + h;
  OT* out = static_cast<OT*>(a.out) + bh * gd;

  // round trip 1: the length and q, in flight together
  const int raw_len = a.lengths[b];
  const QT* q = static_cast<const QT*>(a.q) + bh * gd;
  for (int i = tid; i < gd; i += THREADS) s.q[i] = to_float(q[i]);
  const int len = min(max(raw_len, 0), a.S);
  const int live = (len + a.T - 1) / a.T;
  if (live == 0) {                     // an idle row: zeros, from split 0
    if (z == 0)
      for (int i = tid; i < gd; i += THREADS) store(out + i, 0.f);
    return;
  }
  if (z >= live) return;               // wholly past the length
  __syncthreads();

  const int ntok = min(a.T, len - z * a.T);
  const DenseRows rows{((size_t)b * a.S + (size_t)z * a.T) * a.Hkv + h, a.Hkv};
  attend_split<INT8>(rows, ntok, a.k_codes, a.k_scales, a.v_codes, a.v_scales, s, a.G,
                     a.d, a.T, a.sm_scale);
  finish_split(s, z, live, a.G, a.d, out,
               a.ws + bh * a.splits * (size_t)(gd + 2 * a.G), a.counters + bh);
}

template <typename QT, typename OT>
int launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  decode_attn_kernel<QT, OT><<<dim3(B, a.Hkv, a.splits), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The grid is
// (B, Hkv, splits); split z takes the row's tokens [z*T, (z+1)*T) with T =
// tokens_per_split. With splits > 1, workspace holds B*Hkv*splits*(2G +
// G*d) f32 and counters B*Hkv int32 that are 0 (each launch leaves them 0).
extern "C" int decode_attn_launch(const void* q, int q_bf16, const void* k_codes,
                                  const float* k_scales, const void* v_codes,
                                  const float* v_scales, const int* lengths,
                                  void* out, int out_bf16, int B, int S, int Hkv,
                                  int G, int d, float sm_scale, int tokens_per_split,
                                  int splits, float* workspace, int* counters,
                                  void* stream) {
  if (tokens_per_split < 1 || splits < 1 || splits > 65535 ||
      (long long)tokens_per_split * splits < S || d % 16 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(tokens_per_split, G, d, 1, 0).total;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const Args a{q, static_cast<const int8_t*>(k_codes), k_scales,
               static_cast<const int8_t*>(v_codes), v_scales, lengths, out, workspace,
               counters, S, Hkv, G, d, tokens_per_split, splits, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, B, smem, s);
  if (q_bf16) return launch<__nv_bfloat16, float>(a, B, smem, s);
  if (out_bf16) return launch<float, __nv_bfloat16>(a, B, smem, s);
  return launch<float, float>(a, B, smem, s);
}
