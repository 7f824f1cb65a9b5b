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
// k = code * scale; an online softmax over the chain in f32; positions at
// or past lengths[b] take no part; the final denominator is clamped at
// 1e-30, so a row of length 0 returns zeros.
//
// What bounds it on the H100: every K/V byte of the live chains is read
// once and used for 2*G*d operations per token, so the kernel is bound by
// the bytes of the pool it reads (and, at serving sizes of a few hundred
// tokens, by launch latency).
//
// What the design does about it: one block per (row, kv head) walks its
// own block-table row inside a loop — the page walk that the TPU kernel
// put on a sequential grid axis — and reads pages in place, with no
// transposed or gathered copy of the pool. Pages past lengths[b] are never
// read and invalid tokens of the last page are skipped, so their
// probability is exactly zero and a poisoned trash page cannot change one
// output bit. The G query heads of a kv head share each K/V load.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float kNegInf = -1e30f;

enum Kv { BF16 = 0, INT8 = 1, FP8 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int KV>
__device__ __forceinline__ float load_kv(const void* __restrict__ pool, size_t i) {
  if (KV == BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[i]);
  if (KV == INT8) return (float)static_cast<const int8_t*>(pool)[i];
  __nv_fp8_e4m3 v;
  v.__x = static_cast<const uint8_t*>(pool)[i];
  return float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KV, typename QT, typename OT>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const QT* __restrict__ q, const void* __restrict__ k_pages,
                  const float* __restrict__ k_scales,
                  const void* __restrict__ v_pages,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ lengths, OT* __restrict__ out,
                  int Hkv, int G, int d, int ps, int maxp, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // (G, d)
  float* acc = qs + G * d;       // (G, d)
  float* prob = acc + G * d;     // (G, ps): scores, then probabilities
  float* m_run = prob + G * ps;  // (G,)
  float* l_run = m_run + G;      // (G,)
  float* alpha = l_run + G;      // (G,)

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = THREADS / 32;
  const int len = lengths[b];
  const size_t qbase = ((size_t)b * Hkv + h) * G * d;

  for (int i = tid; i < G * d; i += THREADS) {
    qs[i] = to_float(q[qbase + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }
  __syncthreads();

  const int npages = min(maxp, (len + ps - 1) / ps);
  for (int p = 0; p < npages; ++p) {
    const int page = block_tables[(size_t)b * maxp + p];
    const int nvalid = min(ps, len - p * ps);

    // scores of the page's valid tokens: one warp per token
    for (int t = warp; t < nvalid; t += nwarps) {
      const size_t row = ((size_t)page * ps + t) * Hkv + h;
      const float ks = (KV == BF16) ? 1.f : k_scales[row];
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int i = lane; i < d; i += 32)
          part += qs[g * d + i] * (load_kv<KV>(k_pages, row * d + i) * ks);
        part = warp_sum(part);
        if (lane == 0) prob[g * ps + t] = part * sm_scale;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per query head
    for (int g = tid; g < G; g += THREADS) {
      const float m_old = m_run[g];
      float m_new = m_old;
      for (int t = 0; t < nvalid; ++t) m_new = fmaxf(m_new, prob[g * ps + t]);
      float s = 0.f;
      for (int t = 0; t < nvalid; ++t) {
        const float e = expf(prob[g * ps + t] - m_new);
        prob[g * ps + t] = e;
        s += e;
      }
      const float a = expf(m_old - m_new);
      alpha[g] = a;
      l_run[g] = l_run[g] * a + s;
      m_run[g] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + prob @ v over the valid tokens only
    for (int i = tid; i < G * d; i += THREADS) {
      const int g = i / d, c = i % d;
      float dot = 0.f;
      for (int t = 0; t < nvalid; ++t) {
        const size_t row = ((size_t)page * ps + t) * Hkv + h;
        const float vs = (KV == BF16) ? 1.f : v_scales[row];
        dot += prob[g * ps + t] * (load_kv<KV>(v_pages, row * d + c) * vs);
      }
      acc[i] = acc[i] * alpha[g] + dot;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * d; i += THREADS) {
    const float den = fmaxf(l_run[i / d], 1e-30f);
    store(out + qbase + i, acc[i] / den);
  }
}

template <int KV, typename QT, typename OT>
void launch(const void* q, const void* kp, const float* ks, const void* vp,
            const float* vs, const int* tables, const int* lengths, void* out,
            int B, int Hkv, int G, int d, int ps, int maxp, float sm_scale,
            size_t smem, cudaStream_t stream) {
  dim3 grid(B, Hkv);
  paged_attn_kernel<KV, QT, OT><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), kp, ks, vp, vs, tables, lengths,
      static_cast<OT*>(out), Hkv, G, d, ps, maxp, sm_scale);
}

template <int KV>
void launch_kv(const void* q, int q_bf16, const void* kp, const float* ks,
               const void* vp, const float* vs, const int* tables,
               const int* lengths, void* out, int out_bf16, int B, int Hkv,
               int G, int d, int ps, int maxp, float sm_scale, size_t smem,
               cudaStream_t s) {
  if (q_bf16 && out_bf16)
    launch<KV, __nv_bfloat16, __nv_bfloat16>(q, kp, ks, vp, vs, tables, lengths, out, B, Hkv, G, d, ps, maxp, sm_scale, smem, s);
  else if (q_bf16)
    launch<KV, __nv_bfloat16, float>(q, kp, ks, vp, vs, tables, lengths, out, B, Hkv, G, d, ps, maxp, sm_scale, smem, s);
  else if (out_bf16)
    launch<KV, float, __nv_bfloat16>(q, kp, ks, vp, vs, tables, lengths, out, B, Hkv, G, d, ps, maxp, sm_scale, smem, s);
  else
    launch<KV, float, float>(q, kp, ks, vp, vs, tables, lengths, out, B, Hkv, G, d, ps, maxp, sm_scale, smem, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attn_launch(const void* q, int q_bf16, const void* k_pages,
                                 const float* k_scales, const void* v_pages,
                                 const float* v_scales, const int* block_tables,
                                 const int* lengths, void* out, int out_bf16,
                                 int B, int Hkv, int G, int d, int ps, int maxp,
                                 int kv_kind, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)2 * G * d + (size_t)G * ps + 3 * G);
  switch (kv_kind) {
    case BF16: launch_kv<BF16>(q, q_bf16, k_pages, k_scales, v_pages, v_scales, block_tables, lengths, out, out_bf16, B, Hkv, G, d, ps, maxp, sm_scale, smem, s); break;
    case INT8: launch_kv<INT8>(q, q_bf16, k_pages, k_scales, v_pages, v_scales, block_tables, lengths, out, out_bf16, B, Hkv, G, d, ps, maxp, sm_scale, smem, s); break;
    case FP8: launch_kv<FP8>(q, q_bf16, k_pages, k_scales, v_pages, v_scales, block_tables, lengths, out, out_bf16, B, Hkv, G, d, ps, maxp, sm_scale, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
