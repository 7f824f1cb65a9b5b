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
// k = code * scale; an online softmax over the row in f32; positions at
// or past lengths[b] take no part; the final denominator is clamped at
// 1e-30, so a row of length 0 returns exact zeros.
//
// What bounds it on the H100: each valid K/V byte is read once and used
// for 2*G*d operations per token, so the kernel is bound by the bytes of
// the cache it reads (and, at serving sizes of a few hundred tokens, by
// launch latency).
//
// What the design does about it: one block per (row, kv head) walks
// min(lengths[b], S) tokens in tiles of TILE inside a loop — the sequence
// axis that the TPU kernel put on a sequential grid dimension — and reads
// the cache in place: no per-call transpose to (B, Hkv, S, d), no padding
// of G to 8, no 128-wide sequence tile (all three were TPU artifacts of
// the reference wrapper). Tokens past lengths[b] are never read, so their
// probability is exactly zero. The G query heads of a kv head share each
// K/V load.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 64;         // tokens per tile (kernels/decode_attn.py)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, typename OT>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k_codes,
                   const float* __restrict__ k_scales,
                   const int8_t* __restrict__ v_codes,
                   const float* __restrict__ v_scales,
                   const int* __restrict__ lengths, OT* __restrict__ out,
                   int S, int Hkv, int G, int d, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                // (G, d)
  float* acc = qs + G * d;         // (G, d)
  float* prob = acc + G * d;       // (G, TILE): scores, then probabilities
  float* m_run = prob + G * TILE;  // (G,)
  float* l_run = m_run + G;        // (G,)
  float* alpha = l_run + G;        // (G,)

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = THREADS / 32;
  const int len = min(max(lengths[b], 0), S);
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

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int nvalid = min(TILE, len - t0);

    // scores of the tile's valid tokens: one warp per token
    for (int t = warp; t < nvalid; t += nwarps) {
      const size_t row = ((size_t)b * S + t0 + t) * Hkv + h;
      const float ks = k_scales[row];
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int i = lane; i < d; i += 32)
          part += qs[g * d + i] * ((float)k_codes[row * d + i] * ks);
        part = warp_sum(part);
        if (lane == 0) prob[g * TILE + t] = part * sm_scale;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per query head
    for (int g = tid; g < G; g += THREADS) {
      const float m_old = m_run[g];
      float m_new = m_old;
      for (int t = 0; t < nvalid; ++t) m_new = fmaxf(m_new, prob[g * TILE + t]);
      float s = 0.f;
      for (int t = 0; t < nvalid; ++t) {
        const float e = expf(prob[g * TILE + t] - m_new);
        prob[g * TILE + t] = e;
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
        const size_t row = ((size_t)b * S + t0 + t) * Hkv + h;
        dot += prob[g * TILE + t] * ((float)v_codes[row * d + c] * v_scales[row]);
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

template <typename QT, typename OT>
void launch(const void* q, const int8_t* kc, const float* ks, const int8_t* vc,
            const float* vs, const int* lengths, void* out, int B, int S,
            int Hkv, int G, int d, float sm_scale, size_t smem,
            cudaStream_t stream) {
  dim3 grid(B, Hkv);
  decode_attn_kernel<QT, OT><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), kc, ks, vc, vs, lengths,
      static_cast<OT*>(out), S, Hkv, G, d, sm_scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attn_launch(const void* q, int q_bf16, const void* k_codes,
                                  const float* k_scales, const void* v_codes,
                                  const float* v_scales, const int* lengths,
                                  void* out, int out_bf16, int B, int S, int Hkv,
                                  int G, int d, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)2 * G * d + (size_t)G * TILE + 3 * G);
  const int8_t* kc = static_cast<const int8_t*>(k_codes);
  const int8_t* vc = static_cast<const int8_t*>(v_codes);
  if (q_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(q, kc, k_scales, vc, v_scales, lengths, out, B, S, Hkv, G, d, sm_scale, smem, s);
  else if (q_bf16)
    launch<__nv_bfloat16, float>(q, kc, k_scales, vc, v_scales, lengths, out, B, S, Hkv, G, d, sm_scale, smem, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(q, kc, k_scales, vc, v_scales, lengths, out, B, S, Hkv, G, d, sm_scale, smem, s);
  else
    launch<float, float>(q, kc, k_scales, vc, v_scales, lengths, out, B, S, Hkv, G, d, sm_scale, smem, s);
  return (int)cudaGetLastError();
}
