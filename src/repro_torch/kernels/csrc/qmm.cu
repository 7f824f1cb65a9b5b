// Fused dequant-matmul for Hopper: y (M,N) = x (M,K) @ dequant(codes, scales).
//
// Replaces the TPU kernel kernels/qmm.py::qmm_kernel_call (body _qmm_kernel,
// dequant _dequant_tile) of the JAX package.
//
// Arithmetic (as the TPU kernel): each weight code is decoded (int4 two's
// complement, fp4/nf4 through a 16-entry codebook, int8, fp8 e4m3),
// multiplied by its f32 block scale in f32 and rounded to bf16; x is
// rounded to bf16; products are summed in f32 and cast to the output type
// once. A product of two bf16 values is exact in f32, so the FMA loop
// below reproduces the TPU's bf16 x bf16 -> f32 dot up to summation order.
//
// What bounds it on the H100: at decode (M = slots, a handful of rows)
// the kernel reads K*N/2 bytes of packed codes plus K/sub_block*N*4 bytes
// of scales and does 2*M*K*N operations, far below the ~295 operations per
// byte where bf16 tensor cores take over: it is bound by the bytes of the
// weights. At prefill (M = hundreds of rows) it does more operations than
// bytes allow and is bound by arithmetic.
//
// What the design does about it: each block owns a BM x BN output tile and
// walks K in BK slabs; every weight slab is read from device memory and
// dequantized into shared memory once per M-tile, so at decode (one
// M-tile) each code byte crosses the memory bus once. Loads are coalesced
// along N. The ragged M, N and K edges are masked in the kernel, so no
// caller pads. This first version multiplies with CUDA-core FMAs; wgmma
// fed by TMA, split-K for the few-column decode shapes and a persistent
// schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = BM * BN / THREADS;  // 8
static_assert(THREADS % BN == 0, "a thread row group spans BN columns");

enum Fmt { INT4 = 0, FP4 = 1, NF4 = 2, INT8 = 3, FP8 = 4 };

// fp4 (E2M1) and nf4 codebooks, uploaded once from the Python side
// (core/formats.py holds the single copy of the tables)
__constant__ float kCodebook[2][16];

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int FMT>
__device__ __forceinline__ float decode(const uint8_t* __restrict__ codes,
                                        int k, int n, int N) {
  if (FMT == INT4 || FMT == FP4 || FMT == NF4) {
    // packed (K/2, N): the low nibble holds the even k
    const uint8_t b = codes[(size_t)(k >> 1) * N + n];
    const int nib = (k & 1) ? (b >> 4) : (b & 0xF);
    if (FMT == INT4) return (float)((nib ^ 8) - 8);
    return kCodebook[FMT == FP4 ? 0 : 1][nib];
  } else if (FMT == INT8) {
    return (float)reinterpret_cast<const int8_t*>(codes)[(size_t)k * N + n];
  } else {
    __nv_fp8_e4m3 v;
    v.__x = codes[(size_t)k * N + n];
    return float(v);
  }
}

template <int FMT, typename XT, typename OT>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, OT* __restrict__ out,
           int M, int N, int K, int sub_block) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int row0 = (tid / BN) * ROWS_PER_THREAD;

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? round_bf16(to_float(x[(size_t)m * K + k])) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      float w = 0.f;
      if (k < K && n < N)
        w = round_bf16(decode<FMT>(codes, k, n, N) *
                       scales[(size_t)(k / sub_block) * N + n]);
      ws[r][c] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float w = ws[kk][col];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] = fmaf(xs[row0 + j][kk], w, acc[j]);
    }
    __syncthreads();
  }

  const int n = n0 + col;
  if (n >= N) return;
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int m = m0 + row0 + j;
    if (m < M) store(out + (size_t)m * N + n, acc[j]);
  }
}

template <int FMT, typename XT, typename OT>
void launch(const void* x, const void* codes, const float* scales, void* out,
            int M, int N, int K, int sub_block, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<FMT, XT, OT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes), scales,
      static_cast<OT*>(out), M, N, K, sub_block);
}

template <int FMT>
void launch_fmt(const void* x, int x_bf16, const void* codes,
                const float* scales, void* out, int out_bf16, int M, int N,
                int K, int sub_block, cudaStream_t s) {
  if (x_bf16 && out_bf16)
    launch<FMT, __nv_bfloat16, __nv_bfloat16>(x, codes, scales, out, M, N, K, sub_block, s);
  else if (x_bf16)
    launch<FMT, __nv_bfloat16, float>(x, codes, scales, out, M, N, K, sub_block, s);
  else if (out_bf16)
    launch<FMT, float, __nv_bfloat16>(x, codes, scales, out, M, N, K, sub_block, s);
  else
    launch<FMT, float, float>(x, codes, scales, out, M, N, K, sub_block, s);
}

}  // namespace

extern "C" int qmm_set_codebooks(const float* host_tables) {
  cudaError_t err = cudaMemcpyToSymbol(kCodebook, host_tables, sizeof(float) * 32);
  return (int)err;
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int qmm_launch(const void* x, int x_bf16, const void* codes,
                          const float* scales, void* out, int out_bf16, int M,
                          int N, int K, int sub_block, int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case INT4: launch_fmt<INT4>(x, x_bf16, codes, scales, out, out_bf16, M, N, K, sub_block, s); break;
    case FP4: launch_fmt<FP4>(x, x_bf16, codes, scales, out, out_bf16, M, N, K, sub_block, s); break;
    case NF4: launch_fmt<NF4>(x, x_bf16, codes, scales, out, out_bf16, M, N, K, sub_block, s); break;
    case INT8: launch_fmt<INT8>(x, x_bf16, codes, scales, out, out_bf16, M, N, K, sub_block, s); break;
    case FP8: launch_fmt<FP8>(x, x_bf16, codes, scales, out, out_bf16, M, N, K, sub_block, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
