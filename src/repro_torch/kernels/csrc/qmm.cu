// Fused dequant-matmul for Hopper: y (M,N) = x (M,K) @ dequant(codes, scales).
//
// Replaces the TPU kernel kernels/qmm.py::qmm_kernel_call (body _qmm_kernel,
// dequant _dequant_tile) of the JAX package.
//
// Arithmetic (as the TPU kernel): each weight code is decoded (int4 two's
// complement, fp4/nf4 through a 16-entry codebook, int8, fp8 e4m3),
// multiplied by its f32 block scale in f32 and rounded to bf16; x is
// rounded to bf16; the bf16 x bf16 products are summed in f32 and cast to
// the output type once, after the whole K sum.
//
// What bounds it on the H100, by regime (the wrapper picks one from M;
// kernels/qmm.py::qmm_plan holds the tile and split plan):
//
// * decode rows (M <= 16). 2*M*K*N operations on K*N/2 bytes of packed
//   codes (K*N for 8-bit) are a few operations per byte, far below the
//   ~295 per byte where bf16 tensor cores take over: the weight bytes
//   bound it, and at 0.5-4.5 MB a launch, so does latency. One block per
//   output column strip would leave most of the 132 SMs idle, so the
//   plan splits K: block (x, y, z) owns a 64-column strip and the z-th K
//   range (a multiple of the 64-deep slab and of sub_block), with enough
//   splits for two or more blocks per SM.
// * prefill rows (larger M). 2*M*K*N operations outgrow the bytes: the
//   operations bound it, so the product runs on the tensor cores
//   (mma.sync m16n8k16 bf16 -> f32) over 128 x 128 output tiles, and
//   each dequantized code slab serves all 128 rows of its M-tile. Split-K
//   (at most 8 ways) is used here too when the output tiles alone cannot
//   fill the card.
//
// What the design does about it, for both regimes (one kernel template,
// two tile configurations):
//
// * a ring of cp.async stages (16-byte copies, coalesced along N; up to
//   4 stages at decode, 6 at prefill, as many as fit) brings the packed
//   code slab, the slab's scale rows and the live rows of x into shared
//   memory ahead of use, so several slabs are in flight while one is
//   multiplied; rows of x past M are zeroed once and never loaded; ragged
//   M, N and K edges are masked here, so no caller pads (shapes whose rows
//   are not 16-byte aligned take element copies instead); one barrier per
//   slab. Whole slabs (BK deep, inside N, in one scale row) take a path
//   with no bounds checks: one scale load per thread and slab;
// * the weights are dequantized in registers, straight into the mma B
//   fragments: thread (g, t) of a warp owns the NI columns wn0 + NI*g + j
//   of its NI n-tiles (mma column g of n-tile j is that column), so one
//   2- or 4-byte load of a code row gives its bytes for every n-tile;
//   each code is decoded (integer ops, or the fp4/nf4 codebook in
//   shared memory: 16 entries in 16 banks, no divergent constant-cache
//   reads), multiplied by its staged f32 scale and rounded to bf16.
//   No bf16 weight tile is written or read back; code rows are padded
//   so a warp's byte loads of four rows fall in distinct banks;
// * x reaches the MMA as bf16: a bf16 x tile lands by cp.async in a
//   padded, ldmatrix-ready layout; an f32 one is read in pairs and
//   rounded in registers;
// * each 64-deep slab is summed into fresh mma accumulators and then
//   added to the running f32 sums with ordinary f32 adds, so the tensor
//   cores' own accumulation (truncating, not rounding) spans 4 steps and
//   not all of K;
// * split-K partials go to an f32 workspace; the last block of each
//   output tile to arrive (a per-tile counter, put back to 0 by that
//   block) sums them in split order, 16 bytes a load with several splits
//   in flight, casts once and stores. The order is fixed, so reruns are
//   bit-identical; nothing is added atomically into the output, and one
//   launch does the whole call;
// * the FASST activation (paper Figs. 7-8) may ride in the epilogue: with
//   a NAF mode other than identity, each output value is rounded to the
//   output type, taken back to f32, put through naf() and stored, where
//   the final output is stored (the one-split store and the last block's
//   split sum; never the f32 partials). That is the unfused path's
//   qmm -> output type -> NAF in f32 -> output type, with no launch and
//   no pass over the output of its own. The mode is a runtime argument,
//   the same for the whole launch. An identity launch runs an instance
//   compiled without the NAF, any other mode one compiled with it
//   (WithNaf<C>): with one instance for both, the test of the mode cost
//   identity launches 1-2 % (PERF.md).
//
// Measured on the H100 (PERF.md): both regimes spend most of each slab
// issuing its instructions (index arithmetic, dequantization, mma.sync at
// two warps per SM sub-partition), not waiting for memory; wgmma with a
// producer warp is the next step for prefill rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int BK = 64;                    // K depth of one slab
constexpr int SMEM_LIMIT = 232448 - 1024; // dynamic bytes a block may opt into
                                          // (sm_90), less room for static ones
constexpr int MAX_DEVICES = 64;

enum Fmt { INT4 = 0, FP4 = 1, NF4 = 2, INT8 = 3, FP8 = 4 };
enum Regime { DECODE = 0, PREFILL = 1 };

// vec flags: 16-byte copies are legal for this operand
enum Vec { VEC_X = 1, VEC_CODES = 2, VEC_SCALES = 4 };

// BM x BN output tile, WM x WN warps. Decode keeps 4 stages: with more,
// every block asks for its whole K range at once and the first slab
// lands last. NAF: the epilogue applies a NAF mode other than identity.
struct DecodeCfg {   // M <= 16: one 16-row M-tile, 4 warps side by side
  static constexpr int BM = 16, BN = 64, WM = 1, WN = 4, MAX_STAGES = 4;
  static constexpr bool NAF = false;
};
struct PrefillCfg {  // 128 x 128 tiles, 8 warps side by side (128 x 16 each)
  static constexpr int BM = 128, BN = 128, WM = 1, WN = 8, MAX_STAGES = 6;
  static constexpr bool NAF = false;
};
template <class C> struct WithNaf : C {
  static constexpr bool NAF = true;
};
template <class C> constexpr int kThreads = C::WM * C::WN * 32;

// fp4 (E2M1) and nf4 codebooks, uploaded once from the Python side
// (core/formats.py holds the single copy of the tables)
__constant__ float kCodebook[2][16];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false nothing is read and 16 zero bytes
// land in shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, packed low then high (one 32-bit word)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The FASST NAF datapath, f32 in and out, with the formulas of the Triton
// activation kernel (kernels/fasst.py); the modes in kernels/fasst.py::MODES
// order. Not inlined: one copy serves every output value of a kernel
// instance (inlined at each unrolled store of the 40 instances, it
// multiplied their code and their build time).
enum Naf { RELU = 0, SIGMOID = 1, TANH = 2, GELU = 3, SILU = 4, SQUARED_RELU = 5,
           SELU = 6, IDENTITY = 7 };

__device__ __noinline__ float naf(float x, int mode) {
  switch (mode) {
    case RELU: return fmaxf(x, 0.f);
    case SIGMOID: return 1.f / (1.f + expf(-x));
    case TANH: return 2.f / (1.f + expf(-2.f * x)) - 1.f;   // 2 sigmoid(2x) - 1
    case GELU: {                                              // tanh approximation
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (2.f / (1.f + expf(-2.f * u)));
    }
    case SILU: return x / (1.f + expf(-x));
    case SQUARED_RELU: {
      const float r = fmaxf(x, 0.f);
      return r * r;
    }
    case SELU:
      return 1.0507009873554805f * (x > 0.f ? x : 1.6732632423543772f * (expf(x) - 1.f));
    default: return x;
  }
}

// v as the output type holds it, back in f32
__device__ __forceinline__ float rounded(float v, float*) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// the NAF of an output value: rounded to the output type first, as the
// unfused path stores it before its activation reads it
template <typename T>
__device__ __forceinline__ float naf_out(float v, int mode, T* out) {
  return naf(rounded(v, out), mode);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16(a); }
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2(a, b), bf16x2(c, d));
}

// R consecutive values v of one row from column n on: 4 at a time where
// the row length allows 16-byte (f32) / 8-byte (bf16) stores, else one
// by one, columns at or past N left out
template <int R, typename T>
__device__ __forceinline__ void store_run(T* row, int n, int N, const float (&v)[R]) {
  if ((N & 3) == 0 && n + R <= N) {
#pragma unroll
    for (int i = 0; i < R; i += 4) store4(row + n + i, v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (n + i < N) store1(row + n + i, v[i]);
  }
}

// value of code byte b (its nibble h for the packed formats), before the
// scale. The two's-complement codes skip the int -> float conversion (a
// reduced-rate instruction): with u = code + 2^(bits-1), the f32 whose bits
// are 0x4B000000 | u is exactly 2^23 + u, and one add takes 2^23 + 2^(bits-1)
// back off.
template <int FMT>
__device__ __forceinline__ float decode(uint32_t b, int h, const float* table) {
  if (FMT == INT4) {
    const uint32_t u = ((h ? b >> 4 : b) ^ 8u) & 0xFu;
    return __uint_as_float(0x4B000000u | u) - 8388616.f;
  } else if (FMT == FP4 || FMT == NF4) {
    return table[h ? (b >> 4) & 0xF : b & 0xF];
  } else if (FMT == INT8) {
    return __uint_as_float(0x4B000000u | ((b ^ 0x80u) & 0xFFu)) - 8388736.f;
  } else {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b & 0xFF);
    return static_cast<float>(v);
  }
}

// NI consecutive bytes (NI = 2 or 4) of shared memory as one word
template <int NI>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if (NI == 4) return *reinterpret_cast<const uint32_t*>(p);
  return *reinterpret_cast<const uint16_t*>(p);
}

// NI consecutive f32 scales (NI = 2 or 4) of shared memory
template <int NI>
__device__ __forceinline__ void load_scales(float (&sc)[NI], const float* p) {
  if constexpr (NI == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    sc[0] = v.x; sc[1] = v.y; sc[2] = v.z; sc[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    sc[0] = v.x; sc[1] = v.y;
  }
}

// A ring stage is [codes][x][scale rows]; the codebook sits before the
// ring. Rows are padded: code rows by 32 bytes (the byte loads of a
// warp's four k rows then fall 8 banks apart), x rows by 8 elements
// (ldmatrix rows and f32 pairs of eight rows in distinct banks).
template <int FMT, typename XT, class C>
struct Layout {
  static constexpr int PACK = (FMT == INT4 || FMT == FP4 || FMT == NF4) ? 2 : 1;
  static constexpr int CROWS = BK / PACK;              // code rows per slab
  static constexpr int CST = C::BN + 32;               // code row stride (bytes)
  static constexpr int XST = BK + 8;                   // x row stride (elements)
  static constexpr int CODE_BYTES = CROWS * CST;
  static constexpr int X_BYTES = C::BM * XST * static_cast<int>(sizeof(XT));
  static constexpr int FIXED_BYTES = 16 * 4;             // the codebook
  static int stage_bytes(int srows) { return CODE_BYTES + X_BYTES + srows * C::BN * 4; }
};

template <int FMT, typename XT, typename OT, class C>
__global__ void __launch_bounds__(kThreads<C>)
qmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, OT* __restrict__ out,
           float* __restrict__ ws, int* __restrict__ counters,
           int M, int N, int K, int sub_block, int sb_shift, int k_per_split,
           int splits, int stages, int srows, int vec, int naf_mode) {
  using L = Layout<FMT, XT, C>;
  constexpr int BM = C::BM, BN = C::BN, THREADS = kThreads<C>;
  constexpr int PACK = L::PACK, CROWS = L::CROWS, CST = L::CST, XST = L::XST;
  constexpr int WTM = BM / C::WM, WTN = BN / C::WN;   // warp tile
  constexpr int MI = WTM / 16, NI = WTN / 8;          // mma tiles per warp
  static_assert(NI == 2 || NI == 4, "a thread's code bytes are one 2- or 4-byte load");
  constexpr bool X_BF16 = sizeof(XT) == 2;
  constexpr int CCH = BN / 16;                        // 16-byte code chunks per row
  constexpr int XV = 16 / static_cast<int>(sizeof(XT));
  constexpr int XCH = BK / XV;                        // 16-byte x chunks per row
  constexpr int XROW16 = XST * static_cast<int>(sizeof(XT)) / 16;
  constexpr int SCH = BN / 4;                         // 16-byte scale chunks per row

  extern __shared__ __align__(16) uint8_t smem[];
  float* table = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + L::FIXED_BYTES;
  const int stage_bytes = L::CODE_BYTES + L::X_BYTES + srows * BN * 4;
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int live = min(BM, M - m0);                   // rows of x this tile reads
  const int k_begin = z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nslabs = (k_end - k_begin + BK - 1) / BK;
  const int wm0 = (warp / C::WN) * WTM, wn0 = (warp % C::WN) * WTN;

  if (FMT == FP4 || FMT == NF4) {
    if (tid < 16) table[tid] = kCodebook[FMT == FP4 ? 0 : 1][tid];
  }
  // rows of x past M stay zero in every stage: no load writes them
  for (int i = tid; i < stages * (BM - live) * XROW16; i += THREADS) {
    const int st = i / ((BM - live) * XROW16), j = i % ((BM - live) * XROW16);
    reinterpret_cast<uint4*>(ring + st * stage_bytes + L::CODE_BYTES +
                             (live + j / XROW16) * XST * sizeof(XT))[j % XROW16] =
        make_uint4(0, 0, 0, 0);
  }

  // a slab is whole when it is BK deep, the column tile lies inside N and
  // every operand may be copied 16 bytes at a time: its copies need no
  // bounds; the other slabs take the checked path
  const bool whole_cols = n0 + BN <= N && vec == (VEC_X | VEC_CODES | VEC_SCALES);

  // issue the copies of slab `slab` into ring stage `st`
  auto load = [&](int st, int slab) {
    if (slab >= nslabs) return;
    uint8_t* cs = ring + st * stage_bytes;
    XT* xs = reinterpret_cast<XT*>(cs + L::CODE_BYTES);
    float* ss = reinterpret_cast<float*>(cs + L::CODE_BYTES + L::X_BYTES);
    const int k0 = k_begin + slab * BK, kend = min(k0 + BK, k_end);
    if (whole_cols && kend - k0 == BK) {
#pragma unroll
      for (int c = tid; c < CROWS * CCH; c += THREADS)
        cp_async16(cs + (c / CCH) * CST + (c % CCH) * 16,
                   codes + (size_t)(k0 / PACK + c / CCH) * N + n0 + (c % CCH) * 16, true);
      const XT* xrow = x + (size_t)m0 * K + k0;
      for (int c = tid; c < live * XCH; c += THREADS)
        cp_async16(xs + (c / XCH) * XST + (c % XCH) * XV,
                   xrow + (size_t)(c / XCH) * K + (c % XCH) * XV, true);
      const int r_lo = k0 / sub_block, rows = (kend - 1) / sub_block - r_lo + 1;
      for (int c = tid; c < rows * SCH; c += THREADS)
        cp_async16(ss + (c / SCH) * BN + (c % SCH) * 4,
                   scales + (size_t)(r_lo + c / SCH) * N + n0 + (c % SCH) * 4, true);
      return;
    }
    for (int c = tid; c < CROWS * CCH; c += THREADS) {
      const int r = c / CCH, n = n0 + (c % CCH) * 16;
      const int kp = k0 / PACK + r;
      const bool in = kp * PACK < kend && n < N;
      uint8_t* dst = cs + r * CST + (c % CCH) * 16;
      if (vec & VEC_CODES) {
        cp_async16(dst, in ? codes + (size_t)kp * N + n : codes, in);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (in && n + j < N) ? codes[(size_t)kp * N + n + j] : 0;
      }
    }
    for (int c = tid; c < live * XCH; c += THREADS) {
      const int r = c / XCH, kc = (c % XCH) * XV;
      const int m = m0 + r, k = k0 + kc;
      XT* dst = xs + r * XST + kc;
      if (vec & VEC_X) {
        const bool in = k < kend;
        cp_async16(dst, in ? x + (size_t)m * K + k : x, in);
      } else {
#pragma unroll
        for (int j = 0; j < XV; ++j)
          dst[j] = k + j < kend ? x[(size_t)m * K + k + j] : zero<XT>();
      }
    }
    const int r_lo = k0 / sub_block, rows = (kend - 1) / sub_block - r_lo + 1;
    for (int c = tid; c < rows * SCH; c += THREADS) {
      const int j = c / SCH, n = n0 + (c % SCH) * 4;
      float* dst = ss + j * BN + (c % SCH) * 4;
      const float* src = scales + (size_t)(r_lo + j) * N + n;
      if (vec & VEC_SCALES) {
        cp_async16(dst, n < N ? src : scales, n < N);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = n + q < N ? src[q] : 0.f;
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the MMAs of slab i, out of its ring stage. The fast variant is for a
  // whole slab (BK deep) inside one scale row: each thread reads its NI
  // scales once, and no k needs a bounds check
  auto multiply = [&](int i, auto fast) {
    constexpr bool FAST = decltype(fast)::value;
    const uint8_t* cs = ring + (i % stages) * stage_bytes;
    const XT* xs = reinterpret_cast<const XT*>(cs + L::CODE_BYTES);
    const float* ss = reinterpret_cast<const float*>(cs + L::CODE_BYTES + L::X_BYTES);
    const int k0 = k_begin + i * BK, kend = min(k0 + BK, k_end), r_lo = k0 / sub_block;
    float scf[NI];
    if constexpr (FAST) load_scales<NI>(scf, ss + wn0 + NI * g);
    float part[MI][NI][4];
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[a][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A: rows wm0 + a*16 .. +15, k kk .. kk+15, rounded to bf16
      uint32_t af[MI][4];
#pragma unroll
      for (int a = 0; a < MI; ++a) {
        if constexpr (X_BF16) {
          ldmatrix_x4(af[a], xs + (wm0 + a * 16 + (lane & 15)) * XST + kk + (lane >> 4) * 8);
        } else {
          const float* r0 = reinterpret_cast<const float*>(xs) + (wm0 + a * 16 + g) * XST + kk + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(r0);
          const float2 v1 = *reinterpret_cast<const float2*>(r0 + 8 * XST);
          const float2 v2 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 v3 = *reinterpret_cast<const float2*>(r0 + 8 * XST + 8);
          af[a][0] = bf16x2(v0.x, v0.y);
          af[a][1] = bf16x2(v1.x, v1.y);
          af[a][2] = bf16x2(v2.x, v2.y);
          af[a][3] = bf16x2(v3.x, v3.y);
        }
      }
      // B: fragment register h of n-tile j holds k = kk + 8h + 2t and the
      // next k, column wn0 + NI*g + j, dequantized here
      uint32_t bf[NI][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = kk + 8 * h + 2 * t;
        uint32_t lo, hi;                 // code bytes of k and of k + 1
        if (PACK == 2) {
          lo = hi = load_bytes<NI>(cs + (kr / 2) * CST + wn0 + NI * g);
        } else {
          lo = load_bytes<NI>(cs + kr * CST + wn0 + NI * g);
          hi = load_bytes<NI>(cs + (kr + 1) * CST + wn0 + NI * g);
        }
        if constexpr (FAST) {
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            // f32 dequantize, then one rounding to bf16 (the TPU kernel's order)
            bf[j][h] = bf16x2(decode<FMT>(lo >> (8 * j), 0, table) * scf[j],
                              decode<FMT>(hi >> (8 * j), PACK == 2 ? 1 : 0, table) * scf[j]);
          }
        } else {
          const int k = k0 + kr;
          const bool in0 = k < kend, in1 = k + 1 < kend;
          // k is even: with an even sub_block, k and k + 1 share a scale row
          float sc0[NI], sc1[NI];
          const int row0 = sb_shift >= 0 ? k >> sb_shift : k / sub_block;
          load_scales<NI>(sc0, ss + (in0 ? row0 - r_lo : 0) * BN + wn0 + NI * g);
          if (sub_block & 1) {
            load_scales<NI>(sc1, ss + (in1 ? (k + 1) / sub_block - r_lo : 0) * BN + wn0 + NI * g);
          } else {
#pragma unroll
            for (int j = 0; j < NI; ++j) sc1[j] = sc0[j];
          }
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            // f32 dequantize, then one rounding to bf16 (the TPU kernel's order)
            const float w0 = decode<FMT>(lo >> (8 * j), 0, table) * sc0[j];
            const float w1 = decode<FMT>(hi >> (8 * j), PACK == 2 ? 1 : 0, table) * sc1[j];
            bf[j][h] = bf16x2(in0 ? w0 : 0.f, in1 ? w1 : 0.f);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(part[a][j], af[a], bf[j][0], bf[j][1]);
    }
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][j][e] += part[a][j][e];
  };

  // slab s's copies are committed as group s (groups past the last slab
  // are empty). At the top of iteration i slab i has landed; after the
  // barrier every warp is done with slab i-1, whose stage takes the
  // copies of slab i+stages-1 while slab i is multiplied.
  for (int s = 0; s < stages - 1; ++s) {
    load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nslabs; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();
    load((i + stages - 1) % stages, i + stages - 1);
    cp_async_commit();
    {
      const int k0 = k_begin + i * BK;
      if (k0 + BK <= k_end && k0 / sub_block == (k0 + BK - 1) / sub_block)
        multiply(i, std::true_type{});
      else
        multiply(i, std::false_type{});
    }
  }
  cp_async_wait(0);

  // accumulator element (a, j, e): row g (+8 for e >= 2) of m-tile a,
  // mma column 2t + (e & 1) of n-tile j, that is column
  // wn0 + NI * (2t + (e & 1)) + j: each thread holds 2*NI consecutive
  // columns of two rows
  float* const part_z = ws + (size_t)z * M * N;
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm0 + a * 16 + g + hf * 8;
      if (m >= M) continue;
      float v[2 * NI];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < NI; ++j) v[e * NI + j] = acc[a][j][2 * hf + e];
      const int n = n0 + wn0 + 2 * NI * t;
      if (splits == 1) {
        if constexpr (C::NAF) {
#pragma unroll
          for (int i = 0; i < 2 * NI; ++i) v[i] = naf_out(v[i], naf_mode, out);
        }
        store_run<2 * NI>(out + (size_t)m * N, n, N, v);
      } else {
        store_run<2 * NI>(part_z + (size_t)m * N, n, N, v);   // raw f32 partials
      }
    }
  if (splits == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
    last_block = atomicAdd(counter, 1) == splits - 1;
    if (last_block) *counter = 0;          // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the tile's last block: sum the partials in split order, cast once
  const int cols = min(BN, N - n0);
  const size_t MN = (size_t)M * N;
  if ((N & 3) == 0) {
    // whole 4-column groups, GPT a thread; ZU splits' loads in flight
    constexpr int G = BN / 4, GPT = (BM * G + THREADS - 1) / THREADS;
    constexpr int ZU = GPT >= 16 ? 1 : 16 / GPT;
    float4 sum[GPT];
#pragma unroll
    for (int j = 0; j < GPT; ++j) sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < splits; z0 += ZU) {
      float4 p[ZU][GPT];
#pragma unroll
      for (int u = 0; u < ZU; ++u)
#pragma unroll
        for (int j = 0; j < GPT; ++j) {
          const int gi = tid + j * THREADS, r = gi / G, c = (gi % G) * 4;
          p[u][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (z0 + u < splits && gi < BM * G && r < live && c < cols)
            p[u][j] = __ldcg(reinterpret_cast<const float4*>(
                ws + (z0 + u) * MN + (size_t)(m0 + r) * N + n0 + c));
        }
#pragma unroll
      for (int u = 0; u < ZU; ++u)
#pragma unroll
        for (int j = 0; j < GPT; ++j) {
          sum[j].x += p[u][j].x;
          sum[j].y += p[u][j].y;
          sum[j].z += p[u][j].z;
          sum[j].w += p[u][j].w;
        }
    }
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      const int gi = tid + j * THREADS, r = gi / G, c = (gi % G) * 4;
      if constexpr (C::NAF) {
        sum[j].x = naf_out(sum[j].x, naf_mode, out);
        sum[j].y = naf_out(sum[j].y, naf_mode, out);
        sum[j].z = naf_out(sum[j].z, naf_mode, out);
        sum[j].w = naf_out(sum[j].w, naf_mode, out);
      }
      if (gi < BM * G && r < live && c < cols)
        store4(out + (size_t)(m0 + r) * N + n0 + c, sum[j].x, sum[j].y, sum[j].z, sum[j].w);
    }
  } else {
    // rows not 16-byte aligned: element by element
    for (int e = tid; e < live * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      if (c >= cols) continue;
      const size_t off = (size_t)(m0 + r) * N + n0 + c;
      float s = 0.f;
      for (int zz = 0; zz < splits; ++zz) s += __ldcg(ws + zz * MN + off);
      if constexpr (C::NAF) s = naf_out(s, naf_mode, out);
      store1(out + off, s);
    }
  }
}

template <int FMT, typename XT, typename OT, class C>
int launch(const void* x, const void* codes, const float* scales, void* out,
           float* ws, int* counters, int M, int N, int K, int sub_block,
           int grid_x, int grid_y, int splits, int k_per_split, int naf_mode,
           cudaStream_t stream) {
  using L = Layout<FMT, XT, C>;
  if (grid_x != (N + C::BN - 1) / C::BN || grid_y != (M + C::BM - 1) / C::BM ||
      naf_mode < RELU || naf_mode > IDENTITY || C::NAF != (naf_mode != IDENTITY) ||
      splits < 1 || k_per_split < 1 || (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1 && (k_per_split % BK != 0 || k_per_split % sub_block != 0 ||
                      ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // scale rows one 64-deep slab can touch, and as many ring stages as fit
  const int srows = std::min(BK, (BK - 1) / sub_block + 2);
  const int slabs = (std::min(K, k_per_split) + BK - 1) / BK;
  const int fit = (SMEM_LIMIT - L::FIXED_BYTES) / L::stage_bytes(srows);
  const int stages = std::min(std::min(C::MAX_STAGES, fit), std::max(2, slabs));
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int bytes = L::FIXED_BYTES + stages * L::stage_bytes(srows);

  auto kernel = qmm_kernel<FMT, XT, OT, C>;
  static int opted_in[MAX_DEVICES] = {0};   // bytes already allowed per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (bytes > opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = bytes;
  }
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  const uintptr_t cp = reinterpret_cast<uintptr_t>(codes);
  const uintptr_t sp = reinterpret_cast<uintptr_t>(scales);
  const int vec = ((xp % 16 == 0 && K % (16 / (int)sizeof(XT)) == 0) ? VEC_X : 0) |
                  ((cp % 16 == 0 && N % 16 == 0) ? VEC_CODES : 0) |
                  ((sp % 16 == 0 && N % 4 == 0) ? VEC_SCALES : 0);
  kernel<<<dim3(grid_x, grid_y, splits), kThreads<C>, bytes, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes), scales,
      static_cast<OT*>(out), ws, counters, M, N, K, sub_block,
      (sub_block & (sub_block - 1)) == 0 ? __builtin_ctz(sub_block) : -1, k_per_split,
      splits, stages, srows, vec, naf_mode);
  return (int)cudaGetLastError();
}

template <int FMT, class C>
int launch_io(const void* x, int x_bf16, const void* codes, const float* scales,
              void* out, int out_bf16, float* ws, int* counters, int M, int N, int K,
              int sub_block, int gx, int gy, int splits, int kps, int naf_mode,
              cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (x_bf16 && out_bf16)
    return launch<FMT, BF, BF, C>(x, codes, scales, out, ws, counters, M, N, K, sub_block, gx, gy, splits, kps, naf_mode, s);
  if (x_bf16)
    return launch<FMT, BF, float, C>(x, codes, scales, out, ws, counters, M, N, K, sub_block, gx, gy, splits, kps, naf_mode, s);
  if (out_bf16)
    return launch<FMT, float, BF, C>(x, codes, scales, out, ws, counters, M, N, K, sub_block, gx, gy, splits, kps, naf_mode, s);
  return launch<FMT, float, float, C>(x, codes, scales, out, ws, counters, M, N, K, sub_block, gx, gy, splits, kps, naf_mode, s);
}

template <int FMT>
int launch_regime(int regime, const void* x, int x_bf16, const void* codes,
                  const float* scales, void* out, int out_bf16, float* ws,
                  int* counters, int M, int N, int K, int sub_block, int gx,
                  int gy, int splits, int kps, int naf_mode, cudaStream_t s) {
#define QMM_CFG(C) \
  launch_io<FMT, C>(x, x_bf16, codes, scales, out, out_bf16, ws, counters, M, N, K, \
                    sub_block, gx, gy, splits, kps, naf_mode, s)
  const bool with_naf = naf_mode != IDENTITY;
  if (regime == DECODE) return with_naf ? QMM_CFG(WithNaf<DecodeCfg>) : QMM_CFG(DecodeCfg);
  if (regime == PREFILL) return with_naf ? QMM_CFG(WithNaf<PrefillCfg>) : QMM_CFG(PrefillCfg);
#undef QMM_CFG
  return (int)cudaErrorInvalidValue;
}

}  // namespace


extern "C" int qmm_set_codebooks(const float* host_tables) {
  return (int)cudaMemcpyToSymbol(kCodebook, host_tables, sizeof(float) * 32);
}

// One launch of the plan (regime, grid_x, grid_y, splits, k_per_split)
// that kernels/qmm.py::qmm_plan made for these shapes. When splits > 1,
// workspace holds splits * M * N floats and counters grid_x * grid_y
// ints that are 0 (each launch leaves them 0); both are unused otherwise.
// naf is the NAF mode of the epilogue (enum Naf; IDENTITY for none).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int qmm_launch(const void* x, int x_bf16, const void* codes,
                          const float* scales, void* out, int out_bf16, int M,
                          int N, int K, int sub_block, int fmt, int regime,
                          int grid_x, int grid_y, int splits, int k_per_split,
                          float* workspace, int* counters, void* stream, int naf) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMM_CASE(F)                                                                   \
  case F:                                                                             \
    return launch_regime<F>(regime, x, x_bf16, codes, scales, out, out_bf16, workspace, \
                            counters, M, N, K, sub_block, grid_x, grid_y, splits,      \
                            k_per_split, naf, s);
  switch (fmt) {
    QMM_CASE(INT4)
    QMM_CASE(FP4)
    QMM_CASE(NF4)
    QMM_CASE(INT8)
    QMM_CASE(FP8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef QMM_CASE
}

// qmm_launch with its 20 arguments in one array of 64-bit integers, in
// the same order (pointers and the stream as addresses): the wrapper keeps
// one such array per plan and rewrites only the pointers, so a call
// crosses ctypes with one argument instead of 20.
extern "C" int qmm_launch_packed(const long long* a) {
  return qmm_launch(reinterpret_cast<const void*>(a[0]), (int)a[1],
                    reinterpret_cast<const void*>(a[2]), reinterpret_cast<const float*>(a[3]),
                    reinterpret_cast<void*>(a[4]), (int)a[5], (int)a[6], (int)a[7], (int)a[8],
                    (int)a[9], (int)a[10], (int)a[11], (int)a[12], (int)a[13], (int)a[14],
                    (int)a[15], reinterpret_cast<float*>(a[16]), reinterpret_cast<int*>(a[17]),
                    reinterpret_cast<void*>(a[18]), (int)a[19]);
}
