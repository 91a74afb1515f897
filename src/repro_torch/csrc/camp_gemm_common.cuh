// Shared device code of the CAMP integer GEMMs: K1/K4 (camp_gemm_fused.cu,
// activations quantized inside the kernel) and K5/K6a/K6b (camp_gemm.cu,
// activations quantized beforehand). One kernel template covers all six:
//
//   A_KIND  how A arrives: kAFloat, x (M, K) bf16/f32, quantized per row
//           inside the kernel to [-QMAX, QMAX]; kAInt8, int8 (M, K); kAInt4,
//           int4 packed two per byte along K, (M, K/2). The last two come
//           with their row scales s_a (M, 1) f32.
//   W4      B is int4 packed two per byte along K, (K/2, N), instead of
//           int8 (K, N).
//   QMAX    127 or 7: the activation range of kAFloat.
//
// A packed byte holds k = 2i in its low nibble and k = 2i + 1 in its high
// nibble, both sign-extended when unpacked (the reference's _unpack_k_rows
// and _unpack_k_cols). K is even whenever an operand is packed and a K tile
// is 64 wide, so a tile boundary never splits a packed byte. Packed tiles
// are unpacked into sign-extended int8 in shared memory before the product:
// Hopper has no int4 MMA operand, and the TPU kernels too unpack on chip
// before an int8 dot. Ragged edges are masked in the kernel (zero k
// columns do not move a row's absmax), so no operand is padded in memory.
//
// kAFloat quantizes with the reference's f32 chain as XLA compiles it:
//   s_a[m] = absmax_k |x[m, k]| * (1/QMAX)        (1 where absmax is 0)
//   q[m, k] = clamp(rint(x[m, k] / s_a[m]), -QMAX, QMAX)
// (XLA turns the division by the constant QMAX into a multiplication by its
// f32 reciprocal; the quotient x / s_a is a true division; rintf rounds half
// to even like jnp.round). A prologue pass over K computes each row's
// absmax, since a whole K row does not fit shared memory at K = 4864 (max
// does not depend on order, so this stays bit-exact); then A is quantized
// tile by tile in the K loop, and neither the int8 activations nor their
// scales exist in device memory.
//
// The product is __dp4a on int8 tiles in shared memory (4 MACs per
// instruction, int32 accumulation: 127 * 127 * 4864 < 2^31). The flush:
//   y[m, n] = (float) acc[m, n] * (s_a[m] * s_b[n])
// then the epilogue stages (bias / silu / gelu / residual / mul) in f32 and
// one store in the output type. A first additive stage (bias, residual)
// fuses with the scale multiply into one fmaf, as XLA compiles the
// reference; every other step rounds on its own (__fmul_rn / __fadd_rn, so
// nvcc contracts nothing else). Built without --use_fast_math: '/' is IEEE
// division here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace camp {

constexpr int BM = 32;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // K per shared-memory tile (even)
constexpr int KW = BK / 4;       // packed int32 words per tile row
constexpr int THREADS = 256;     // 16 x 16 threads, 2 x 4 outputs each

// Stage codes, 4 bits each in `stages`, first stage in the low bits.
enum Stage { kBias = 1, kSilu = 2, kGelu = 3, kResidual = 4, kMul = 5 };
enum AKind { kAFloat = 0, kAInt8 = 1, kAInt4 = 2 };

struct GemmArgs {
  const void* a;       // x (kAFloat), int8 A (kAInt8) or packed A (kAInt4)
  int a_bf16;
  const float* sa;     // (M, 1) row scales; unused for kAFloat
  const int8_t* w;     // (K, N) int8 or (K/2, N) packed int4
  const float* sb;     // (1, N)
  const void* bias;
  int bias_bf16;
  const void* opd;
  int opd_bf16;
  void* out;
  int out_bf16;
  int M, N, K, stages, n_stages;
};

__device__ __forceinline__ float load_f(const void* p, int bf16, long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// The two sign-extended nibbles of a packed byte, as int8 bit patterns in
// bytes j and j + 1 of a dp4a word.
__device__ __forceinline__ uint32_t unpack_pair(uint8_t b, int j) {
  const int8_t lo = (int8_t)(uint8_t)(b << 4) >> 4;
  const int8_t hi = (int8_t)b >> 4;
  return ((uint32_t)(uint8_t)lo << (8 * j)) |
         ((uint32_t)(uint8_t)hi << (8 * (j + 1)));
}

__device__ __forceinline__ float flush_one(const GemmArgs& p, int m, int n,
                                           int acc, float sa) {
  const long o = (long)m * p.N + n;
  const float acc_f = __int2float_rn(acc);
  const float scale = __fmul_rn(sa, p.sb[n]);
  const int first = p.stages & 15;
  float y;
  int s0 = 0;
  if (p.n_stages > 0 && (first == kBias || first == kResidual)) {
    // The reference, as XLA compiles it, fuses the scale multiply and a
    // first additive stage into one fused multiply-add.
    y = fmaf(acc_f, scale, first == kBias ? load_f(p.bias, p.bias_bf16, n)
                                          : load_f(p.opd, p.opd_bf16, o));
    s0 = 1;
  } else {
    y = __fmul_rn(acc_f, scale);
  }
  for (int s = s0; s < p.n_stages; ++s) {
    const int st = (p.stages >> (4 * s)) & 15;
    if (st == kBias) {
      y = __fadd_rn(y, load_f(p.bias, p.bias_bf16, n));
    } else if (st == kSilu) {
      y = __fmul_rn(y, 1.f / (1.f + expf(-y)));
    } else if (st == kGelu) {
      y = 0.5f * y *
          (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
    } else if (st == kResidual) {
      y = __fadd_rn(y, load_f(p.opd, p.opd_bf16, o));
    } else {
      y = __fmul_rn(y, load_f(p.opd, p.opd_bf16, o));
    }
  }
  return y;
}

template <int A_KIND, bool W4, int QMAX>
__global__ void __launch_bounds__(THREADS) camp_gemm_kernel(const GemmArgs p) {
  __shared__ int32_t As[BM][KW];       // int8 A tile, 4 k per word
  __shared__ int32_t Bs[BN][KW + 1];   // int8 B tile, transposed, padded row
  __shared__ float sa[BM];             // per-row activation scales

  const int tid = threadIdx.x;
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if constexpr (A_KIND == kAFloat) {
    // Prologue: each warp reduces whole rows of x to their absmax.
    constexpr float kRecip = 1.0f / (float)QMAX;
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int m = m0 + r;
      float amax = 0.f;
      if (m < M) {
        for (int k = lane; k < K; k += 32)
          amax = fmaxf(amax, fabsf(load_f(p.a, p.a_bf16, (long)m * K + k)));
      }
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) sa[r] = (amax == 0.f) ? 1.f : amax * kRecip;
    }
  } else {
    for (int r = tid; r < BM; r += THREADS)
      sa[r] = (m0 + r < M) ? p.sa[m0 + r] : 1.f;
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 4 consecutive k of one row into one word.
    for (int i = tid; i < BM * KW; i += THREADS) {
      const int r = i / KW, kw = i % KW;
      const int m = m0 + r, kb = k0 + kw * 4;
      uint32_t word = 0;
      if (m < M) {
        if constexpr (A_KIND == kAFloat) {
          const float s = sa[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = kb + j;
            const float v =
                (k < K) ? load_f(p.a, p.a_bf16, (long)m * K + k) : 0.f;
            const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -(float)QMAX),
                                  (float)QMAX);
            word |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * j);
          }
        } else if constexpr (A_KIND == kAInt8) {
          const int8_t* a = static_cast<const int8_t*>(p.a) + (long)m * K;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = kb + j;
            word |= (uint32_t)(uint8_t)((k < K) ? a[k] : (int8_t)0) << (8 * j);
          }
        } else {
          const uint8_t* a =
              static_cast<const uint8_t*>(p.a) + (long)m * (K / 2);
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            if (kb + j < K) word |= unpack_pair(a[(kb + j) / 2], j);
          }
        }
      }
      As[r][kw] = (int32_t)word;
    }
    // B tile: 4 consecutive k of one column into one word (n fastest, so
    // neighbouring threads read neighbouring bytes).
    for (int i = tid; i < BN * KW; i += THREADS) {
      const int c = i % BN, kw = i / BN;
      const int n = n0 + c, kb = k0 + kw * 4;
      uint32_t word = 0;
      if (n < N) {
        if constexpr (W4) {
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            if (kb + j < K)
              word |= unpack_pair((uint8_t)p.w[(long)((kb + j) / 2) * N + n],
                                  j);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = kb + j;
            word |= (uint32_t)(uint8_t)((k < K) ? p.w[(long)k * N + n]
                                                : (int8_t)0) << (8 * j);
          }
        }
      }
      Bs[c][kw] = (int32_t)word;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      const int a0 = As[ty * 2][kw], a1 = As[ty * 2 + 1][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = Bs[tx + 16 * j][kw];
        acc[0][j] = __dp4a(a0, b, acc[0][j]);
        acc[1][j] = __dp4a(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }

  // Flush: Cartesian scale (scale product first), stages, one store.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i, m = m0 + r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float y = flush_one(p, m, n, acc[i][j], sa[r]);
      const long o = (long)m * N + n;
      if (p.out_bf16)
        static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(p.out)[o] = y;
    }
  }
}

template <int A_KIND, bool W4, int QMAX>
inline int launch(const GemmArgs& p, void* stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  camp_gemm_kernel<A_KIND, W4, QMAX>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace camp

// One C entry point per instance, all with the same signature (bound by
// kernels/camp_gemm.py::launch_gemm); `sa` is NULL for the fused kernels.
#define CAMP_GEMM_ENTRY(NAME, A_KIND, W4, QMAX)                               \
  extern "C" int NAME(const void* a, int a_bf16, const void* sa,             \
                      const void* w, const void* sb, const void* bias,       \
                      int bias_bf16, const void* opd, int opd_bf16,          \
                      void* out, int out_bf16, int M, int N, int K,          \
                      int stages, int n_stages, void* stream) {              \
    const camp::GemmArgs p{a,         a_bf16,                                \
                           static_cast<const float*>(sa),                    \
                           static_cast<const int8_t*>(w),                    \
                           static_cast<const float*>(sb),                    \
                           bias,      bias_bf16, opd, opd_bf16, out,         \
                           out_bf16,  M,         N,   K,        stages,      \
                           n_stages};                                        \
    return camp::launch<A_KIND, W4, QMAX>(p, stream);                        \
  }
