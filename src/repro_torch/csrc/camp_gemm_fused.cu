// K1: fused activation quantize + int8 GEMM + epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/camp_gemm_fused.py::_fused_kernel
// (reached through camp_gemm_fused_w8a8 at camp_gemm_fused.py:108), together
// with its flush src/repro/kernels/epilogue.py::flush_epilogue.
//
// Computes, for x (M, K) bf16/f32 and W (K, N) int8 with column scales s_b:
//   s_a[m] = absmax_k |x[m, k]| * (1/127)         (1 where absmax is 0)
//   q[m, k] = clamp(rint(x[m, k] / s_a[m]), -127, 127)
//   y[m, n] = (float) sum_k q[m, k] * W[k, n]  *  (s_a[m] * s_b[n])
// then the epilogue stages (bias / silu / gelu / residual / mul) in f32 and
// one store in the output type. A first additive stage (bias, residual)
// fuses with the scale multiply into one fmaf, as XLA compiles the
// reference; every other step rounds on its own (__fmul_rn / __fadd_rn, so
// nvcc contracts nothing else). The f32 chain is the reference's as XLA
// compiles it (division by the constant 127 becomes a multiplication by its
// f32 reciprocal; the quotient x / s_a is a true division; rintf rounds half
// to even like jnp.round), so the int8 activations are bit-identical to it.
// Built without --use_fast_math: '/' is IEEE division here.
//
// What bounds it on this card: at the serving shapes (M = batch 1-8 in
// decode, M = chunk 256 in prefill; (K, N) in {(896, 896), (896, 128),
// (896, 4864), (4864, 896)}) the least time is the bytes of W (one byte per
// weight) over HBM bandwidth; the product itself (2MNK int8 operations) is
// far below the tensor cores' rate. The TPU kernel kept the whole K row of
// A resident in VMEM; at K = 4864 that does not fit a thread block's shared
// memory, so each block first computes its rows' absmax in a prologue pass
// over K (max does not depend on order, so this stays bit-exact), then
// quantizes A tile by tile inside the K loop. The int8 activations never
// exist in device memory, and neither do their scales: the one store is the
// finished output. The integer product uses __dp4a on int8 tiles in shared
// memory (4 MACs per instruction, int32 accumulation: 127^2 * 4864 < 2^31).
// This is the simple first version: wgmma, TMA and a split-K for decode
// shapes are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // K per shared-memory tile
constexpr int KW = BK / 4;       // packed int32 words per tile row
constexpr int THREADS = 256;     // 16 x 16 threads, 2 x 4 outputs each
constexpr float kRecip127 = 1.0f / 127.0f;

// Stage codes, 4 bits each in `stages`, first stage in the low bits.
enum Stage { kBias = 1, kSilu = 2, kGelu = 3, kResidual = 4, kMul = 5 };

__device__ __forceinline__ float load_f(const void* p, int bf16, long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(THREADS)
fused_w8a8_kernel(const void* __restrict__ x, int x_bf16,
                  const int8_t* __restrict__ w, const float* __restrict__ sb,
                  const void* __restrict__ bias, int bias_bf16,
                  const void* __restrict__ opd, int opd_bf16,
                  void* __restrict__ out, int out_bf16,
                  int M, int N, int K, int stages, int n_stages) {
  __shared__ int32_t As[BM][KW];       // quantized x tile, 4 k per word
  __shared__ int32_t Bs[BN][KW + 1];   // W tile, transposed, padded row
  __shared__ float sa[BM];             // per-row activation scales

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // Prologue: each warp reduces whole rows of x to their absmax.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    float amax = 0.f;
    if (m < M) {
      for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(load_f(x, x_bf16, (long)m * K + k)));
    }
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) sa[r] = (amax == 0.f) ? 1.f : amax * kRecip127;
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: quantize 4 consecutive k of one row into one word.
    for (int i = tid; i < BM * KW; i += THREADS) {
      const int r = i / KW, kw = i % KW;
      const int m = m0 + r;
      uint32_t packed = 0;
      if (m < M) {
        const float s = sa[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + kw * 4 + j;
          const float v = (k < K) ? load_f(x, x_bf16, (long)m * K + k) : 0.f;
          const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
          packed |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * j);
        }
      }
      As[r][kw] = (int32_t)packed;
    }
    // W tile: 4 consecutive k of one column into one word (n fastest, so
    // neighbouring threads read neighbouring bytes).
    for (int i = tid; i < BN * KW; i += THREADS) {
      const int c = i % BN, kw = i / BN;
      const int n = n0 + c;
      uint32_t packed = 0;
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + kw * 4 + j;
          const int8_t v = (k < K) ? w[(long)k * N + n] : (int8_t)0;
          packed |= (uint32_t)(uint8_t)v << (8 * j);
        }
      }
      Bs[c][kw] = (int32_t)packed;
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
      const long o = (long)m * N + n;
      const float acc_f = __int2float_rn(acc[i][j]);
      const float scale = __fmul_rn(sa[r], sb[n]);
      const int first = stages & 15;
      float y;
      int s0 = 0;
      if (n_stages > 0 && (first == kBias || first == kResidual)) {
        // The reference, as XLA compiles it, fuses the scale multiply and
        // a first additive stage into one fused multiply-add.
        y = fmaf(acc_f, scale, first == kBias ? load_f(bias, bias_bf16, n)
                                              : load_f(opd, opd_bf16, o));
        s0 = 1;
      } else {
        y = __fmul_rn(acc_f, scale);
      }
      for (int s = s0; s < n_stages; ++s) {
        const int st = (stages >> (4 * s)) & 15;
        if (st == kBias) {
          y = __fadd_rn(y, load_f(bias, bias_bf16, n));
        } else if (st == kSilu) {
          y = __fmul_rn(y, 1.f / (1.f + expf(-y)));
        } else if (st == kGelu) {
          y = 0.5f * y *
              (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
        } else if (st == kResidual) {
          y = __fadd_rn(y, load_f(opd, opd_bf16, o));
        } else {
          y = __fmul_rn(y, load_f(opd, opd_bf16, o));
        }
      }
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(out)[o] = y;
    }
  }
}

}  // namespace

extern "C" int camp_gemm_fused_w8a8(const void* x, int x_bf16, const void* w,
                                    const void* sb, const void* bias,
                                    int bias_bf16, const void* opd,
                                    int opd_bf16, void* out, int out_bf16,
                                    int M, int N, int K, int stages,
                                    int n_stages, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_w8a8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, static_cast<const int8_t*>(w), static_cast<const float*>(sb),
      bias, bias_bf16, opd, opd_bf16, out, out_bf16, M, N, K, stages,
      n_stages);
  return static_cast<int>(cudaGetLastError());
}
