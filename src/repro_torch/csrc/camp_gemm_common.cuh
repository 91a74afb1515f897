// Shared device code of the CAMP integer GEMMs (K1, K4, K5, K6a and K6b,
// all on the tensor-core template camp_gemm_tc.cuh): the arguments of a
// GEMM and its flush.
//
// The flush, once per output:
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

// Stage codes, 4 bits each in `stages`, first stage in the low bits.
enum Stage { kBias = 1, kSilu = 2, kGelu = 3, kResidual = 4, kMul = 5 };

struct GemmArgs {
  const void* a;       // A: int8, packed int4, or x (bf16/f32) to quantize
  int a_bf16;          // x is bf16 (else f32)
  const float* sa;     // (M) row scales of A
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

}  // namespace camp
