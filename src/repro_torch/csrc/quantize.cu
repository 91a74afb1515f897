// K7: rowwise absmax quantization to int8 or int4 values, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantize.py::_quantize_kernel
// (reached through quantize_rowwise_kernel at quantize.py:46).
//
// Computes, for x (M, K) bf16/f32 and QMAX 127 (bits 8) or 7 (bits 4):
//   s[m] = absmax_k |x[m, k]| * (1/QMAX)            (1 where absmax is 0)
//   q[m, k] = clamp(rint(x[m, k] / s[m]), -QMAX, QMAX)   as int8
// the reference's f32 chain as XLA compiles it (the division by the
// constant QMAX becomes a multiplication by its f32 reciprocal; x / s is a
// true division; rintf rounds half to even), and the chain K1/K4 run in
// their prologue, so quantize-then-GEMM equals the fused kernels bit for
// bit. A zero row comes out as (0, 1).
//
// What bounds it on this card: bytes. It reads x once from device memory
// (2 or 4 bytes a value) and writes q (1 byte) and s; the arithmetic is a
// few f32 operations per value. One block of 256 threads takes one row: a
// strided pass reduces |x| to the row's absmax (warp shuffles, then the 8
// warps through shared memory), and a second strided pass quantizes the row,
// which the first pass left in L1/L2 (at most 19 KB in bf16 at K = 4864).
// Neighbouring threads touch neighbouring values in both passes. Vector
// loads and several rows per block for wide M are later work.
#include "camp_gemm_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int QMAX>
__global__ void __launch_bounds__(kThreads)
quantize_rowwise_kernel(const void* __restrict__ x, int x_bf16,
                        int8_t* __restrict__ q, float* __restrict__ s,
                        int K) {
  __shared__ float warp_max[kThreads / 32];
  constexpr float kRecip = 1.0f / (float)QMAX;
  const long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  float amax = 0.f;
  for (int k = tid; k < K; k += kThreads)
    amax = fmaxf(amax, fabsf(camp::load_f(x, x_bf16, row * K + k)));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  amax = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = (amax == 0.f) ? 1.f : amax * kRecip;
  if (tid == 0) s[row] = scale;

  for (int k = tid; k < K; k += kThreads) {
    const float v = camp::load_f(x, x_bf16, row * K + k);
    const float qv =
        fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -(float)QMAX), (float)QMAX);
    q[row * K + k] = (int8_t)(int)qv;
  }
}

}  // namespace

extern "C" int quantize_rowwise(const void* x, int x_bf16, void* q, void* s,
                                int M, int K, int bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (bits == 8)
    quantize_rowwise_kernel<127><<<M, kThreads, 0, st>>>(x, x_bf16, qp, sp, K);
  else
    quantize_rowwise_kernel<7><<<M, kThreads, 0, st>>>(x, x_bf16, qp, sp, K);
  return static_cast<int>(cudaGetLastError());
}
