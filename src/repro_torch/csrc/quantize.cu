// K7: rowwise absmax quantization to int8 or int4 values, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantize.py::_quantize_kernel
// (reached through quantize_rowwise_kernel at quantize.py:46).
//
// Computes, for x (M, K) bf16/f32 and QMAX 127 (bits 8) or 7 (bits 4):
//   s[m] = absmax_k |x[m, k]| * f32(1/QMAX)         (1 where absmax is 0)
//   q[m, k] = clamp(rint(x[m, k] / s[m]), -QMAX, QMAX)   as int8
// the reference's f32 chain as XLA compiles it, from the header that K1/K4
// run in their prologue (camp_quant.cuh), so quantize-then-GEMM equals the
// fused kernels bit for bit. A zero row comes out as (0, 1).
//
// What bounds it on this card: bytes. It reads x (2 or 4 bytes a value)
// and writes q (1 byte) and s; the arithmetic is a few f32 operations a
// value. So x is read once, in 16-byte loads (one value at a time where a
// row is not 16-byte aligned), into registers: a team of `team` threads
// takes a row, thread t its groups t, t + team, ... (a warp's loads are
// 512 contiguous bytes). The absmax comes from those registers by warp
// shuffles and the team's warps; then the same registers are quantized
// (quantize_group: one fma with 1.5 * 2^23 a value, the division only for
// groups near a half-integer) and q is stored as 8-byte (bf16) or 4-byte
// (f32) words. A team is 32 to 256 threads (several rows a block), or a
// cluster of 2 to 8 blocks of 256 whose blocks share their maxima through
// distributed shared memory. kernels/quantize.py::team_size picks it:
// each thread holds its first kRegGroups groups in registers and reads any
// others again from L2 to quantize them (at most as many again, but in
// rows wider than a cluster's threads take), and the rows are spread over
// the card. Four registered groups (63-64 registers, no spills) ran
// faster on the card than eight (80-94) and than two (PERF.md, PR 13).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "camp_quant.cuh"
#include "hopper.cuh"

namespace {

using camp_quant::exact_only;
using camp_quant::gather_x;
using camp_quant::group_value;
using camp_quant::quantize_group;
using camp_quant::quantize_group_exact;
using camp_quant::scale_of;

constexpr int kThreads = 256;
constexpr int kRegGroups = 4;      // 16-byte groups a thread holds
constexpr int kMaxCluster = 8;     // blocks a row at most (portable)

template <int QMAX, int XB>
__global__ void __launch_bounds__(kThreads)
quantize_rowwise_kernel(const uint8_t* __restrict__ x,
                        int8_t* __restrict__ q, float* __restrict__ s,
                        int M, int K, int team, int xvec) {
  constexpr int KPG = 16 / XB;                 // values a group
  __shared__ float warp_amax[kThreads / 32];
  __shared__ float block_amax;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blocks = team > kThreads ? team / kThreads : 1;   // a row
  const long m = team < kThreads
                     ? (long)blockIdx.x * (kThreads / team) + tid / team
                     : blockIdx.x / blocks;
  const int t = team < kThreads ? tid % team
                                : (blockIdx.x % blocks) * kThreads + tid;
  const bool live = m < M;
  const int groups = (K + KPG - 1) / KPG;
  const uint8_t* row = x + (live ? m : 0) * K * XB;
  int8_t* qrow = q + (live ? m : 0) * K;

  auto load = [&](int g) {
    return xvec ? __ldg(reinterpret_cast<const uint4*>(row) + g)
                : gather_x<XB>(row + 16L * g, K - g * KPG);
  };
  auto amax_of = [](const uint4& u, float amax) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < KPG; ++e)
      amax = fmaxf(amax, fabsf(group_value<XB>(w, e)));
    return amax;
  };

  uint4 v[kRegGroups];
#pragma unroll
  for (int j = 0; j < kRegGroups; ++j) {
    const int g = t + team * j;
    v[j] = live && g < groups ? load(g) : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kRegGroups; ++j) amax = amax_of(v[j], amax);
#pragma unroll 1
  for (int g = t + team * kRegGroups; live && g < groups; g += team)
    amax = amax_of(load(g), amax);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();
  const int tw = min(team, kThreads) / 32, w0 = warp / tw * tw;
  amax = warp_amax[w0];
  for (int i = 1; i < tw; ++i) amax = fmaxf(amax, warp_amax[w0 + i]);
  if (blocks > 1) {
    if (tid == 0) block_amax = amax;
    hopper::cluster_arrive();
    hopper::cluster_wait();
    const uint32_t at = hopper::smem_u32(&block_amax);
    for (int r = 0; r < blocks; ++r)
      amax = fmaxf(amax, hopper::ld_cluster_f32(at, r));
    // done with the others' shared memory: none may exit before this
    hopper::cluster_arrive();
  }
  const float sc = scale_of<QMAX>(amax);
  if (live && t == 0) s[m] = sc;
  const float r = __frcp_rn(sc);
  const bool exact = exact_only(r);

  auto store = [&](int g, uint32_t b0, uint32_t b1) {
    const int k = g * KPG;
    if (xvec) {
      if constexpr (XB == 2)
        *reinterpret_cast<uint2*>(qrow + k) = make_uint2(b0, b1);
      else
        *reinterpret_cast<uint32_t*>(qrow + k) = b0;
    } else {
      for (int e = 0; e < KPG && k + e < K; ++e)
        qrow[k + e] = static_cast<int8_t>((e < 4 ? b0 : b1) >> (8 * (e & 3)));
    }
  };
  // the register groups; those near a half-integer (about one in 1,000)
  // afterwards, picked by unrolled selects, so that the division has one
  // copy in the code
  uint32_t redo = 0;
#pragma unroll
  for (int j = 0; j < kRegGroups; ++j) {
    const int g = t + team * j;
    uint32_t b[2];
    if (live && g < groups) {
      if (!exact && quantize_group<QMAX, XB>(v[j], r, b))
        store(g, b[0], b[1]);
      else
        redo |= 1u << j;
    }
  }
#pragma unroll 1
  for (int j = 0; redo != 0; ++j, redo >>= 1) {
    if (!(redo & 1)) continue;
    uint4 u = v[0];
#pragma unroll
    for (int jj = 1; jj < kRegGroups; ++jj)
      if (jj == j) u = v[jj];
    uint32_t b[2];
    quantize_group_exact<QMAX, XB>(u, sc, b);
    store(t + team * j, b[0], b[1]);
  }
#pragma unroll 1
  for (int g = t + team * kRegGroups; live && g < groups; g += team) {
    const uint4 u = load(g);
    uint32_t b[2];
    if (exact || !quantize_group<QMAX, XB>(u, r, b))
      quantize_group_exact<QMAX, XB>(u, sc, b);
    store(g, b[0], b[1]);
  }
  if (blocks > 1) hopper::cluster_wait();
}

template <int QMAX, int XB>
int launch(const void* x, void* q, void* s, int M, int K, int team,
           int xvec, cudaStream_t stream) {
  const int blocks = team > kThreads ? team / kThreads : 1;
  const int rows = team < kThreads ? kThreads / team : 1;   // a block
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      team < kThreads ? (M + rows - 1) / rows : (long)M * blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, quantize_rowwise_kernel<QMAX, XB>,
      static_cast<const uint8_t*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), M, K, team, xvec));
}

}  // namespace

// K7's entry (kernels/quantize.py binds it): x (M, K) bf16 (x_bf16) or
// f32, q (M, K) int8 and s (M) f32 out, bits 8 or 4, the threads a row
// (team: a power of two from 32 to 2,048), the stream.
extern "C" int quantize_rowwise(const void* x, int x_bf16, void* q, void* s,
                                int M, int K, int bits, int team,
                                void* stream) {
  if (M < 1 || K < 0 || (bits != 8 && bits != 4) || team < 32 ||
      team > kThreads * kMaxCluster || (team & (team - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xb = x_bf16 ? 2 : 4;
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
                   (long)K * xb % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return x_bf16 ? launch<127, 2>(x, q, s, M, K, team, xvec, st)
                  : launch<127, 4>(x, q, s, M, K, team, xvec, st);
  return x_bf16 ? launch<7, 2>(x, q, s, M, K, team, xvec, st)
                : launch<7, 4>(x, q, s, M, K, team, xvec, st);
}
