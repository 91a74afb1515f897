// K2: chunked paged prefill attention over int8 KV pages, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py::_prefill_kernel
// (reached through _paged_prefill_pallas at paged_prefill.py:197).
//
// Computes causal attention of one sequence's chunk of C tokens, at
// positions [q_start, q_start + C), over every cached token: q (KV, C, G,
// hd) in bf16/f32, pages (P, KV, ps, hd) int8 with per-token scales (P, KV,
// ps) f32, block table (>= ceil((q_start + C) / ps),) int32. Query row r of
// kv head h (token r / G) sees columns col <= q_start + r / G.
//
// What bounds it on this card: at the prefill shapes (C = 256, G = 7,
// hd = 64, a few hundred cached tokens) the work is about 4 * C * G * T * hd
// f32 operations against a few hundred KB of int8 pages, so it is bound by
// operations; the pages and q are read once per query tile from L2. The
// TPU kernel held all C * G query rows in one VMEM block; at C = 256, G = 7
// its f32 accumulator alone is 458 KB, beyond a block's shared memory, so
// here the grid is (kv head, tile of 32 query rows) and the accumulator
// lives in registers. Each tile walks pages only up to the causal bound of
// its last row (the TPU kernel visits every page; the skipped pages are
// fully masked, so nothing changes numerically) and never reads a table
// slot past ceil((q_start + C) / ps). q_start is a runtime argument and may
// fall mid-page. The score and value products run in f32 on CUDA cores;
// tensor-core MMA is later work.
#include "paged_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::THREADS)
paged_prefill_kernel(const T* __restrict__ q, T* __restrict__ out,
                     const int8_t* __restrict__ kp,
                     const int8_t* __restrict__ vp,
                     const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ table, int KV, int C, int G,
                     int hd, int ps, int pp, int q_start, float sm_scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int rows = C * G;
  const int rg0 = blockIdx.y * paged::BQ;
  const int n_rows = min(paged::BQ, rows - rg0);
  const long off = ((long)h * rows + rg0) * hd;
  paged::attend<T>(q + off, out + off, n_rows, q_start, rg0, G, kp, vp, ks,
                   vs, table, KV, h, ps, hd, pp, sm_scale, smem);
}

template <typename T>
int launch(const void* q, void* out, const void* kp, const void* vp,
           const void* ks, const void* vs, const void* table, int KV, int C,
           int G, int hd, int ps, int pp, int q_start, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = paged::smem_floats(hd, pp * ps) * sizeof(float);
  cudaError_t err = paged::prepare(paged_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(KV, (C * G + paged::BQ - 1) / paged::BQ);
  paged_prefill_kernel<T><<<grid, paged::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out),
      static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), KV, C, G, hd, ps, pp, q_start,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_prefill(const void* q, void* out, int bf16,
                             const void* kp, const void* vp, const void* ks,
                             const void* vs, const void* table, int KV, int C,
                             int G, int hd, int ps, int pp, int q_start,
                             float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, out, kp, vp, ks, vs, table, KV, C, G, hd,
                                 ps, pp, q_start, sm_scale, s);
  return launch<float>(q, out, kp, vp, ks, vs, table, KV, C, G, hd, ps, pp,
                       q_start, sm_scale, s);
}
