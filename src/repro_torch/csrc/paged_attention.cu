// K3: paged single-token decode attention over int8 KV pages, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel
// (reached through _paged_attention_pallas at paged_attention.py:178).
//
// Computes, for q (B, KV, G, hd) in bf16/f32 (one new token per sequence),
// attention over the first lengths[b] cached tokens of sequence b: pages
// (P, KV, ps, hd) int8 with per-token scales (P, KV, ps) f32 through the
// block table tables (B, max_pages) int32.
//
// What bounds it on this card: decode attention reads every cached byte
// once per step (one int8 byte per element plus a 4-byte scale per token
// row) and does ~4 * G * hd operations per cached token, so it is bound by
// bytes. Its design keeps the pages int8 in device memory and dequantizes
// them in shared memory: the grid is (batch, kv head), and the G = 7 query
// rows of a kv head share each page load. A block walks ceil(length / ps)
// pages only, so a padded table slot is never read, and it stages four
// pages per step to cut synchronisations. Softmax is online. The products
// run in f32 on CUDA cores; splitting long sequences over several blocks is
// later work.
#include "paged_common.cuh"

namespace {

constexpr int kPagesPerStep = 4;

template <typename T>
__global__ void __launch_bounds__(paged::THREADS)
paged_decode_kernel(const T* __restrict__ q, T* __restrict__ out,
                    const int8_t* __restrict__ kp,
                    const int8_t* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, int max_pages, int KV,
                    int G, int hd, int ps, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const long off = ((long)b * KV + h) * G * hd;
  paged::attend<T>(q + off, out + off, G, lengths[b] - 1, 0, G, kp, vp, ks,
                   vs, tables + (long)b * max_pages, KV, h, ps, hd,
                   kPagesPerStep, sm_scale, smem);
}

template <typename T>
int launch(const void* q, void* out, const void* kp, const void* vp,
           const void* ks, const void* vs, const void* tables,
           const void* lengths, int B, int max_pages, int KV, int G, int hd,
           int ps, float sm_scale, cudaStream_t stream) {
  const size_t smem =
      paged::smem_floats(hd, kPagesPerStep * ps) * sizeof(float);
  cudaError_t err = paged::prepare(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, KV);
  paged_decode_kernel<T><<<grid, paged::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out),
      static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      max_pages, KV, G, hd, ps, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_attention(const void* q, void* out, int bf16,
                               const void* kp, const void* vp, const void* ks,
                               const void* vs, const void* tables,
                               const void* lengths, int B, int max_pages,
                               int KV, int G, int hd, int ps, float sm_scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, out, kp, vp, ks, vs, tables, lengths, B,
                                 max_pages, KV, G, hd, ps, sm_scale, s);
  return launch<float>(q, out, kp, vp, ks, vs, tables, lengths, B, max_pages,
                       KV, G, hd, ps, sm_scale, s);
}
