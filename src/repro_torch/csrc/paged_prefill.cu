// K2: chunked paged prefill attention over int8 KV pages, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py::_prefill_kernel
// (reached through _paged_prefill_pallas at paged_prefill.py:197).
//
// Computes causal attention of one sequence's chunk of C tokens, at
// positions [q_start, q_start + C), over every cached token: q (KV, C, G,
// hd) in bf16/f32, pages (P, KV, ps, hd) int8 with per-token scales (P, KV,
// ps) f32, block table (>= ceil((q_start + C) / ps),) int32. Query row r of
// kv head h (token r / G) sees columns col <= q_start + r / G. q_start is a
// runtime argument and may fall mid-page.
//
// What bounds it on this card: at the prefill shapes (C 256, G 7, hd 64, a
// few hundred cached tokens) the work is 4 * C * G * T * hd operations
// against a few hundred KB of int8 pages: bound by operations (0.59 us at
// q_start 512 in bf16). The TPU kernel held all C * G query rows in one
// VMEM block; here (paged_common.cuh) a block takes 64 query rows, 16 per
// warp, and runs both products on the tensor cores with the softmax in
// registers, while the next 64-token tile arrives by cp.async. At C 256
// that is only KV x 28 blocks, so the kv range is split too (grid row
// tiles x KV x n_split), and a second, small kernel merges the splits. A
// tile wholly past the causal bound of a block's last row is never loaded,
// and no slot at or past ceil((q_start + C) / ps) is read. The engine's
// pages_per_step does not reach the kernel: tiles are 64 tokens whatever
// the page size.
#include "paged_common.cuh"

// q, out: (KV, C, G, hd); part: KV * n_split * C * G * (hd + 2) f32 when
// n_split > 1. Returns the first failing launch's cudaError_t, or 0.
extern "C" int paged_prefill(const void* q, void* out, void* part, int bf16,
                             const void* kp, const void* vp, const void* ks,
                             const void* vs, const void* table, int KV, int C,
                             int G, int hd, int ps, int q_start,
                             float sm_scale, int n_split, int tiles_per_split,
                             void* stream) {
  paged::Args a;
  a.q = q;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.kp = static_cast<const int8_t*>(kp);
  a.vp = static_cast<const int8_t*>(vp);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.tables = static_cast<const int*>(table);
  a.lengths = nullptr;
  a.table_stride = 0;
  a.q_start = q_start;
  a.KV = KV;
  a.rows = C * G;
  a.G = G;
  a.hd = hd;
  a.ps = ps;
  a.sm_scale = sm_scale;
  a.tiles_per_split = tiles_per_split;
  return paged::launch<paged::Prefill>(a, bf16, KV, n_split,
                       static_cast<cudaStream_t>(stream));
}
