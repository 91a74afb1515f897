// K3: paged single-token decode attention over int8 KV pages, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel
// (reached through _paged_attention_pallas at paged_attention.py:178).
//
// Computes, for q (B, KV, G, hd) in bf16/f32 (one new token per sequence),
// attention over the first lengths[b] cached tokens of sequence b: pages
// (P, KV, ps, hd) int8 with per-token scales (P, KV, ps) f32 through the
// block table tables (B, max_pages) int32. Slots at or past
// ceil(lengths[b] / ps) are never read.
//
// What bounds it on this card: every cached byte is read once per step and
// each token costs 4 * G * hd operations, so it is bound by bytes (0.17 us
// at B 8, KV 2, up to 544 tokens of hd 64). Its time is launch latency plus
// the depth of the longest serial walk over one sequence's pages, so the
// design (paged_common.cuh) spreads each sequence over n_split blocks
// (grid B x KV x n_split, each split a fixed run of 64-token tiles loaded by
// cp.async into a double-buffered ring), computes only the G real query
// rows of a head in one 16-row tensor-core tile (one warp for G <= 16), and
// merges the splits' partials with a second, small kernel. A call launches
// one kernel when n_split is 1 and two otherwise.
#include "paged_common.cuh"

// q, out: (B, KV, G, hd); part: B * KV * n_split * G * (hd + 2) f32 when
// n_split > 1. Returns the first failing launch's cudaError_t, or 0.
extern "C" int paged_attention(const void* q, void* out, void* part, int bf16,
                               const void* kp, const void* vp, const void* ks,
                               const void* vs, const void* tables,
                               const void* lengths, int B, int max_pages,
                               int KV, int G, int hd, int ps, float sm_scale,
                               int n_split, int tiles_per_split,
                               void* stream) {
  paged::Args a;
  a.q = q;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.kp = static_cast<const int8_t*>(kp);
  a.vp = static_cast<const int8_t*>(vp);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.table_stride = max_pages;
  a.q_start = 0;
  a.KV = KV;
  a.rows = G;
  a.G = G;
  a.hd = hd;
  a.ps = ps;
  a.sm_scale = sm_scale;
  a.tiles_per_split = tiles_per_split;
  return paged::launch<paged::Decode>(a, bf16, B * KV, n_split,
                       static_cast<cudaStream_t>(stream));
}
