// Device code of the two paged-attention kernels over int8 KV pages: K2
// (chunked prefill, csrc/paged_prefill.cu) and K3 (single-token decode,
// csrc/paged_attention.cu). They replace the TPU kernels
// src/repro/kernels/paged_prefill.py::_prefill_kernel and
// src/repro/kernels/paged_attention.py::_paged_kernel.
//
// What it computes. The query rows of one kv head h of one sequence b are
// rows r = 0 .. rows - 1 (K2: rows = C * G, token r / G of the chunk; K3:
// rows = G). Row r sits at position pos0 + r / G (K2: pos0 = q_start; K3:
// pos0 = lengths[b] - 1) and sees every cached column col <= its position:
//   s[r, col] = (q[r] . (k_int8[col] * ks[col])) * sm_scale, masked -1e30
//   out[r]    = sum_col softmax(s[r])[col] * (v_int8[col] * vs[col])
// Pages (P, KV, ps, hd) int8 and per-token scales (P, KV, ps) f32 are
// reached through the block table, one token row at a time, so any page
// size works. No table slot at or past ceil(n_cols / ps) is read, where
// n_cols is the causal bound of the block's last row.
//
// What bounds it on the H100. K3 reads every cached byte once per step
// (hd int8 bytes of K and of V plus two 4-byte scales per token) and does
// 4 * G * hd operations per token: bound by bytes, 0.17 us at the serving
// shape (B 8, KV 2, up to 544 tokens), so its time is launch latency and
// the depth of the longest serial walk over the pages. K2 does 4 * C * G *
// hd operations per visible column against a few hundred KB of pages:
// bound by operations (0.59 us at C 256, q_start 512, bf16).
//
// What the design does about it. Blocks are (row tile, sequence x kv head,
// split) of 1-4 warps; each warp owns 16 query rows, so a decode head's
// G = 7 rows fill 7 of 16 MMA rows. Columns come in tiles of 64 tokens
// whose int8 K and V rows arrive by cp.async, 16 bytes a thread, with their
// per-token scales beside them, into a double-buffered ring in shared
// memory: the next tile loads while this one is computed, and pages stay
// int8 there. Tiles past the causal bound of a block's last row are never
// loaded.
//
// bf16 q (the serving path): both products on the tensor cores, mma.sync
// m16n8k16 with f32 accumulators. int8 is exact in bf16, so the conversion
// into the B fragment loses nothing, and the per-token scales stay outside
// the products: ks[col] * sm_scale multiplies the f32 scores, and w = p *
// vs[col] is the A operand of PV, in three bf16 parts (each the bf16
// rounding of what the earlier ones left). The tolerance against the
// plain version is one bf16 ULP + 1e-5, so at outputs near zero 1e-5 is
// all the slack: w in one part misses it (tests/test_torch_paged_split.py)
// and, on the H100, w in two parts missed it at hd 128 with G 8 and at hd
// 160 with C 256. Each product starts from a zeroed accumulator and is
// added to the running f32 sums on the CUDA cores: the tensor cores align
// an addition to its largest term and truncate, which would lose the low
// bits of every 16-term sum against a large running sum. The softmax is
// online, in registers, one quad of lanes per row, and the score
// accumulator of two 8-column tiles is the A fragment of PV, as in
// csrc/flash_attention.cu.
// A sequence's kv tiles are split over several blocks (split-KV): each
// writes (m, l, acc) in f32 to a scratch tensor and a second, small kernel
// merges them in log-sum-exp form (a second launch costs a few
// microseconds; merging in the last block to arrive would need counters
// zeroed before every call and memory fences). The wrapper picks the
// number of splits from the number of (row tile, head) units and the table
// width so that the card gets about four blocks per SM (chip_smoke.py
// times K2's serving chunk at 1 to 12 splits; PERF.md has the numbers).
//
// f32 q: CUDA cores, in the plain version's own order of operations. Its
// tolerance, 1e-5 + 1e-5 |out|, is about as far as f32 rounding in another
// order moves an output at large heads and long chunks (on the H100, a
// tensor-core form with q and w in three bf16 parts each missed it at hd
// 128 with G 8 and at hd 160, C 256). On the card the plain version's
// einsums are fused multiply-add chains in index order (measured: bitwise
// equal), so this path forms each score as that chain over d of q[d] *
// (k[d] * ks) and each output as that chain over the columns of p * (v *
// vs), with p = exp(s - max) / sum normalised first: a first pass over the
// tiles finds each row's max and sum, a second forms p and the output. One
// block walks the whole sequence (no split).
//
// Masked scores are -1e30 and the final division uses max(l, 1e-30), as
// the reference does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Everything here has internal linkage: the two kernel libraries include
// this header, and a template's function-local static shared between them
// (GCC makes it a unique global symbol) would let the second library skip
// its own cudaFuncSetAttribute.
namespace paged {
namespace {

// Tags that give K3's and K2's device kernels their own names (in a
// profiler trace the two are told apart by them).
struct Decode {};
struct Prefill {};

constexpr int BK = 64;           // kv tokens per tile
constexpr int MAX_WARPS = 4;     // 16 query rows each
constexpr float kNeg = -1e30f;

struct Args {
  const void* q;                 // (n_bh, rows, hd)
  void* out;                     // (n_bh, rows, hd), q's dtype
  float* part;                   // split partials; unused with one split
  const int8_t* kp;              // (P, KV, ps, hd)
  const int8_t* vp;
  const float* ks;               // (P, KV, ps)
  const float* vs;
  const int* tables;             // (n_bh / KV, table_stride)
  const int* lengths;            // (n_bh / KV,) for decode; null for prefill
  int table_stride, q_start, KV, rows, G, hd, ps;
  float sm_scale;
  int tiles_per_split;
};

// ---------------------------------------------------------------------------
// Small device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two int8 values as a bf16 pair (exact).
__device__ __forceinline__ uint32_t i8_pair(int lo, int hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// Two adjacent int8 values in shared memory as a bf16 pair.
__device__ __forceinline__ uint32_t ld_i8x2(const int8_t* p) {
  const int16_t v = *reinterpret_cast<const int16_t*>(p);
  return i8_pair(static_cast<int8_t>(v & 0xff), v >> 8);
}

// (x0, x1) as three bf16 pairs, each the bf16 rounding of what the earlier
// ones left (the remainders are exact in f32): p[0] + p[1] + p[2] holds
// the pair to about 24 bits.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    p[i] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    x0 -= f.x;
    x1 -= f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Shared memory: the block's q rows [16 nw][DP + 8] (and, for f32, their
// probabilities [16 nw][BK + 1]), then two tile buffers, each K [BK][DP +
// 16] int8, V [BK][DP + 16] int8, ks [BK] f32, vs [BK] f32. The row pads
// make the fragment loads conflict-free and keep every row 16-byte aligned
// for cp.async.
// ---------------------------------------------------------------------------
template <int DP>
__host__ __device__ constexpr int tile_bytes() {
  return 2 * BK * (DP + 16) + 2 * BK * 4;
}

template <int DP>
__host__ __device__ constexpr size_t smem_bf16(int nw) {
  return (size_t)16 * nw * (DP + 8) * 2 + 2 * (size_t)tile_bytes<DP>();
}

template <int DP>
__host__ __device__ constexpr size_t smem_f32(int nw) {
  return (size_t)16 * nw * ((DP + 8) + (BK + 1)) * 4 +
         2 * (size_t)tile_bytes<DP>();
}

template <int DP>
struct Tile {
  const int8_t* K;
  const int8_t* V;
  const float* ks;
  const float* vs;
  __device__ explicit Tile(const unsigned char* buf)
      : K(reinterpret_cast<const int8_t*>(buf)),
        V(K + BK * (DP + 16)),
        ks(reinterpret_cast<const float*>(V + BK * (DP + 16))),
        vs(ks + BK) {}
};

// Where a block sits: its (sequence, kv head), rows and causal bound.
struct Geometry {
  int bh, b, h, r0, n_real, pos0, n_cols, n_tiles;
  const int* table;
  __device__ Geometry(const Args& a, int nw) {
    bh = blockIdx.y;
    b = bh / a.KV;
    h = bh % a.KV;
    r0 = blockIdx.x * 16 * nw;
    n_real = min(a.rows - r0, 16 * nw);
    pos0 = a.lengths ? a.lengths[b] - 1 : a.q_start;
    n_cols = pos0 + (r0 + n_real - 1) / a.G + 1;
    n_tiles = (n_cols + BK - 1) / BK;
    table = a.tables + (long)b * a.table_stride;
  }
  // the last column that row r (of the sequence's rows) sees
  __device__ int limit(const Args& a, int r) const {
    return pos0 + min(r, a.rows - 1) / a.G;
  }
};

// Start the copies of kv tile tok0 .. tok0 + BK - 1 into one buffer.
// Columns at or past n_cols are not read: their scales are zeroed, so their
// (masked) probabilities times vs add nothing, and their K/V bytes (stale
// int8, finite) meet only zeros.
template <int DP>
__device__ __forceinline__ void load_tile(unsigned char* buf, const Args& a,
                                          const Geometry& geo, int tok0) {
  constexpr int KS = DP + 16, CH = DP / 16;
  int8_t* Kb = reinterpret_cast<int8_t*>(buf);
  int8_t* Vb = Kb + BK * KS;
  float* ksb = reinterpret_cast<float*>(Vb + BK * KS);
  float* vsb = ksb + BK;
  const int hd_ch = a.hd / 16;
  for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH, col = tok0 + t;
    if (c >= hd_ch || col >= geo.n_cols) continue;
    const long row =
        ((long)geo.table[col / a.ps] * a.KV + geo.h) * a.ps + col % a.ps;
    cp_async16(Kb + t * KS + c * 16, a.kp + row * a.hd + c * 16);
    cp_async16(Vb + t * KS + c * 16, a.vp + row * a.hd + c * 16);
  }
  for (int t = threadIdx.x; t < BK; t += blockDim.x) {
    const int col = tok0 + t;
    if (col < geo.n_cols) {
      const long row =
          ((long)geo.table[col / a.ps] * a.KV + geo.h) * a.ps + col % a.ps;
      cp_async4(ksb + t, a.ks + row);
      cp_async4(vsb + t, a.vs + row);
    } else {
      ksb[t] = 0.f;
      vsb[t] = 0.f;
    }
  }
}

// Walk kv tiles j0 .. j1 - 1 (j0 < j1) through the two buffers: body(tile,
// tok0) runs when tile j has landed for the whole block, while tile j + 1
// loads.
template <int DP, class Body>
__device__ __forceinline__ void walk_tiles(unsigned char* bufs, const Args& a,
                                           const Geometry& geo, int j0,
                                           int j1, Body&& body) {
  constexpr int TB = tile_bytes<DP>();
  load_tile<DP>(bufs, a, geo, j0 * BK);
  cp_async_commit();
  for (int j = j0; j < j1; ++j) {
    if (j + 1 < j1)
      load_tile<DP>(bufs + ((j + 1 - j0) & 1) * TB, a, geo, (j + 1) * BK);
    cp_async_commit();
    cp_async_wait_1();            // tile j has landed (this thread's copies)
    __syncthreads();              // ... and everyone's
    body(Tile<DP>(bufs + ((j - j0) & 1) * TB), j * BK);
    __syncthreads();              // this buffer is refilled next iteration
  }
}

// Each warp stages its 16 q rows; columns past hd and rows past the last
// are zero.
template <typename T, int DP>
__device__ __forceinline__ void stage_q(T* Qs, const Args& a,
                                        const Geometry& geo, int warp,
                                        int lane) {
  constexpr int QST = DP + 8, E = 16 / sizeof(T), CH = DP / E;
  const T* q = static_cast<const T*>(a.q) +
               ((long)geo.bh * a.rows + geo.r0) * a.hd;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = warp * 16 + i / CH, c = (i % CH) * E;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < geo.n_real && c < a.hd)
      x = *reinterpret_cast<const uint4*>(q + (long)r * a.hd + c);
    *reinterpret_cast<uint4*>(Qs + r * QST + c) = x;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores, split-KV. Fragment layout of mma.m16n8k16 (g =
// lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8):             c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// ---------------------------------------------------------------------------
template <class Mode, int DP>
__global__ void __launch_bounds__(32 * MAX_WARPS)
attend_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int QST = DP + 8, KS = DP + 16;
  const int nw = blockDim.x / 32;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* bufs = smem + (size_t)16 * nw * QST * 2;
  const Geometry geo(a, nw);
  const int j0 = blockIdx.z * a.tiles_per_split;
  const int j1 = min(geo.n_tiles, j0 + a.tiles_per_split);
  const int n_split = gridDim.z;
  const long part_row0 = ((long)geo.bh * n_split + blockIdx.z) * a.rows;
  float* pacc = a.part + part_row0 * a.hd;
  float* pml = a.part + (long)gridDim.y * n_split * a.rows * a.hd +
               part_row0 * 2;

  if (j0 >= j1) {                 // a split past the bound: empty partial
    for (int i = threadIdx.x; i < geo.n_real * a.hd; i += blockDim.x)
      pacc[(long)geo.r0 * a.hd + i] = 0.f;
    for (int r = threadIdx.x; r < geo.n_real; r += blockDim.x) {
      pml[(geo.r0 + r) * 2] = kNeg;
      pml[(geo.r0 + r) * 2 + 1] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage_q<__nv_bfloat16, DP>(Qs, a, geo, warp, lane);
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16 + g;                    // row in the block
  const int r_lo = geo.r0 + wr, r_hi = r_lo + 8;   // rows of the sequence
  const int lim_lo = geo.limit(a, r_lo), lim_hi = geo.limit(a, r_hi);

  float o[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_lo = kNeg, m_hi = kNeg;
  float l_lo = 0.f, l_hi = 0.f;                    // l: this lane's share

  walk_tiles<DP>(bufs, a, geo, j0, j1, [&](const Tile<DP>& tl, int tok0) {
    // scores: q . k_int8 on the tensor cores
    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      if (kc * 16 >= a.hd) break;
      const __nv_bfloat16* ql = Qs + wr * QST + kc * 16 + 2 * t;
      const __nv_bfloat16* qh = ql + 8 * QST;
      const uint32_t qa[4] = {*reinterpret_cast<const uint32_t*>(ql),
                              *reinterpret_cast<const uint32_t*>(qh),
                              *reinterpret_cast<const uint32_t*>(ql + 8),
                              *reinterpret_cast<const uint32_t*>(qh + 8)};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const int8_t* kr = tl.K + (nt * 8 + g) * KS + kc * 16 + 2 * t;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, qa, ld_i8x2(kr), ld_i8x2(kr + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] += d[e];
      }
    }

    // scale, mask, online softmax (the four lanes of a quad hold a row)
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = nt * 8 + 2 * t + e, col = tok0 + cl;
        const float k_s = tl.ks[cl];
        float s_lo = (sc[nt][e] * k_s) * a.sm_scale;
        float s_hi = (sc[nt][2 + e] * k_s) * a.sm_scale;
        if (col > lim_lo) s_lo = kNeg;
        if (col > lim_hi) s_hi = kNeg;
        sc[nt][e] = s_lo;
        sc[nt][2 + e] = s_hi;
        mx_lo = fmaxf(mx_lo, s_lo);
        mx_hi = fmaxf(mx_hi, s_hi);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p_lo = expf(sc[nt][e] - mn_lo);
        const float p_hi = expf(sc[nt][2 + e] - mn_hi);
        sum_lo += p_lo;
        sum_hi += p_hi;
        const float v_s = tl.vs[nt * 8 + 2 * t + e];
        sc[nt][e] = p_lo * v_s;          // from here on: w = p * vs
        sc[nt][2 + e] = p_hi * v_s;
      }
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      o[dt][0] *= corr_lo;
      o[dt][1] *= corr_lo;
      o[dt][2] *= corr_hi;
      o[dt][3] *= corr_hi;
    }

    // PV: w in three bf16 parts times v_int8; the score accumulator of
    // n-tiles 2 kc and 2 kc + 1 is the A fragment of tokens 16 kc ..
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4][3];
      split3(sc[2 * kc][0], sc[2 * kc][1], pa[0]);
      split3(sc[2 * kc][2], sc[2 * kc][3], pa[1]);
      split3(sc[2 * kc + 1][0], sc[2 * kc + 1][1], pa[2]);
      split3(sc[2 * kc + 1][2], sc[2 * kc + 1][3], pa[3]);
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        if (dt * 8 >= a.hd) break;
        const int8_t* vc = tl.V + (kc * 16 + 2 * t) * KS + dt * 8 + g;
        const uint32_t b0 = i8_pair(vc[0], vc[KS]);
        const uint32_t b1 = i8_pair(vc[8 * KS], vc[9 * KS]);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 2; i >= 0; --i) {   // the smallest part first
          const uint32_t a4[4] = {pa[0][i], pa[1][i], pa[2][i], pa[3][i]};
          mma_bf16(d, a4, b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] += d[e];
      }
    }
  });

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, w);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, w);
  }
  const bool in_lo = r_lo < a.rows && wr < geo.n_real;
  const bool in_hi = r_hi < a.rows && wr + 8 < geo.n_real;
  if (n_split == 1) {
    __nv_bfloat16* out =
        static_cast<__nv_bfloat16*>(a.out) + (long)geo.bh * a.rows * a.hd;
    const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c >= a.hd) break;
      if (in_lo)
        *reinterpret_cast<uint32_t*>(out + (long)r_lo * a.hd + c) =
            pack_bf16(o[dt][0] / d_lo, o[dt][1] / d_lo);
      if (in_hi)
        *reinterpret_cast<uint32_t*>(out + (long)r_hi * a.hd + c) =
            pack_bf16(o[dt][2] / d_hi, o[dt][3] / d_hi);
    }
    return;
  }
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c >= a.hd) break;
    if (in_lo)
      *reinterpret_cast<float2*>(pacc + (long)r_lo * a.hd + c) =
          make_float2(o[dt][0], o[dt][1]);
    if (in_hi)
      *reinterpret_cast<float2*>(pacc + (long)r_hi * a.hd + c) =
          make_float2(o[dt][2], o[dt][3]);
  }
  if (t == 0) {
    if (in_lo)
      *reinterpret_cast<float2*>(pml + r_lo * 2) = make_float2(m_lo, l_lo);
    if (in_hi)
      *reinterpret_cast<float2*>(pml + r_hi * 2) = make_float2(m_hi, l_hi);
  }
}

// Merge the splits' partials in log-sum-exp form: one warp per (sequence x
// kv head, row), lanes over pairs of columns.
template <class Mode>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
               int n_bh, int n_split, int rows, int hd) {
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (wid >= n_bh * rows) return;
  const int bh = wid / rows, r = wid % rows;
  const long first = (long)bh * n_split * rows + r;     // split 0's row
  const float* acc = part + first * hd;
  const float* ml = part + (long)n_bh * n_split * rows * hd + first * 2;
  const long step = (long)rows;                          // rows per split
  float mx = kNeg;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[s * step * 2]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s)
    l += expf(ml[s * step * 2] - mx) * ml[s * step * 2 + 1];
  const float den = fmaxf(l, 1e-30f);
  for (int c = 2 * lane; c < hd; c += 64) {
    float x0 = 0.f, x1 = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(ml[s * step * 2] - mx);
      const float2 v =
          *reinterpret_cast<const float2*>(acc + s * step * hd + c);
      x0 += w * v.x;
      x1 += w * v.y;
    }
    *reinterpret_cast<uint32_t*>(out + ((long)bh * rows + r) * hd + c) =
        pack_bf16(x0 / den, x1 / den);
  }
}

// ---------------------------------------------------------------------------
// f32 q: CUDA cores, the plain version's order of operations, one split.
// Lane (row = lane % 16, half = lane / 16) of a warp forms the scores of its
// row in half of a tile's 64 columns, and half of its row's outputs.
// ---------------------------------------------------------------------------
template <class Mode, int DP>
__global__ void __launch_bounds__(32 * MAX_WARPS)
attend_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int QST = DP + 8, KS = DP + 16, PST = BK + 1, HALF = DP / 2;
  const int nw = blockDim.x / 32;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + 16 * nw * QST;                  // [16 nw][BK + 1]
  unsigned char* bufs = reinterpret_cast<unsigned char*>(Ps + 16 * nw * PST);
  const Geometry geo(a, nw);
  const int j1 = min(geo.n_tiles, a.tiles_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage_q<float, DP>(Qs, a, geo, warp, lane);
  const int wr = warp * 16 + lane % 16, half = lane / 16;
  const int lim = geo.limit(a, geo.r0 + wr);
  const float* qrow = Qs + wr * QST;
  const int c0 = half * 32;

  // this lane's 32 scores of a tile: fmaf(q[d], k[d] * ks, s) for d = 0 ..
  // hd - 1, times sm_scale; -1e30 past the row's bound
  auto scores = [&](const Tile<DP>& tl, int tok0, float (&s)[32]) {
#pragma unroll
    for (int c = 0; c < 32; ++c) s[c] = 0.f;
    for (int d = 0; d < a.hd; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const char4 k =
            *reinterpret_cast<const char4*>(tl.K + (c0 + c) * KS + d);
        const float k_s = tl.ks[c0 + c];
        s[c] = fmaf(qv.x, __fmul_rn(static_cast<float>(k.x), k_s), s[c]);
        s[c] = fmaf(qv.y, __fmul_rn(static_cast<float>(k.y), k_s), s[c]);
        s[c] = fmaf(qv.z, __fmul_rn(static_cast<float>(k.z), k_s), s[c]);
        s[c] = fmaf(qv.w, __fmul_rn(static_cast<float>(k.w), k_s), s[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 32; ++c)
      s[c] = tok0 + c0 + c > lim ? kNeg : __fmul_rn(s[c], a.sm_scale);
  };

  // pass 1: the row's max and sum of exp(s - max), the halves merged
  float m = kNeg, l = 0.f;
  walk_tiles<DP>(bufs, a, geo, 0, j1, [&](const Tile<DP>& tl, int tok0) {
    float s[32];
    scores(tl, tok0, s);
    float mx = m;
#pragma unroll
    for (int c = 0; c < 32; ++c) mx = fmaxf(mx, s[c]);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) sum += expf(s[c] - mx);
    l = l * expf(m - mx) + sum;
    m = mx;
  });
  const float m_o = __shfl_xor_sync(0xffffffffu, m, 16);
  const float l_o = __shfl_xor_sync(0xffffffffu, l, 16);
  const float mx = fmaxf(m, m_o);
  const float den = fmaxf(l * expf(m - mx) + l_o * expf(m_o - mx), 1e-30f);

  // pass 2: p = exp(s - max) / sum, then out = fmaf(p, v * vs, out) over the
  // columns in order
  float o[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) o[i] = 0.f;
  float* prow = Ps + wr * PST;
  walk_tiles<DP>(bufs, a, geo, 0, j1, [&](const Tile<DP>& tl, int tok0) {
    float s[32];
    scores(tl, tok0, s);
#pragma unroll
    for (int c = 0; c < 32; ++c) prow[c0 + c] = expf(s[c] - mx) / den;
    __syncwarp();
    for (int t = 0; t < BK; ++t) {
      const float p = prow[t], v_s = tl.vs[t];
      const int8_t* vr = tl.V + t * KS + half * HALF;
#pragma unroll
      for (int i = 0; i < HALF; i += 4) {
        if (half * HALF + i >= a.hd) break;
        const char4 v = *reinterpret_cast<const char4*>(vr + i);
        o[i] = fmaf(p, __fmul_rn(static_cast<float>(v.x), v_s), o[i]);
        o[i + 1] = fmaf(p, __fmul_rn(static_cast<float>(v.y), v_s), o[i + 1]);
        o[i + 2] = fmaf(p, __fmul_rn(static_cast<float>(v.z), v_s), o[i + 2]);
        o[i + 3] = fmaf(p, __fmul_rn(static_cast<float>(v.w), v_s), o[i + 3]);
      }
    }
    __syncwarp();                 // prow is rewritten by the next tile
  });

  const int r = geo.r0 + wr;
  if (r >= a.rows || wr >= geo.n_real) return;
  float* out = static_cast<float*>(a.out) + ((long)geo.bh * a.rows + r) * a.hd;
#pragma unroll
  for (int i = 0; i < HALF; i += 4) {
    const int d = half * HALF + i;
    if (d >= a.hd) break;
    *reinterpret_cast<float4*>(out + d) =
        make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
  }
}

// ---------------------------------------------------------------------------
// Host side: pick the build for hd, opt in to the shared memory, launch.
// ---------------------------------------------------------------------------
template <class Mode, int DP>
int launch_bf16(const Args& a, int n_bh, int n_split, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      attend_bf16_kernel<Mode, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bf16<DP>(MAX_WARPS));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int nw = min(MAX_WARPS, (a.rows + 15) / 16);
  const dim3 grid((a.rows + 16 * nw - 1) / (16 * nw), n_bh, n_split);
  attend_bf16_kernel<Mode, DP>
      <<<grid, 32 * nw, smem_bf16<DP>(nw), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const long warps = (long)n_bh * a.rows;
  combine_kernel<Mode><<<(unsigned)((warps + 3) / 4), 128, 0, stream>>>(
      a.part, static_cast<__nv_bfloat16*>(a.out), n_bh, n_split, a.rows,
      a.hd);
  return static_cast<int>(cudaGetLastError());
}

template <class Mode, int DP>
int launch_f32(const Args& a, int n_bh, int n_split, cudaStream_t stream) {
  if (n_split != 1) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      attend_f32_kernel<Mode, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_f32<DP>(MAX_WARPS));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int nw = min(MAX_WARPS, (a.rows + 15) / 16);
  const dim3 grid((a.rows + 16 * nw - 1) / (16 * nw), n_bh, 1);
  attend_f32_kernel<Mode, DP><<<grid, 32 * nw, smem_f32<DP>(nw), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Builds for padded head dims 16, 32, 64, 128, 160 and 256: an hd between
// two of them (a multiple of 16) takes the next one up, its extra q columns
// zero. q in bf16 (bf16 != 0) or f32; f32 takes one split.
template <class Mode>
int launch(const Args& a, int bf16, int n_bh, int n_split, cudaStream_t s) {
  if (a.hd % 16 || a.hd < 16 || a.hd > 256 || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return bf16 ? launch_bf16<Mode, DP>(a, n_bh, n_split, s)
                : launch_f32<Mode, DP>(a, n_bh, n_split, s);
  };
  if (a.hd <= 16) return go(std::integral_constant<int, 16>());
  if (a.hd <= 32) return go(std::integral_constant<int, 32>());
  if (a.hd <= 64) return go(std::integral_constant<int, 64>());
  if (a.hd <= 128) return go(std::integral_constant<int, 128>());
  if (a.hd <= 160) return go(std::integral_constant<int, 160>());
  return go(std::integral_constant<int, 256>());
}

}  // namespace
}  // namespace paged
