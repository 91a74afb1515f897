// K8: dense flash attention (causal or not, online softmax) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (reached through the pallas_call at flash_attention.py:88).
//
// Computes, for q, k, v (BH, S, D) contiguous, D a multiple of 8 up to 256:
// scores = (q . k) in f32 times D^-0.5; causal: column c visible from row r
// when r >= c, masked scores -1e30 (bf16 path: -inf in the exponent, which
// gives the same zero weight); an online softmax with m, l and acc in f32;
// p rounded to v's dtype before the PV product; out = acc / max(l, 1e-30)
// in q's dtype. Head dims are built for 16, 32, 64, 128, 160 and 256; a D
// in between takes the next build up with its columns zero-filled. A ragged
// last tile is zero-filled and masked: its columns score -1e30 and its rows
// are not stored.
//
// What bounds it on this card: at the long-prefill shapes (S = 4,096 to
// 32,768, D = 64 to 160) the work is 4 * BH * S^2 * D operations (half
// that causal) against 4 * BH * S * D values of traffic, thousands of
// operations a byte: it is bound by operations, and only wgmma reaches the
// tensor cores' bf16 rate. The f32 path runs on the CUDA cores (TF32 would
// not hold the reference's 2e-5), with the tiles in shared memory.
//
// bf16 design. One block of two warpgroups per (head, 128-row query tile),
// each warpgroup 64 query rows; tiles are issued heaviest first (the last
// tile of a causal run does the most work), so the tail of the grid is
// short. Q, and K and V in tiles of BK rows (128 at hd 128 and 160, else
// 64), sit in dynamic shared memory in the swizzled panels wgmma reads
// (csrc/hopper.cuh), written there by TMA, which also zero-fills rows past
// S and columns past D. K and V each have a ring of two stages with an
// mbarrier pair a stage (landed; released by all eight warps). One thread
// of the second warpgroup issues the loads, a tile as soon as both
// warpgroups have released the stage's previous one, so a tile's copy runs
// a full tile ahead of its use. Per warpgroup and kv tile j:
// * wgmma issues tile j + 1's QK^T (m64nBKk16, Q and K K-major in shared
//   memory) and tile j's PV (m64nDPk16, A from registers: the f32 score
//   accumulator rounded to bf16 pairs is the A fragment element for
//   element, so p never leaves the registers; V read MN-major from shared
//   memory, never transposed by hand);
// * while both run, the softmax of tile j + 1 in registers, one quad of
//   lanes per row: exp2 with D^-0.5 log2(e) folded into one FMA, the
//   causal and bounds masks only on tiles that cross the diagonal or the
//   ragged end;
// * then the output is rescaled by the new running max.
// Up to hd 64 the two warpgroups take turns issuing (named barriers), so
// one's softmax overlaps the other's products; 122 registers a thread there
// leave room for two blocks an SM. The kv loop stops at the causal bound of
// the block's last row, so tiles wholly above the diagonal are never
// loaded; the first tile holds column 0, so no row sees only masked scores.
// Tried on the H100 and not kept, each slower or spilling: a producer warp
// beside the two warpgroups (288 threads are allocated registers as 384,
// so each thread gets 168 and hd 64 and 256 spill; setmaxnreg did not lift
// ptxas's allocation), 128-row kv tiles at hd 64 (one block an SM instead
// of two), rings of three or four stages, and cp.async copies by every
// thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: wgmma. Two warpgroups, 64 query rows each.
// ---------------------------------------------------------------------------
constexpr int BQ = 128;          // query rows per block
constexpr int BF_THREADS = 256;  // two warpgroups

template <int DP>
struct Bf16Build {
  // kv rows a tile: 128 where the score and output accumulators fit the
  // registers together and a block has the SM to itself (hd 128, 160);
  // 64 at hd 256 (registers) and up to hd 64 (two blocks an SM)
  static constexpr int BK = DP == 128 || DP == 160 ? 128 : 64;
  // panel width in bytes: the widest swizzle that divides a row
  static constexpr int SW = DP % 64 == 0 ? 128 : DP % 32 == 0 ? 64 : 32;
  static constexpr int PW = SW / 2;                       // columns a panel
  // Up to hd 64 the two warpgroups take turns at the tensor cores, so that
  // one's softmax runs while the other's products do (above hd 64 the
  // products outlast the softmax, and taking turns did not help on the
  // H100).
  static constexpr bool PING_PONG = DP <= 64;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  // 1024 bytes to align the base, Q, two K stages, two V stages, and nine
  // mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 128;
};

// The TMA tensor maps of q (boxes of 128 rows) and of k and v (BK rows),
// each in panels of SW bytes.
struct Maps {
  CUtensorMap q, k, v;
};

// Two floats rounded to bf16, the first in the low half (the fragment
// element with the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(BF_THREADS, 1)
flash_bf16_kernel(const __grid_constant__ Maps maps,
                  __nv_bfloat16* __restrict__ out, int S, int D, int causal,
                  float scale_log2) {
  using B = Bf16Build<DP>;
  constexpr int BK = B::BK, SW = B::SW, PW = B::PW;
  extern __shared__ uint8_t smem_bf16[];
  const uint32_t sq = (hopper::smem_u32(smem_bf16) + 1023) & ~1023u;
  const uint32_t sk0 = sq + B::Q_BYTES;
  const uint32_t sv0 = sk0 + 2 * B::KV_BYTES;
  const uint32_t bars = sv0 + 2 * B::KV_BYTES;
  auto k_stage = [&](int j) { return sk0 + (j & 1) * B::KV_BYTES; };
  auto v_stage = [&](int j) { return sv0 + (j & 1) * B::KV_BYTES; };
  // q landed; K / V stage j & 1 landed (full) or released (empty)
  const uint32_t q_full = bars;
  auto k_full = [&](int j) { return bars + 8 + 8 * (j & 1); };
  auto k_empty = [&](int j) { return bars + 24 + 8 * (j & 1); };
  auto v_full = [&](int j) { return bars + 40 + 8 * (j & 1); };
  auto v_empty = [&](int j) { return bars + 56 + 8 * (j & 1); };
  // the parity of tile j's use of its stage
  auto phase = [](int j) { return static_cast<uint32_t>((j >> 1) & 1); };

  const int tile = gridDim.y - 1 - blockIdx.y;    // heaviest tiles first
  const int q0 = tile * BQ;
  const int bh = blockIdx.x;
  const int last_row = min(q0 + BQ, S) - 1;
  const int n = causal ? last_row / BK + 1 : (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(k_full(i), 1);
      hopper::mbar_init(v_full(i), 1);
      hopper::mbar_init(k_empty(i), 8);          // one arrival a warp
      hopper::mbar_init(v_empty(i), 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // Warpgroup wg takes query rows row0 .. row0 + 63.
  const long base = (long)bh * S * D;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + wg * 64;
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  auto release = [&](uint32_t bar) {
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // The loads, issued by one thread of the second warpgroup (which, taking
  // turns, runs behind the first): tile j's K or V once both warpgroups
  // have released the stage's previous tile, j - 2.
  const bool issuer = threadIdx.x == 128;
  auto load = [&](const CUtensorMap* map, uint32_t stage, uint32_t full,
                  uint32_t empty, int j) {
    if (j >= 2) hopper::mbar_wait(empty, phase(j - 2));
    hopper::mbar_expect_tx(full, B::KV_BYTES);
    for (int p = 0; p < DP / PW; ++p)
      hopper::tma_load_3d(stage + p * BK * SW, map, full, p * PW, j * BK, bh);
  };
  auto load_k = [&](int j) {
    if (issuer && j < n) load(&maps.k, k_stage(j), k_full(j), k_empty(j), j);
  };
  auto load_v = [&](int j) {
    if (issuer && j < n) load(&maps.v, v_stage(j), v_full(j), v_empty(j), j);
  };
  if (issuer) {
    hopper::mbar_expect_tx(q_full, B::Q_BYTES);
    for (int p = 0; p < DP / PW; ++p)
      hopper::tma_load_3d(sq + p * BQ * SW, &maps.q, q_full, p * PW, q0, bh);
  }
  load_k(0);
  load_v(0);
  load_k(1);
  load_v(1);

  auto qk = [&](float (&s)[BK / 2], uint32_t kt) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hopper::wgmma_ss(s, hopper::desc_k_major<SW>(sq, BQ, wg * 64, kk),
                       hopper::desc_k_major<SW>(kt, BK, 0, kk), kk > 0);
    hopper::wgmma_commit();
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  uint32_t p0[BK / 16][4], p1[BK / 16][4];       // p of two tiles, as bf16
  // m in units of log2 (the scaled score times log2(e)); l: this thread's
  // share of the row sum
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  float corr_lo = 1.f, corr_hi = 1.f;

  // Tile j's scores in sc → its p as bf16 pairs (the A fragment of PV),
  // the running max and sum, and the factor corr that rescales the
  // output accumulated so far.
  auto softmax = [&](uint32_t (&p)[BK / 16][4], int j) {
    const int k0 = j * BK;
    if ((causal && k0 + BK - 1 > row0) || k0 + BK > S) {
#pragma unroll
      for (int jn = 0; jn < BK / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + jn * 8 + 2 * t + e;
          if (col >= S || (causal && col > r_lo))
            sc[4 * jn + e] = -CUDART_INF_F;
          if (col >= S || (causal && col > r_hi))
            sc[4 * jn + 2 + e] = -CUDART_INF_F;
        }
      }
    }
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
    }
    // the four lanes of a quad hold one row between them
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    corr_lo = hopper::exp2_approx(m_lo - mn_lo);
    corr_hi = hopper::exp2_approx(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * jn + e] =
            hopper::exp2_approx(fmaf(sc[4 * jn + e], scale_log2, -mn_lo));
        sc[4 * jn + 2 + e] =
            hopper::exp2_approx(fmaf(sc[4 * jn + 2 + e], scale_log2, -mn_hi));
        sum_lo += sc[4 * jn + e];
        sum_hi += sc[4 * jn + 2 + e];
      }
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      p[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
      p[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
      p[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
      p[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
    }
  };

  // One kv tile j, whose p is in pc: issue the next tile's QK^T and this
  // tile's PV, run the next tile's softmax (into pn) while they compute,
  // then rescale the output.
  auto step = [&](uint32_t (&pc)[BK / 16][4], uint32_t (&pn)[BK / 16][4],
                  int j) {
    if (j + 1 < n) hopper::mbar_wait(k_full(j + 1), phase(j + 1));
    hopper::mbar_wait(v_full(j), phase(j));
    if (B::PING_PONG) hopper::bar_sync(1 + wg, 256);   // this warpgroup's turn
    hopper::wgmma_fence();
    if (j + 1 < n) qk(sc, k_stage(j + 1));
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
      hopper::wgmma_rs(o, pc[kc],
                       hopper::desc_mn_major<SW>(v_stage(j), BK, kc), 1);
    hopper::wgmma_commit();
    // the other warpgroup's turn (the second one's last turn is not needed)
    if (B::PING_PONG && (wg == 0 || j + 1 < n)) hopper::bar_arrive(2 - wg, 256);
    if (j + 1 < n) {
      hopper::wgmma_wait<1>();       // the next tile's QK^T
      hopper::fence_regs(sc);
      release(k_empty(j + 1));
      softmax(pn, j + 1);
    }
    hopper::wgmma_wait<0>();         // this tile's PV
    hopper::fence_regs(o);
    release(v_empty(j));
    load_k(j + 3);
    load_v(j + 2);
    if (j + 1 < n) {
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= corr_lo;
        o[4 * i + 1] *= corr_lo;
        o[4 * i + 2] *= corr_hi;
        o[4 * i + 3] *= corr_hi;
      }
    }
  };

  // tile 0's scores and p
  hopper::mbar_wait(q_full, 0);
  hopper::mbar_wait(k_full(0), 0);
  hopper::wgmma_fence();
  qk(sc, k_stage(0));
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  release(k_empty(0));
  load_k(2);
  softmax(p0, 0);
  if (B::PING_PONG && wg == 1) hopper::bar_arrive(1, 256);  // the first turn
  for (int j = 0; j < n; j += 2) {
    step(p0, p1, j);
    if (j + 1 < n) step(p1, p0, j + 1);
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, w);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, w);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (c >= D) continue;
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(out + base + (long)r_lo * D + c) =
          pack_bf16(o[4 * i] / d_lo, o[4 * i + 1] / d_lo);
    if (r_hi < S)
      *reinterpret_cast<uint32_t*>(out + base + (long)r_hi * D + c) =
          pack_bf16(o[4 * i + 2] / d_hi, o[4 * i + 3] / d_hi);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. 256 threads as 16 x 16; thread (ty, tx) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 c (c < DP / 16). The 16 threads of one ty are one half-warp.
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // kv rows per staged tile

constexpr int F_THREADS = 256;

__host__ __device__ constexpr size_t f32_smem_floats(int dp) {
  return (size_t)(BQ + BK) * (dp + 1) + (size_t)BK * dp + (size_t)BQ * (BK + 1);
}

template <int DP>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int D, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int QST = DP + 1, PST = BK + 1;
  float* Qs = smem;                  // [BQ][DP + 1]
  float* Ks = Qs + BQ * QST;         // [BK][DP + 1]
  float* Vs = Ks + BK * QST;         // [BK][DP]
  float* Ps = Vs + BK * DP;          // [BQ][BK + 1]

  const int tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = tile * BQ;
  const long base = (long)blockIdx.x * S * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int i = threadIdx.x; i < BQ * DP; i += F_THREADS) {
    const int r = i / DP, d = i % DP;
    Qs[r * QST + d] = (q0 + r < S && d < D) ? q[base + (long)(q0 + r) * D + d] : 0.f;
  }
  float acc[4][DP / 16];
  float m[4], l[4];                  // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] = 0.f;
  }

  const int last_row = min(q0 + BQ, S) - 1;
  const int n_tiles = causal ? last_row / BK + 1 : (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * DP; i += F_THREADS) {
      const int r = i / DP, d = i % DP;
      const bool in = k0 + r < S && d < D;
      const long src = base + (long)(k0 + r) * D + d;
      Ks[r * QST + d] = in ? k[src] : 0.f;
      Vs[r * DP + d] = in ? v[src] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QST + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * QST + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx + 16 * jj;
        float x = s[i][jj] * scale;
        if (col >= S || (causal && row < col)) x = kNeg;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w <= 8; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - mn);
        Ps[(ty + 16 * i) * PST + tx + 16 * jj] = p;
        sum += p;
      }
      l[i] = l[i] * corr[i] + sum;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) acc[i][c] *= corr[i];
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PST + kk];
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        const float vv = Vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w <= 8; w <<= 1) li += __shfl_xor_sync(0xffffffffu, li, w);
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(li, 1e-30f);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[base + (long)row * D + col] = acc[i][c] / den;
    }
  }
}

}  // namespace f32

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bf16,
           int BH, int S, int D, int causal, float scale, cudaStream_t stream) {
  if (bf16) {
    using B = Bf16Build<DP>;
    Maps maps;
    const int rc[3] = {
        hopper::encode_tma_3d_bf16(&maps.q, q, D, S, BH, B::PW, BQ, B::SW),
        hopper::encode_tma_3d_bf16(&maps.k, k, D, S, BH, B::PW, B::BK, B::SW),
        hopper::encode_tma_3d_bf16(&maps.v, v, D, S, BH, B::PW, B::BK, B::SW)};
    for (int e : rc)
      if (e != 0) return e;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        B::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bf16_kernel<DP><<<dim3(BH, (S + BQ - 1) / BQ), BF_THREADS, B::SMEM,
                            stream>>>(maps, static_cast<__nv_bfloat16*>(out),
                                      S, D, causal, scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = f32::f32_smem_floats(DP) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        f32::flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  f32::flash_f32_kernel<DP><<<dim3(BH, (S + f32::BQ - 1) / f32::BQ),
                              f32::F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, D, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int smem_bytes(int bf16) {
  return bf16 ? Bf16Build<DP>::SMEM
              : static_cast<int>(f32::f32_smem_floats(DP) * sizeof(float));
}

}  // namespace

// q, k, v, out: (BH, S, D) contiguous, 16-byte aligned, bf16 (bf16 != 0) or
// f32; D a multiple of 8, at most 256. Returns the launch's cudaError_t, or
// the CUresult of a tensor map that could not be encoded.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bf16, int BH, int S, int D,
                               int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  if (D <= 32) return launch<32>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  if (D <= 64) return launch<64>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  if (D <= 128)
    return launch<128>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  if (D <= 160)
    return launch<160>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  return launch<256>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
}

// Dynamic shared memory, in bytes, of one block of the build that takes D.
extern "C" int flash_attention_smem(int bf16, int D) {
  if (D <= 16) return smem_bytes<16>(bf16);
  if (D <= 32) return smem_bytes<32>(bf16);
  if (D <= 64) return smem_bytes<64>(bf16);
  if (D <= 128) return smem_bytes<128>(bf16);
  if (D <= 160) return smem_bytes<160>(bf16);
  return smem_bytes<256>(bf16);
}
