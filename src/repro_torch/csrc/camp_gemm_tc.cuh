// The tensor-core template of the CAMP integer GEMMs, for Hopper (sm_90a):
// K5 (int8 A x int8 B), K6a (int8 A x int4 B packed two per byte along K)
// and K6b (packed int4 A x packed int4 B), whose activations arrive
// quantized (camp_gemm.cu), and K1 and K4 (int8 or packed int4 B), whose
// float activations are quantized inside the kernel (camp_gemm_fused.cu).
// Those files say what each instance replaces. An instance is
// <W4, MT, QMAX, XB>: B packed int4 (W4), the row tile MT (8, 32 or 128),
// and how A arrives: XB = 1, int8 with its row scales (QMAX 0); XB = 0,
// int4 packed two per byte along K, (M, K/2), with its row scales (QMAX
// 0); XB = 2 or 4, x in bf16 or f32, quantized per row to [-QMAX, QMAX]
// (127, or 7 for w4a4).
//
// Orientation. The block computes a tile of C^T = B^T A^T: wgmma's
// 64-row operand is B^T (BN = 128 output columns n, two warpgroups of 64),
// its N operand is A (MT output rows m), both K-major in shared memory, as
// wgmma requires of 8-bit operands. So a decode batch of 8 rows is an
// m64n8k32 product with no rows of zeros, and the K-major A rows arrive
// from memory as they are.
//
// K pipeline. K runs in steps of BK = 128 (one 128-byte swizzle panel of
// int8 a row). A ring of STAGES slots (5 at MT 128, else 8) each holds A's
// MT x 128 int8 tile and B's tile as stored (int8: 128 k rows of 128 n
// bytes; int4: 64 packed rows), both in the 128-byte swizzle. TMA writes
// B's tile (and int8 A's) STAGES - 2 K steps ahead of its use, one thread
// issuing the boxes, which complete on the slot's mbarrier; TMA fills zeros
// past M, N and K. Where a row's pitch is not a multiple of 16 bytes (K for
// int8 A, N for B), which TMA cannot address, every thread gathers the
// same tiles a byte at a time instead. No operand is padded in memory.
//
// The fused quantize (XB 2 or 4). The quantized activations never reach
// device memory. Each row's scale comes from its whole K row, before any
// of its tiles is quantized, by the reference's f32 chain as XLA compiles
// it (camp_quant.cuh, which K7 shares). A block cannot
// take the scale from its own split of K, so the scales come either from
// the block itself, each warp reducing whole rows of x (read from L2; the
// choice at MT 8, where a tile has few rows), or from
// camp_gemm_tc_scale_kernel, which writes the M scales into the call's
// workspace before the product (MT 32 and 128, where the blocks of a row
// tile would each read the same rows again): the product kernel is its
// programmatic dependent launch, issues its first B loads and x's first
// step, then waits (griddepcontrol.wait) and reads the scales.
// kernels/camp_gemm.py picks one by row tile (tc_flags). Either way the M
// scales land in the workspace for the flush. x arrives in 16-byte groups
// (8 bf16 or 4 f32 values; element loads where K * XB is not a multiple
// of 16), one K step ahead in registers: step i + 1's groups are quantized
// and stored as int8 into the A slot at swz_off after step i's products
// are issued, and step i + 2's groups are loaded; rows past M and columns
// past K come out zero. The quotient is not divided out: the exact product
// with the row's rounded reciprocal, rounded to an integer by an fma with
// 1.5 * 2^23, provably gives the reference's integer unless it lies within
// 2^-14 of a half-integer, and those rare groups (about one in 1,000) are
// redone by the division (quantize_group says why). Every n-tile block
// quantizes its rows again: at M 256 that arithmetic, not the bytes, sets
// the time (PERF.md).
//
// Packed int4 A (XB 0, K6b) takes the same register path with no scale
// work: a 16-byte group of packed A holds 32 k of one row; it is loaded one
// K step ahead (byte gathers where K/2 is not a multiple of 16) and its
// nibbles, low first, sign-extended, become two 16-byte int8 chunks of the
// A slot at swz_off. K is even, so a step never splits a byte; rows past M
// and bytes past K/2 come out zero.
//
// B^T. Each stage of B is rewritten K-major into one of two B^T buffers
// (128 n rows x 128 k bytes, swizzled): a thread takes a 4 k x 4 n block
// (int8: one word from each of 4 k rows; int4: one word from each of 2
// packed rows, i.e. 4 k) and makes the 4 words of 4 consecutive k of each
// column with __byte_perm (int4: the nibbles sign-extended on the way). A
// warp's lanes take 4 k-quads and 8 n-quads chosen for the swizzle
// (n_quad), each lane starting at its own column of the four: both the
// reads of the staging tile and the writes of B^T hit 32 distinct banks.
// Then the products of the stage: 4 wgmma.m64nMTk32.s32.s8.s8 a
// warpgroup. ptxas waits for each before the next (WARPGROUP.DEPBAR after
// every IGMMA in the SASS), so the wait that would keep a group in flight
// finds none.
//
// Split-K. int32 partial sums are exact in any order, so the K steps are
// split across gridDim.z blocks of kps steps each, to bring the grid to
// about one block an SM (kernels/camp_gemm.py::split_plan). Each block
// stores its partial sums, coalesced, in its own plane of an int32
// (splits, M, N) workspace: no atomics, no zeroing, no counters.
//
// The flush is camp::flush_one (acc -> f32, the scale product first, a
// first bias or residual fused into one fmaf, then the other stages), once
// per output. With one split on a grid that fills the card (the dense
// prefill, M 4,096) the product block flushes its own sums from shared
// memory (kFlushInBlock: no plane). Otherwise it is a second kernel,
// camp_gemm_tc_flush_kernel, over all SMs: one output a thread, its
// partial sums added in split order. It is a programmatic dependent
// launch: the product kernel lets it be scheduled once every product block
// has started, and its blocks wait (griddepcontrol.wait) until the product
// grid has finished and its stores are visible, so the second launch's
// latency hides behind the product. A call launches one to three device
// kernels: the scale pass (fused, MT 32 and 128), the product, the flush
// kernel (unless the product block flushes). With kNoFlush (pre-quantized
// A only: K5, K6a, K6b with int32 out) nothing flushes: the planes are the
// output, for a sum over ranks before the one flush.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "camp_gemm_common.cuh"
#include "camp_quant.cuh"
#include "hopper.cuh"

namespace camp_tc {
namespace {

using camp_quant::exact_only;
using camp_quant::gather_x;
using camp_quant::quantize_group;
using camp_quant::quantize_group_exact;
using camp_quant::row_scale;

constexpr int BN = 128;          // output columns a block (wgmma rows)
constexpr int BK = 128;          // K a step: one swizzle panel of int8 a row
constexpr int THREADS = 256;     // two warpgroups

// How a call runs (kernels/camp_gemm.py::tc_flags).
enum Flags {
  kFlushInBlock = 1,   // one split: the product block flushes its sums
  kScaleKernel = 2,    // fused: row scales from camp_gemm_tc_scale_kernel
  // fused, scales in the block: each from its own split's K range only.
  // Wrong on purpose: chip_smoke.py launches it to show that the exact
  // check rejects a scale that did not see the whole row.
  kSplitScales = 4,
  // the int32 sums are the output: each split's stay in its workspace
  // plane and no flush kernel runs (kernels/camp_gemm.py adds the planes).
  // A row-parallel product on the dense slab reduces them over the ranks
  // before its one flush, as GSPMD reduces the reference's int32 dot.
  kNoFlush = 8,
};

template <bool W4, int MT>
struct Tile {
  // ring slots: loads run STAGES - 2 steps ahead, as deep as shared memory
  // allows beside the two B^T buffers
  static constexpr int STAGES = MT == 128 ? 5 : 8;
  static constexpr int A_BYTES = MT * BK;
  static constexpr int RAW_ROWS = W4 ? BK / 2 : BK;   // B rows as stored
  static constexpr int RAW_BYTES = RAW_ROWS * BN;
  static constexpr int BT_BYTES = BN * BK;
  static constexpr int SLOT_BYTES = A_BYTES + RAW_BYTES;
  static constexpr int CS = BN + 4;    // row pitch of the staged sums
  static_assert(MT * CS * 4 <= STAGES * SLOT_BYTES,
                "the staged sums fit in the ring");
  // 1024 to align the base; two B^T buffers; the ring; a TMA barrier a
  // slot; the tile's MT row scales and their reciprocals
  static constexpr int BAR_OFF = 2 * BT_BYTES + STAGES * SLOT_BYTES;
  static constexpr int SA_OFF = BAR_OFF + 8 * STAGES;
  static constexpr int SMEM = 1024 + SA_OFF + 8 * MT;
};

struct TcArgs {
  CUtensorMap a_map;  // int8 A (M, K) in boxes of MT rows x 128 bytes (tma)
  CUtensorMap b_map;  // B as stored, boxes of RAW_ROWS rows x 128 bytes
  camp::GemmArgs g;   // g.a: int8 A, packed A or x (fused); g.sa: A's
                      // row scales
  float* sa_out;      // fused: where the M row scales go (== g.sa)
  int32_t* ws;        // (splits, M, N) int32 partial sums
  int kps;            // K steps a split
  int tma;            // rows of B (and int8 A) 16-byte aligned: TMA
  int xvec;           // x's or packed A's rows 16-byte aligned: vector
                      // loads
  int flags;          // Flags
};

// Byte c of row r of a tile with 128-byte rows, in the 128-byte swizzle
// that TMA writes and the wgmma descriptors name (hopper.cuh): A's tiles,
// B's staging tiles and B^T all use it.
__device__ __forceinline__ uint32_t swz_off(int r, int c) {
  return r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// 16 bytes of row `row` from byte `col` on, of a row-major byte matrix
// (rows x pitch) whose rows are not 16-byte aligned, gathered a byte at a
// time; zeros past the edges.
__device__ __forceinline__ uint4 gather_bytes(const int8_t* base, long row,
                                              int col, long rows,
                                              int pitch) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row < rows) {
    const int8_t* src = base + row * pitch;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + j < pitch)
        w[j >> 2] |= (uint32_t)(uint8_t)src[col + j] << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ... and stored to shared memory at dst.
__device__ __forceinline__ void gather_chunk(uint32_t dst,
                                             const int8_t* base, long row,
                                             int col, long rows, int pitch) {
  const uint4 u = gather_bytes(base, row, col, rows, pitch);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  st_shared_v4(dst, w);
}

// The nibbles of t that its bytes' positions pick (the low one in bytes 0
// and 2, the high one in bytes 1 and 3), each sign-extended to its byte.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t t) {
  // each byte's nibble into the byte's high half, then an arithmetic
  // shift right by 4 within each byte
  const uint32_t u = (t & 0xF000F000u) | ((t << 4) & 0x00F000F0u);
  return ((u >> 4) & 0x0F0F0F0Fu) | (((u >> 7) & 0x01010101u) * 0xF0u);
}

// -- B^T --------------------------------------------------------------------
// Column c (0..3) of four k rows' words w0..w3: byte i of the result is
// byte c of w_i (k = 4q + i).
__device__ __forceinline__ uint32_t column_i8(uint32_t w0, uint32_t w1,
                                              uint32_t w2, uint32_t w3,
                                              int c) {
  const uint32_t sel = c | ((c + 4) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel),
                     0x5410);
}

// Column c (0..3) of two packed rows' words w0 (k = 4q, 4q + 1) and w1
// (k = 4q + 2, 4q + 3): the four nibbles, low first, each sign-extended.
__device__ __forceinline__ uint32_t column_w4(uint32_t w0, uint32_t w1,
                                              int c) {
  return sext_nibbles(
      __byte_perm(w0, w1, c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12)));
}

// The n-quad of lane `lane` in round x of convert_b: its low two bits are
// lane bits 2-3; the high three are chosen so that a warp's reads of the
// staging tile hit 32 distinct banks (int8: 4 stored rows a k-quad; int4:
// 2), given the k-quad q = 4 (x % 8) + lane % 4.
template <bool W4>
__device__ __forceinline__ int n_quad(int x, int lane) {
  const int hi = W4 ? 2 * (x >> 3) + (lane >> 4)
                    : 4 * ((x >> 3) & 1) +
                          ((((lane >> 1) & 1) ^ (x >> 4)) + 2 * (lane >> 4));
  return 4 * hi + ((lane >> 2) & 3);
}

// B staging tile (as stored, swz_off) -> B^T (128 n rows x 128 k bytes,
// swz_off). Warp w, round i: x = 8 i + w; lane l takes k-quad
// q = 4 (x % 8) + l % 4 and n-quad p = n_quad(x, l), and writes its four
// columns starting at column (l / 8) % 4, so that the warp's writes hit 32
// distinct banks too.
template <bool W4>
__device__ __forceinline__ void convert_b(const uint8_t* raw, uint8_t* bt) {
  constexpr int RPQ = W4 ? 2 : 4;                  // stored rows a k-quad
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rot = (lane >> 3) & 3;
  // every round's words first, so that the loads overlap
  uint32_t w[4][RPQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = 8 * i + warp;
    const int q = 4 * (x & 7) + (lane & 3), p = n_quad<W4>(x, lane);
#pragma unroll
    for (int r = 0; r < RPQ; ++r)
      w[i][r] = *reinterpret_cast<const uint32_t*>(
          raw + swz_off(RPQ * q + r, 4 * p));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = 8 * i + warp;
    const int q = 4 * (x & 7) + (lane & 3), p = n_quad<W4>(x, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (j + rot) & 3;
      const int n = 4 * p + c;
      uint32_t v;
      if constexpr (W4)
        v = column_w4(w[i][0], w[i][1], c);
      else
        v = column_i8(w[i][0], w[i][1], w[i][2], w[i][3], c);
      *reinterpret_cast<uint32_t*>(bt + swz_off(n, 4 * q)) = v;
    }
  }
}

__device__ __forceinline__ void store_out(const camp::GemmArgs& p, long o,
                                          float y) {
  if (p.out_bf16)
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(p.out)[o] = y;
}

// -- the kernels ------------------------------------------------------------
template <bool W4, int MT, int QMAX, int XB>
__global__ void __launch_bounds__(THREADS, 1)
camp_gemm_tc_kernel(const __grid_constant__ TcArgs t) {
  using T = Tile<W4, MT>;
  constexpr bool FUSED = XB == 2 || XB == 4;   // x, quantized here
  constexpr bool A4 = XB == 0;                 // packed int4 A
  constexpr bool REG_A = FUSED || A4;          // A through registers
  extern __shared__ uint8_t smem_tc[];
  const uint32_t smem0 = hopper::smem_u32(smem_tc);
  const uint32_t base = (smem0 + 1023) & ~1023u;
  auto bt = [&](int i) { return base + (i & 1) * T::BT_BYTES; };
  auto slot_a = [&](int i) {
    return base + 2 * T::BT_BYTES + (i % T::STAGES) * T::SLOT_BYTES;
  };
  auto slot_raw = [&](int i) { return slot_a(i) + T::A_BYTES; };
  // slot i % STAGES landed (TMA); the parity of step i's use of it
  auto full = [&](int i) { return base + T::BAR_OFF + 8 * (i % T::STAGES); };
  auto phase = [](int i) {
    return static_cast<uint32_t>((i / T::STAGES) & 1);
  };
  float* sa_s = reinterpret_cast<float*>(smem_tc + (base - smem0) + T::SA_OFF);
  float* sr_s = sa_s + MT;                 // fused: 1 / sa_s, rounded

  const camp::GemmArgs& p = t.g;
  const int M = p.M, N = p.N, K = p.K;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int nkt = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * t.kps;
  const int nk = max(0, min(nkt, kt0 + t.kps) - kt0);
  const int8_t* a = static_cast<const int8_t*>(p.a);
  const uint8_t* x = static_cast<const uint8_t*>(p.a);
  const long b_rows = W4 ? K / 2 : K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (t.tma && threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) hopper::mbar_init(full(i), 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // K step i of this split into ring slot i % STAGES: B's box (and int8
  // A's) issued by one thread (past the edges TMA fills zeros), or else
  // every thread gathers its chunks. The fused and packed A come from
  // store_a.
  auto load = [&](int i) {
    if (i >= nk) return;
    const int k0 = (kt0 + i) * BK;
    const int r0 = (kt0 + i) * T::RAW_ROWS;
    if (t.tma) {
      if (threadIdx.x == 0) {
        hopper::mbar_expect_tx(full(i), REG_A ? T::RAW_BYTES : T::SLOT_BYTES);
        if constexpr (!REG_A)
          hopper::tma_load_3d(slot_a(i), &t.a_map, full(i), k0, m0, 0);
        hopper::tma_load_3d(slot_raw(i), &t.b_map, full(i), n0, r0, 0);
      }
      return;
    }
    if constexpr (!REG_A) {
      for (int c = threadIdx.x; c < MT * 8; c += THREADS) {
        const int r = c >> 3, col = (c & 7) * 16;
        gather_chunk(slot_a(i) + swz_off(r, col), a, m0 + r, k0 + col, M, K);
      }
    }
    for (int c = threadIdx.x; c < T::RAW_ROWS * 8; c += THREADS) {
      const int r = c >> 3, col = (c & 7) * 16;
      gather_chunk(slot_raw(i) + swz_off(r, col), p.w, r0 + r, n0 + col,
                   b_rows, N);
    }
  };
  for (int i = 0; i < T::STAGES - 2; ++i) load(i);
  // the flush kernel may be scheduled now: its blocks wait for this grid
  // to finish (griddepcontrol.wait), so its launch overlaps the product
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Fused or packed A: the A tile of step i is MT rows of 128 int8 from
  // 16-byte groups of x (KPG values) or of packed A (KPG = 32 k), GPR a
  // row; group g = threadIdx.x + THREADS j of the tile is this thread's
  // xr[j].
  constexpr int KPG = A4 ? 32 : 16 / (A4 ? 1 : XB);
  constexpr int GPR = BK / KPG;
  constexpr int GROUPS = MT * GPR;
  constexpr int GPT = REG_A ? (GROUPS + THREADS - 1) / THREADS : 1;
  uint4 xr[GPT];
  auto fetch_x = [&](int i) {
    if constexpr (REG_A) {
      const int k0 = (kt0 + i) * BK;
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        const int g = threadIdx.x + THREADS * j;
        const int m = m0 + g / GPR, k = k0 + (g % GPR) * KPG;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (g < GROUPS && m < M && k < K) {
          if constexpr (A4) {
            u = t.xvec ? __ldg(reinterpret_cast<const uint4*>(
                             a + (long)m * (K / 2) + k / 2))
                       : gather_bytes(a, m, k / 2, M, K / 2);
          } else {
            const uint8_t* src = x + ((long)m * K + k) * XB;
            u = t.xvec ? __ldg(reinterpret_cast<const uint4*>(src))
                       : gather_x<XB>(src, K - k);
          }
        }
        xr[j] = u;
      }
    }
  };
  // ... quantized into A's slot of step i, in the swizzle TMA would write
  // (8 bytes a bf16 group, 4 an f32 one: inside one 16-byte chunk). The
  // rare groups that need the division are stored again afterwards, so
  // that the loop over the groups has no branch.
  auto store_group = [&](uint32_t dst, uint32_t q0, uint32_t q1) {
    uint8_t* p = smem_tc + (dst - smem0);
    if constexpr (XB == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(q0, q1);
    else
      *reinterpret_cast<uint32_t*>(p) = q0;
  };
  // this thread's groups keep their rows in every step: their reciprocal
  // scales live in registers (set once the scales are known)
  float xr_r[GPT];
  // groups that always take the division: those of rows whose reciprocal
  // is 0 or infinite, and every group in the split-scale control (its
  // scales do not bound the row, so the clamp may act)
  uint32_t exact_groups = 0;
  auto store_a = [&](int i) {
    if constexpr (A4) {
      // each packed word (8 k) into two int8 words: a group's 32 k are two
      // 16-byte chunks of the slot
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        const int g = threadIdx.x + THREADS * j;
        if (g < GROUPS) {
          const uint4 u = xr[j];
          const uint32_t lo[4] = {
              sext_nibbles(__byte_perm(u.x, 0u, 0x1100)),
              sext_nibbles(__byte_perm(u.x, 0u, 0x3322)),
              sext_nibbles(__byte_perm(u.y, 0u, 0x1100)),
              sext_nibbles(__byte_perm(u.y, 0u, 0x3322))};
          const uint32_t hi[4] = {
              sext_nibbles(__byte_perm(u.z, 0u, 0x1100)),
              sext_nibbles(__byte_perm(u.z, 0u, 0x3322)),
              sext_nibbles(__byte_perm(u.w, 0u, 0x1100)),
              sext_nibbles(__byte_perm(u.w, 0u, 0x3322))};
          const int r = g / GPR, c = (g % GPR) * KPG;
          st_shared_v4(slot_a(i) + swz_off(r, c), lo);
          st_shared_v4(slot_a(i) + swz_off(r, c + 16), hi);
        }
      }
    } else if constexpr (FUSED) {
      uint32_t redo = exact_groups;
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        const int g = threadIdx.x + THREADS * j;
        if (g < GROUPS) {
          uint32_t q[2];
          if (!quantize_group<QMAX, XB>(xr[j], xr_r[j], q)) redo |= 1u << j;
          store_group(slot_a(i) + swz_off(g / GPR, (g % GPR) * KPG), q[0],
                      q[1]);
        }
      }
      // The groups that need the division (about one in 1,000: a warp meets
      // one every few steps), from their registers picked by unrolled
      // selects: one copy of the division in the code, no call, no load.
#pragma unroll 1
      for (int j = 0; redo != 0; ++j, redo >>= 1) {
        if (!(redo & 1)) continue;
        uint4 u = xr[0];
#pragma unroll
        for (int jj = 1; jj < GPT; ++jj)
          if (jj == j) u = xr[jj];
        const int g = threadIdx.x + THREADS * j, r = g / GPR;
        uint32_t q[2];
        quantize_group_exact<QMAX, XB>(u, sa_s[r], q);
        store_group(slot_a(i) + swz_off(r, (g % GPR) * KPG), q[0], q[1]);
      }
    }
  };
  // step 0's x (or packed A) is loaded before the scales are known (x is
  // final: the scale pass was launched after its producer)
  if constexpr (REG_A) {
    if (nk > 0) fetch_x(0);
  }
  // The tile's row scales and their reciprocals (shared memory): fused,
  // from the scale kernel or from whole rows of x (one warp a row; the
  // first block of the row tile also writes them for the flush kernel);
  // int8 or packed A, given (read only where the block flushes).
  if constexpr (FUSED) {
    if (t.flags & kScaleKernel) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int r = threadIdx.x; r < MT; r += THREADS) {
        const float s = m0 + r < M ? t.sa_out[m0 + r] : 1.f;
        sa_s[r] = s;
        sr_s[r] = __frcp_rn(s);
      }
    } else {
      const bool local = t.flags & kSplitScales;
      const int lo = local ? kt0 * BK : 0;
      const int hi = local ? min(K, (kt0 + nk) * BK) : K;
      for (int r = warp; r < MT; r += THREADS / 32) {
        const int m = m0 + r;
        const float s =
            m < M ? row_scale<QMAX, XB>(x, m, K, lo, hi, t.xvec, lane) : 1.f;
        if (lane == 0) {
          sa_s[r] = s;
          sr_s[r] = __frcp_rn(s);
          if (m < M && blockIdx.x == 0 && blockIdx.z == 0) t.sa_out[m] = s;
        }
      }
    }
  } else if (t.flags & kFlushInBlock) {
    for (int r = threadIdx.x; r < MT; r += THREADS)
      sa_s[r] = m0 + r < M ? p.sa[m0 + r] : 1.f;
  }
  __syncthreads();
  if constexpr (FUSED) {
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      const int g = threadIdx.x + THREADS * j;
      xr_r[j] = g < GROUPS ? sr_s[g / GPR] : 1.f;
      if (g < GROUPS && ((t.flags & kSplitScales) || exact_only(xr_r[j])))
        exact_groups |= 1u << j;
    }
  }

  const int wg = threadIdx.x >> 7;
  int d[MT / 2];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) d[i] = 0;

  // Step -1 only stores step 0's A, so that store_a has one copy in the
  // code (the loop is not unrolled).
#pragma unroll 1
  for (int i = REG_A ? -1 : 0; i < nk; ++i) {
    if (i >= 0) {
      if (t.tma) hopper::mbar_wait(full(i), phase(i));   // step i landed
      hopper::fence_proxy_async();
      // step i has landed (the gathers and step i's A: every thread's
      // stores), and every warpgroup has waited for step i - 2's products:
      // its ring slot and its B^T buffer are free
      __syncthreads();
      load(i + T::STAGES - 2);
      convert_b<W4>(smem_tc + (slot_raw(i) - smem0),
                    smem_tc + (bt(i) - smem0));
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::fence_regs(d);
      hopper::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BK; kb += 32)
        hopper::wgmma_s8(
            d, hopper::desc_k_major_bytes<128>(bt(i), BN, 64 * wg, kb),
            hopper::desc_k_major_bytes<128>(slot_a(i), MT, 0, kb), 1);
      hopper::wgmma_commit();
    }
    if constexpr (REG_A) {
      // after step i's products are issued: step i + 1's A into its slot
      // (its last reader, step i + 1 - STAGES, is done), step i + 2's x
      // (or packed A) loaded
      if (i + 1 < nk) {
        store_a(i + 1);
        if (i + 2 < nk) fetch_x(i + 2);
      }
    }
    if (i >= 0) {
      hopper::wgmma_wait<1>();               // step i - 1's products
      hopper::fence_regs(d);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);

  // The accumulators into shared memory (the ring is free once both
  // warpgroups are done), [MT][CS] int32: d[4 j + 2 h + e] is output
  // column n0 + 64 wg + 16 warp + g + 8 h, row m0 + 8 j + 2 tq + e. The
  // row pitch CS = BN + 4 keeps a warp's stores on 32 banks.
  __syncthreads();
  int32_t* cs = reinterpret_cast<int32_t*>(smem_tc + (slot_a(0) - smem0));
  {
    const int c0 = 64 * wg + 16 * (warp & 3) + (lane >> 2),
              r0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT / 2; ++i)
      cs[(r0 + 8 * (i >> 2) + (i & 1)) * T::CS + c0 + 8 * ((i >> 1) & 1)] =
          d[i];
  }
  __syncthreads();

  // Then thread t takes column c = t % BN and rows t / BN + 2 j, so that
  // a warp works along 32 consecutive columns of a row: the flush of the
  // whole sums (one split), or this split's partial sums into plane
  // blockIdx.z of the workspace.
  const int c = threadIdx.x % BN, rb = threadIdx.x / BN, n = n0 + c;
  if (n >= N) return;
  if (t.flags & kFlushInBlock) {
#pragma unroll 4
    for (int j = 0; j < MT / 2; ++j) {
      const int r = rb + 2 * j, m = m0 + r;
      if (m < M)
        store_out(p, (long)m * N + n,
                  camp::flush_one(p, m, n, cs[r * T::CS + c], sa_s[r]));
    }
    return;
  }
  int32_t* part = t.ws + (long)blockIdx.z * M * N;
#pragma unroll 4
  for (int j = 0; j < MT / 2; ++j) {
    const int r = rb + 2 * j, m = m0 + r;
    if (m < M) part[(long)m * N + n] = cs[r * T::CS + c];
  }
}

// The fused calls' scale pass: warp w of block b takes row 8 b + w and
// writes its scale (row_scale over the whole row) to sa.
constexpr int SCALE_THREADS = 256;

template <int QMAX, int XB>
__global__ void __launch_bounds__(SCALE_THREADS)
camp_gemm_tc_scale_kernel(const void* __restrict__ x, float* __restrict__ sa,
                          int M, int K, int xvec) {
  // the product kernel may start now and issue its B loads; it waits
  // (griddepcontrol.wait) for this grid before it reads the scales
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int m = blockIdx.x * (SCALE_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const float s = row_scale<QMAX, XB>(static_cast<const uint8_t*>(x), m, K,
                                      0, K, xvec, threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) sa[m] = s;
}

// The flush: thread i takes output i (a warp, 32 consecutive columns of a
// row), adds its splits' partial sums in split order (int32: exact) and
// flushes the sum once.
constexpr int FLUSH_THREADS = 256;

__global__ void __launch_bounds__(FLUSH_THREADS)
camp_gemm_tc_flush_kernel(const camp::GemmArgs p,
                          const int32_t* __restrict__ ws, int splits) {
  // launched early (programmatic dependent launch): wait here until the
  // product kernel has finished and its partial sums are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long total = (long)p.M * p.N;
  for (long o = (long)blockIdx.x * FLUSH_THREADS + threadIdx.x; o < total;
       o += (long)gridDim.x * FLUSH_THREADS) {
    int acc = 0;
#pragma unroll 4
    for (int z = 0; z < splits; ++z) acc += ws[z * total + o];
    const int m = static_cast<int>(o / p.N), n = static_cast<int>(o % p.N);
    store_out(p, o, camp::flush_one(p, m, n, acc, p.sa[m]));
  }
}

// A launch configuration, with the programmatic dependent launch attribute
// when `pdl` (the kernel may start before the previous one on the stream
// finishes, and waits for it with griddepcontrol.wait). Used in place: cfg
// points into the object.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(dim3 grid, int threads, int smem, cudaStream_t stream, bool pdl) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
  }
};

template <bool W4, int MT, int QMAX, int XB>
int launch_instance(TcArgs& t, int splits, cudaStream_t stream) {
  using T = Tile<W4, MT>;
  constexpr bool FUSED = XB == 2 || XB == 4;
  const camp::GemmArgs& g = t.g;
  if (t.tma) {
    if constexpr (XB == 1) {
      const int rc =
          hopper::encode_tma_3d_u8(&t.a_map, g.a, g.K, g.M, 1, BK, MT, 128);
      if (rc != 0) return rc;
    }
    const int rc = hopper::encode_tma_3d_u8(
        &t.b_map, g.w, g.N, W4 ? g.K / 2 : g.K, 1, BN, T::RAW_ROWS, 128);
    if (rc != 0) return rc;
  }
  const auto kernel = camp_gemm_tc_kernel<W4, MT, QMAX, XB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool scale_pass = FUSED && (t.flags & kScaleKernel);
  if constexpr (FUSED) {
    if (scale_pass) {
      constexpr int rows = SCALE_THREADS / 32;
      camp_gemm_tc_scale_kernel<QMAX, XB>
          <<<(g.M + rows - 1) / rows, SCALE_THREADS, 0, stream>>>(
              g.a, t.sa_out, g.M, g.K, t.xvec);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  {
    Launch l(dim3((g.N + BN - 1) / BN, (g.M + MT - 1) / MT, splits), THREADS,
             T::SMEM, stream, scale_pass);
    err = cudaLaunchKernelEx(&l.cfg, kernel, t);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (t.flags & (kFlushInBlock | kNoFlush)) return 0;
  const long total = (long)g.M * g.N;
  const long need = (total + FLUSH_THREADS - 1) / FLUSH_THREADS;
  Launch l(dim3(static_cast<unsigned>(need < 8192 ? need : 8192)),
           FLUSH_THREADS, 0, stream, true);
  return static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, camp_gemm_tc_flush_kernel, t.g,
      static_cast<const int32_t*>(t.ws), splits));
}

template <bool W4, int QMAX, int XB>
int launch_row_tile(TcArgs& t, int mt, int splits, cudaStream_t stream) {
  if (mt == 8) return launch_instance<W4, 8, QMAX, XB>(t, splits, stream);
  if (mt == 32) return launch_instance<W4, 32, QMAX, XB>(t, splits, stream);
  if (mt == 128) return launch_instance<W4, 128, QMAX, XB>(t, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// QMAX 0: int8 A, or packed int4 A (A4); else x in bf16 (a_bf16) or f32.
template <bool W4, int QMAX, bool A4>
int launch_tc(TcArgs& t, int mt, int splits, int a_bf16,
              cudaStream_t stream) {
  if constexpr (QMAX == 0)
    return launch_row_tile<W4, 0, A4 ? 0 : 1>(t, mt, splits, stream);
  else if (a_bf16)
    return launch_row_tile<W4, QMAX, 2>(t, mt, splits, stream);
  else
    return launch_row_tile<W4, QMAX, 4>(t, mt, splits, stream);
}

// Dynamic shared memory of one product block with B kind w4 and row tile
// mt (the same for every A kind); 0 for no such instance.
inline int smem_bytes(bool w4, int mt) {
  if (mt == 8) return w4 ? Tile<true, 8>::SMEM : Tile<false, 8>::SMEM;
  if (mt == 32) return w4 ? Tile<true, 32>::SMEM : Tile<false, 32>::SMEM;
  if (mt == 128) return w4 ? Tile<true, 128>::SMEM : Tile<false, 128>::SMEM;
  return 0;
}

}  // namespace
}  // namespace camp_tc

// One C entry point per (B kind, A kind): B packed int4 (W4); A int8
// (QMAX 0), packed int4 (QMAX 0, A4) or x quantized to [-QMAX, QMAX]. Its
// arguments: the flush's (camp_gemm_common.cuh's GemmArgs; K is the
// logical K), then the int32 workspace of splits x M x N partial sums
// (NULL where the block flushes; with kNoFlush, pre-quantized A only, the
// output), the row tile MT (8, 32 or 128), the number of splits, the K
// steps a split and the Flags
// (kernels/camp_gemm.py::launch_gemm binds it). `sa` holds the row scales
// of int8 or packed A, or receives those of x (M f32 in the workspace).
#define CAMP_GEMM_TC_ENTRY(NAME, W4, QMAX, A4)                                \
  extern "C" int NAME(const void* a, int a_bf16, void* sa, const void* w,    \
                      const void* sb, const void* bias, int bias_bf16,       \
                      const void* opd, int opd_bf16, void* out,              \
                      int out_bf16, int M, int N, int K, int stages,         \
                      int n_stages, void* ws, int mt, int splits, int kps,   \
                      int flags, void* stream) {                             \
    const camp::GemmArgs g{a,         a_bf16,                                \
                           static_cast<const float*>(sa),                    \
                           static_cast<const int8_t*>(w),                    \
                           static_cast<const float*>(sb),                    \
                           bias,      bias_bf16, opd, opd_bf16, out,         \
                           out_bf16,  M,         N,   K,        stages,      \
                           n_stages};                                        \
    const bool in_block = (flags & camp_tc::kFlushInBlock) != 0;             \
    const bool no_flush = (flags & camp_tc::kNoFlush) != 0;                  \
    if (splits < 1 || (in_block && (splits != 1 || no_flush)) ||             \
        (no_flush && QMAX != 0) || (!in_block && ws == nullptr) ||           \
        sa == nullptr || (A4 && K % 2))                                      \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    camp_tc::TcArgs t{};                                                     \
    t.g = g;                                                                 \
    t.sa_out = QMAX != 0 ? static_cast<float*>(sa) : nullptr;                \
    t.ws = static_cast<int32_t*>(ws);                                        \
    t.kps = kps;                                                             \
    t.flags = flags;                                                         \
    const bool b_tma =                                                       \
        N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;             \
    const bool a16 = reinterpret_cast<uintptr_t>(a) % 16 == 0;               \
    t.tma = QMAX != 0 || A4 ? b_tma                                          \
                            : b_tma && K > 0 && K % 16 == 0 && a16;          \
    t.xvec = a16 && (QMAX != 0 ? (long)K * (a_bf16 ? 2 : 4) % 16 == 0        \
                               : A4 && (K / 2) % 16 == 0);                   \
    return camp_tc::launch_tc<W4, QMAX, A4>(                                 \
        t, mt, splits, a_bf16, static_cast<cudaStream_t>(stream));           \
  }
