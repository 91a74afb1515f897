// The tensor-core template of the CAMP integer GEMMs of pre-quantized
// activations (K5: int8 B; K6a: int4 B packed two per byte along K), for
// Hopper (sm_90a). camp_gemm.cu says what each instance replaces.
//
// Orientation. The block computes a tile of C^T = B^T A^T: wgmma's
// 64-row operand is B^T (BN = 128 output columns n, two warpgroups of 64),
// its N operand is A (MT output rows m: 8, 32 or 128), both K-major in
// shared memory, as wgmma requires of 8-bit operands. So a decode batch of
// 8 rows is an m64n8k32 product with no rows of zeros, and the K-major A
// rows arrive from memory as they are.
//
// K pipeline. K runs in steps of BK = 128 bytes (one 128-byte swizzle
// panel a row). A ring of STAGES slots (5 at MT 128, else 8) each holds
// A's MT x 128 tile and B's 128 x 128 tile as stored (K5: 128 k rows of
// 128 n bytes; K6a: 64 packed rows), both in the 128-byte swizzle,
// written by TMA (two boxes a step, issued by one thread, completing on
// the slot's mbarrier) STAGES - 2 K steps ahead of their use; TMA fills
// zeros past M, N and K. Where a row's pitch is not a multiple of 16
// bytes (K for A, N for B), which TMA cannot address, every thread
// gathers the same tiles a byte at a time instead. No operand is padded
// in memory.
//
// B^T. Each stage of B is rewritten K-major into one of two B^T buffers
// (128 n rows x 128 k bytes, swizzled): a thread takes a 4 k x 4 n block
// (K5: one word from each of 4 k rows; K6a: one word from each of 2 packed
// rows, i.e. 4 k) and makes the 4 words of 4 consecutive k of each column
// with __byte_perm (K6a: the nibbles sign-extended on the way). A warp's
// lanes take 4 k-quads and 8 n-quads chosen for the swizzle (n_quad), each
// lane starting at its own column of the four: both the reads of the
// staging tile and the writes of B^T hit 32 distinct banks. Then the
// products of the stage: 4 wgmma.m64nMTk32.s32.s8.s8 a warpgroup, left in
// flight while the next stage is converted (the wait after each step
// keeps one group in flight).
//
// Split-K. int32 partial sums are exact in any order, so the K steps are
// split across gridDim.z blocks of kps steps each, to bring the grid to
// about one block an SM (kernels/camp_gemm.py::split_plan). Each block
// stores its partial sums, coalesced, in its own plane of an int32
// (splits, M, N) workspace: no atomics, no zeroing, no counters.
//
// The flush is a second kernel, camp_gemm_tc_flush_kernel, over all SMs:
// one output a thread, its partial sums added in split order, then
// camp::flush_one, the same as camp_gemm_kernel's and the fused kernels'
// (acc -> f32, the scale product first, a first bias or residual fused
// into one fmaf, then the other stages), once per output. In the product
// kernel the flush ran on 8 warps an SM, 64 outputs a thread, and took
// longer on the H100 than the K loop at the serving shapes (flush_one's
// branches leave little to overlap); spread over the whole card it is one
// output a thread. The sums pass through shared memory so that the
// partial stores run along rows. The flush is a programmatic dependent
// launch: the product kernel lets it be scheduled once every product block
// has started, and its blocks wait (griddepcontrol.wait) until the
// product grid has finished and its stores are visible, so the second
// launch's latency hides behind the product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "camp_gemm_common.cuh"
#include "hopper.cuh"

namespace camp_tc {
namespace {

constexpr int BN = 128;          // output columns a block (wgmma rows)
constexpr int BK = 128;          // K bytes a stage: one swizzle panel a row
constexpr int THREADS = 256;     // two warpgroups

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
  // slot
  static constexpr int BAR_OFF = 2 * BT_BYTES + STAGES * SLOT_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * STAGES;
};

struct TcArgs {
  CUtensorMap a_map;  // A (M, K) in boxes of MT rows x 128 bytes (tma)
  CUtensorMap b_map;  // B as stored, boxes of RAW_ROWS rows x 128 bytes
  camp::GemmArgs g;
  int32_t* ws;        // (splits, M, N) int32 partial sums
  int kps;            // K steps a split
  int tma;            // rows of A and B 16-byte aligned: TMA, else gathers
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

// 16 bytes of row `row` from byte `col` on, of a row-major int8 matrix
// (rows x pitch) whose rows are not 16-byte aligned, gathered a byte at a
// time to shared memory at dst; zeros past the edges.
__device__ __forceinline__ void gather_chunk(uint32_t dst,
                                             const int8_t* base, long row,
                                             int col, long rows, int pitch) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row < rows) {
    const int8_t* src = base + row * pitch;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + j < pitch)
        w[j >> 2] |= (uint32_t)(uint8_t)src[col + j] << (8 * (j & 3));
  }
  st_shared_v4(dst, w);
}

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
  const uint32_t t =
      __byte_perm(w0, w1, c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12));
  // each byte's nibble into the byte's high half, then an arithmetic
  // shift right by 4 within each byte
  const uint32_t u = (t & 0xF000F000u) | ((t << 4) & 0x00F000F0u);
  return ((u >> 4) & 0x0F0F0F0Fu) | (((u >> 7) & 0x01010101u) * 0xF0u);
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

template <bool W4, int MT>
__global__ void __launch_bounds__(THREADS, 1)
camp_gemm_tc_kernel(const __grid_constant__ TcArgs t) {
  using T = Tile<W4, MT>;
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

  const camp::GemmArgs& p = t.g;
  const int M = p.M, N = p.N, K = p.K;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int nkt = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * t.kps;
  const int nk = max(0, min(nkt, kt0 + t.kps) - kt0);
  const int8_t* a = static_cast<const int8_t*>(p.a);
  const long b_rows = W4 ? K / 2 : K;

  if (t.tma && threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) hopper::mbar_init(full(i), 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // K step i of this split into ring slot i % STAGES: two TMA boxes issued
  // by one thread (past the edges TMA fills zeros), or else every thread
  // gathers its chunks.
  auto load = [&](int i) {
    if (i >= nk) return;
    const int k0 = (kt0 + i) * BK;
    const int r0 = (kt0 + i) * T::RAW_ROWS;
    if (t.tma) {
      if (threadIdx.x == 0) {
        hopper::mbar_expect_tx(full(i), T::SLOT_BYTES);
        hopper::tma_load_3d(slot_a(i), &t.a_map, full(i), k0, m0, 0);
        hopper::tma_load_3d(slot_raw(i), &t.b_map, full(i), n0, r0, 0);
      }
      return;
    }
    for (int c = threadIdx.x; c < MT * 8; c += THREADS) {
      const int r = c >> 3, col = (c & 7) * 16;
      gather_chunk(slot_a(i) + swz_off(r, col), a, m0 + r, k0 + col, M, K);
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

  const int wg = threadIdx.x >> 7;
  int d[MT / 2];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) d[i] = 0;

  for (int i = 0; i < nk; ++i) {
    if (t.tma) hopper::mbar_wait(full(i), phase(i));   // step i landed
    hopper::fence_proxy_async();
    // step i has landed (the gathers: every thread's stores), and every
    // warpgroup has waited for step i - 2's products: its ring slot and
    // its B^T buffer are free
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
      hopper::wgmma_s8(d,
                       hopper::desc_k_major_bytes<128>(bt(i), BN, 64 * wg, kb),
                       hopper::desc_k_major_bytes<128>(slot_a(i), MT, 0, kb),
                       1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();               // step i - 1's products
    hopper::fence_regs(d);
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
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    const int c0 = 64 * wg + 16 * warp + (lane >> 2), r0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT / 2; ++i)
      cs[(r0 + 8 * (i >> 2) + (i & 1)) * T::CS + c0 + 8 * ((i >> 1) & 1)] =
          d[i];
  }
  __syncthreads();

  // Then thread t takes column c = t % BN and rows t / BN + 2 j, so that
  // a warp stores 32 consecutive columns of a row: this split's partial
  // sums, plane blockIdx.z of the workspace.
  int32_t* part = t.ws + (long)blockIdx.z * M * N;
  const int c = threadIdx.x % BN, rb = threadIdx.x / BN, n = n0 + c;
  if (n >= N) return;
#pragma unroll 4
  for (int j = 0; j < MT / 2; ++j) {
    const int r = rb + 2 * j, m = m0 + r;
    if (m < M) part[(long)m * N + n] = cs[r * T::CS + c];
  }
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
    const float y = camp::flush_one(p, m, n, acc, p.sa[m]);
    if (p.out_bf16)
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(p.out)[o] = y;
  }
}

template <bool W4, int MT>
int launch_instance(TcArgs& t, int splits, cudaStream_t stream) {
  using T = Tile<W4, MT>;
  if (t.tma) {
    const camp::GemmArgs& g = t.g;
    const int rc[2] = {
        hopper::encode_tma_3d_u8(&t.a_map, g.a, g.K, g.M, 1, BK, MT, 128),
        hopper::encode_tma_3d_u8(&t.b_map, g.w, g.N, W4 ? g.K / 2 : g.K, 1,
                                 BN, T::RAW_ROWS, 128)};
    for (int e : rc)
      if (e != 0) return e;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      camp_gemm_tc_kernel<W4, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t.g.N + BN - 1) / BN, (t.g.M + MT - 1) / MT, splits);
  camp_gemm_tc_kernel<W4, MT><<<grid, THREADS, T::SMEM, stream>>>(t);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const long total = (long)t.g.M * t.g.N;
  const long need = (total + FLUSH_THREADS - 1) / FLUSH_THREADS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(need < 8192 ? need : 8192));
  cfg.blockDim = dim3(FLUSH_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, camp_gemm_tc_flush_kernel, t.g,
      static_cast<const int32_t*>(t.ws), splits));
}

template <bool W4>
int launch_tc(TcArgs& t, int mt, int splits, cudaStream_t stream) {
  if (mt == 8) return launch_instance<W4, 8>(t, splits, stream);
  if (mt == 32) return launch_instance<W4, 32>(t, splits, stream);
  if (mt == 128) return launch_instance<W4, 128>(t, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of instance (W4, MT); 0 for no such
// instance.
inline int smem_bytes(bool w4, int mt) {
  if (mt == 8) return w4 ? Tile<true, 8>::SMEM : Tile<false, 8>::SMEM;
  if (mt == 32) return w4 ? Tile<true, 32>::SMEM : Tile<false, 32>::SMEM;
  if (mt == 128) return w4 ? Tile<true, 128>::SMEM : Tile<false, 128>::SMEM;
  return 0;
}

}  // namespace
}  // namespace camp_tc

// One C entry point per instance: camp_gemm_common.cuh's signature, then
// the int32 workspace of splits x M x N partial sums, the row tile MT (8,
// 32 or 128), the number of splits and the K steps a split
// (kernels/camp_gemm.py binds it). It launches the product, then the flush.
#define CAMP_GEMM_TC_ENTRY(NAME, W4)                                          \
  extern "C" int NAME(const void* a, int a_bf16, const void* sa,             \
                      const void* w, const void* sb, const void* bias,       \
                      int bias_bf16, const void* opd, int opd_bf16,          \
                      void* out, int out_bf16, int M, int N, int K,          \
                      int stages, int n_stages, void* ws, int mt,            \
                      int splits, int kps, void* stream) {                   \
    const camp::GemmArgs g{a,         a_bf16,                                \
                           static_cast<const float*>(sa),                    \
                           static_cast<const int8_t*>(w),                    \
                           static_cast<const float*>(sb),                    \
                           bias,      bias_bf16, opd, opd_bf16, out,         \
                           out_bf16,  M,         N,   K,        stages,      \
                           n_stages};                                        \
    if (ws == nullptr || splits < 1)                                         \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    camp_tc::TcArgs t{};                                                     \
    t.g = g;                                                                 \
    t.ws = static_cast<int32_t*>(ws);                                        \
    t.kps = kps;                                                             \
    t.tma = K > 0 && K % 16 == 0 && N % 16 == 0 &&                           \
            reinterpret_cast<uintptr_t>(a) % 16 == 0 &&                      \
            reinterpret_cast<uintptr_t>(w) % 16 == 0;                        \
    return camp_tc::launch_tc<W4>(t, mt, splits,                             \
                                  static_cast<cudaStream_t>(stream));        \
  }
