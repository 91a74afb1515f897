// K5, K6a and K6b: integer GEMMs of pre-quantized activations, for Hopper
// (sm_90a).
//
// Replace the TPU kernels
//   camp_gemm_i8    src/repro/kernels/camp_gemm.py::_camp_gemm_kernel
//                   (camp_gemm_i8 at camp_gemm.py:121)              (K5)
//   camp_gemm_w4    src/repro/kernels/camp_gemm_w4.py::_camp_gemm_w4_kernel
//                   (camp_gemm_w4 at camp_gemm_w4.py:135)           (K6a)
//   camp_gemm_a4w4  src/repro/kernels/camp_gemm_w4.py::_camp_gemm_a4w4_kernel
//                   (camp_gemm_a4w4 at camp_gemm_w4.py:194)         (K6b)
// with their flush src/repro/kernels/epilogue.py::flush_epilogue.
//
// A is int8 (M, K) (K5, K6a) or int4 packed two per byte along K, (M, K/2)
// (K6b), with row scales (M, 1) f32; B is int8 (K, N) (K5) or packed int4
// (K/2, N) (K6a, K6b), with column scales (1, N) f32. The output is
// acc * (s_a * s_b) followed by the epilogue stages, the same flush as K1.
// These are the unfused path's witnesses that the fused kernels equal
// quantize-then-GEMM, bit for bit.
//
// What bounds them on this card: the bytes of A and B over HBM bandwidth
// at every serving shape (M 8 or 256; 2 M K N int8 operations are far
// below the tensor cores' rate: 2.2 G at the largest, 1.1 us at 1,979
// TOP/s, against 1.8 us for its 6 MB). Packed operands cost half a byte
// per value in memory and are unpacked to int8 on chip: Hopper has no
// int4 MMA operand, and the TPU kernels too unpack before an int8 dot.
//
// K5 and K6a run on the tensor-core template (camp_gemm_tc.cuh), as K1 and
// K4 do: wgmma s8 x s8 -> s32 with A and B^T K-major in swizzled shared
// memory, B rewritten K-major on chip (a __byte_perm 4 x 4 transpose for
// int8, the nibble unpack for int4), a ring of TMA-loaded stages three to
// six K steps ahead, and split-K over about one block an SM: each split's
// exact int32 partial sums in their own workspace plane, added in split
// order and flushed once per output by a second kernel over the whole
// card. So the bytes stream from HBM on every SM while the products run on
// the tensor cores.
//
// K6b is still the simple dp4a kernel below: a block takes 32 x 64
// outputs, unpacks a 64-wide K tile of both operands into int8 words in
// shared memory, and accumulates with __dp4a (4 MACs an instruction, int32:
// 7 * 7 * K is far below 2^31). The K loop is a synchronous global-load,
// shared-store, dp4a round trip per tile, which the loop's latency, not
// the bytes, bounds. A packed byte holds k = 2i in its low nibble and
// k = 2i + 1 in its high nibble, both sign-extended (the reference's
// _unpack_k_rows and _unpack_k_cols); K is even and a tile is 64 wide, so
// a tile never splits a byte. Ragged edges are masked in the kernel.
#include "camp_gemm_common.cuh"
#include "camp_gemm_tc.cuh"

CAMP_GEMM_TC_ENTRY(camp_gemm_i8, false, 0)
CAMP_GEMM_TC_ENTRY(camp_gemm_w4, true, 0)

namespace {

constexpr int BM = 32;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // K per shared-memory tile (even)
constexpr int KW = BK / 4;       // packed int32 words per tile row
constexpr int THREADS = 256;     // 16 x 16 threads, 2 x 4 outputs each

// The two sign-extended nibbles of a packed byte, as int8 bit patterns in
// bytes j and j + 1 of a dp4a word.
__device__ __forceinline__ uint32_t unpack_pair(uint8_t b, int j) {
  const int8_t lo = (int8_t)(uint8_t)(b << 4) >> 4;
  const int8_t hi = (int8_t)b >> 4;
  return ((uint32_t)(uint8_t)lo << (8 * j)) |
         ((uint32_t)(uint8_t)hi << (8 * (j + 1)));
}

__global__ void __launch_bounds__(THREADS)
camp_gemm_a4w4_kernel(const camp::GemmArgs p) {
  __shared__ int32_t As[BM][KW];       // int8 A tile, 4 k per word
  __shared__ int32_t Bs[BN][KW + 1];   // int8 B tile, transposed, padded row
  __shared__ float sa[BM];             // per-row activation scales

  const int tid = threadIdx.x;
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int r = tid; r < BM; r += THREADS)
    sa[r] = (m0 + r < M) ? p.sa[m0 + r] : 1.f;
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 4 consecutive k of one row into one word.
    for (int i = tid; i < BM * KW; i += THREADS) {
      const int r = i / KW, kw = i % KW;
      const int m = m0 + r, kb = k0 + kw * 4;
      uint32_t word = 0;
      if (m < M) {
        const uint8_t* a =
            static_cast<const uint8_t*>(p.a) + (long)m * (K / 2);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (kb + j < K) word |= unpack_pair(a[(kb + j) / 2], j);
        }
      }
      As[r][kw] = (int32_t)word;
    }
    // B tile: 4 consecutive k of one column into one word (n fastest, so
    // neighbouring threads read neighbouring bytes).
    for (int i = tid; i < BN * KW; i += THREADS) {
      const int c = i % BN, kw = i / BN;
      const int n = n0 + c, kb = k0 + kw * 4;
      uint32_t word = 0;
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (kb + j < K)
            word |= unpack_pair((uint8_t)p.w[(long)((kb + j) / 2) * N + n],
                                j);
        }
      }
      Bs[c][kw] = (int32_t)word;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      const int a0 = As[ty * 2][kw], a1 = As[ty * 2 + 1][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = Bs[tx + 16 * j][kw];
        acc[0][j] = __dp4a(a0, b, acc[0][j]);
        acc[1][j] = __dp4a(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }

  // Flush: Cartesian scale (scale product first), stages, one store.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i, m = m0 + r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float y = camp::flush_one(p, m, n, acc[i][j], sa[r]);
      const long o = (long)m * N + n;
      if (p.out_bf16)
        static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(p.out)[o] = y;
    }
  }
}

}  // namespace

// K6b's entry (kernels/camp_gemm.py::launch_gemm binds it): the flush's
// arguments, then the stream.
extern "C" int camp_gemm_a4w4(const void* a, int a_bf16, const void* sa,
                              const void* w, const void* sb, const void* bias,
                              int bias_bf16, const void* opd, int opd_bf16,
                              void* out, int out_bf16, int M, int N, int K,
                              int stages, int n_stages, void* stream) {
  const camp::GemmArgs p{a,         a_bf16,
                         static_cast<const float*>(sa),
                         static_cast<const int8_t*>(w),
                         static_cast<const float*>(sb),
                         bias,      bias_bf16, opd, opd_bf16, out,
                         out_bf16,  M,         N,   K,        stages,
                         n_stages};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  camp_gemm_a4w4_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory, in bytes, of one block of the tensor-core
// instances with packed-int4 B (w4 != 0) or int8 B and row tile mt (the
// same for every A kind).
extern "C" int camp_gemm_tc_smem(int w4, int mt) {
  return camp_tc::smem_bytes(w4 != 0, mt);
}
