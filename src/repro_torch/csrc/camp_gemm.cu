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
// K5 and K6a run on the tensor-core template (camp_gemm_tc.cuh): wgmma
// s8 x s8 -> s32 with A and B^T K-major in swizzled shared memory, B
// rewritten K-major on chip (a __byte_perm 4 x 4 transpose for int8, the
// nibble unpack for int4), a ring of TMA-loaded stages three to six K
// steps ahead, and split-K over about one block an SM: each split's exact
// int32 partial sums in their own workspace plane, added in split order
// and flushed once per output by a second kernel over the whole card. So
// the bytes stream from HBM on every SM while the products run on the
// tensor cores.
//
// K6b stays on camp::camp_gemm_kernel (camp_gemm_common.cuh), the dp4a
// template K1 and K4 use: the K loop is a synchronous global-load,
// shared-store, dp4a round trip per 64-wide tile, which the loop's latency,
// not the bytes, bounds.
#include "camp_gemm_common.cuh"
#include "camp_gemm_tc.cuh"

CAMP_GEMM_TC_ENTRY(camp_gemm_i8, false)
CAMP_GEMM_TC_ENTRY(camp_gemm_w4, true)
CAMP_GEMM_ENTRY(camp_gemm_a4w4, camp::kAInt4, true, 7)

// Dynamic shared memory, in bytes, of one block of the tensor-core instance
// (K6a when w4 != 0, else K5) with row tile mt.
extern "C" int camp_gemm_tc_smem(int w4, int mt) {
  return camp_tc::smem_bytes(w4 != 0, mt);
}
