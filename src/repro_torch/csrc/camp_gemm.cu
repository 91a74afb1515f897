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
// (K/2, N) (K6a, K6b), with column scales (1, N) f32. A packed byte holds
// k = 2i in its low nibble and k = 2i + 1 in its high nibble, both
// sign-extended (the reference's _unpack_k_rows and _unpack_k_cols). The
// output is acc * (s_a * s_b) followed by the epilogue stages, the same
// flush as K1. These are the unfused path's witnesses that the fused
// kernels equal quantize-then-GEMM, bit for bit.
//
// What bounds them on this card: the bytes of A and B over HBM bandwidth
// at every serving shape (M 8 or 256; 2 M K N int8 operations are far
// below the tensor cores' rate: 2.2 G at the largest, 1.1 us at 1,979
// TOP/s, against 1.8 us for its 6 MB). Packed operands cost half a byte
// per value in memory and are unpacked to int8 on chip: Hopper has no
// int4 MMA operand, and the TPU kernels too unpack before an int8 dot.
//
// All three run on the tensor-core template (camp_gemm_tc.cuh), as K1 and
// K4 do: wgmma s8 x s8 -> s32 with A and B^T K-major in swizzled shared
// memory, B rewritten K-major on chip (a __byte_perm 4 x 4 transpose for
// int8, the nibble unpack for int4), a ring of TMA-loaded stages three to
// six K steps ahead, and split-K over about one block an SM: each split's
// exact int32 partial sums in their own workspace plane, added in split
// order and flushed once per output by a second kernel over the whole
// card. int8 A arrives by TMA with B; K6b's packed A is loaded one K step
// ahead into registers and unpacked into the swizzled int8 A slot, as
// K1/K4 quantize x there. So the bytes stream from HBM on every SM while
// the products run on the tensor cores.
#include "camp_gemm_common.cuh"
#include "camp_gemm_tc.cuh"

CAMP_GEMM_TC_ENTRY(camp_gemm_i8, false, 0, false)
CAMP_GEMM_TC_ENTRY(camp_gemm_w4, true, 0, false)
CAMP_GEMM_TC_ENTRY(camp_gemm_a4w4, true, 0, true)

// Dynamic shared memory, in bytes, of one block of the tensor-core
// instances with packed-int4 B (w4 != 0) or int8 B and row tile mt (the
// same for every A kind).
extern "C" int camp_gemm_tc_smem(int w4, int mt) {
  return camp_tc::smem_bytes(w4 != 0, mt);
}
