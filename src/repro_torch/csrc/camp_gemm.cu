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
// The kernel is camp::camp_gemm_kernel (camp_gemm_common.cuh), the one K1
// and K4 use, with A read from memory instead of quantized in the kernel:
// these are the unfused path's witnesses that the fused kernels equal
// quantize-then-GEMM, bit for bit.
//
// What bounds them on this card: the bytes of A and B over HBM bandwidth
// at the serving shapes (int8 operations far below the tensor cores'
// rate). Packed operands cost half a byte per value in memory and are
// unpacked into int8 tiles in shared memory before the __dp4a product. The
// same simple first version as K1: wgmma, TMA and split-K are later work.
#include "camp_gemm_common.cuh"

CAMP_GEMM_ENTRY(camp_gemm_i8, camp::kAInt8, false, 127)
CAMP_GEMM_ENTRY(camp_gemm_w4, camp::kAInt8, true, 127)
CAMP_GEMM_ENTRY(camp_gemm_a4w4, camp::kAInt4, true, 7)
