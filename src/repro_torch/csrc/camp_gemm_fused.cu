// K1 and K4: fused activation quantize + integer GEMM + epilogue, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/camp_gemm_fused.py::_fused_kernel
// (reached through camp_gemm_fused_w8a8 / _w4a8 / _w4a4 at
// camp_gemm_fused.py:108; unpack_b=True unpacks with camp_gemm_w4.py:33),
// together with its flush src/repro/kernels/epilogue.py::flush_epilogue.
//
//   camp_gemm_fused_w8a8  x (M, K) bf16/f32 quantized to [-127, 127],
//                         W (K, N) int8                            (K1)
//   camp_gemm_fused_w4a8  the same with W packed int4 (K/2, N)     (K4)
//   camp_gemm_fused_w4a4  W packed int4, x quantized to [-7, 7]    (K4)
//
// What bounds them on this card: at the serving shapes (M = batch 1-8 in
// decode, M = chunk 256 in prefill, M = 4,096 in the dense prefill;
// (K, N) in {(896, 896), (896, 128), (896, 4864), (4864, 896)}) the least
// time is the bytes of W over HBM bandwidth (one byte per weight for K1,
// half a byte for K4), and of x at M 4,096; the product itself (2MNK int8
// operations) is below the tensor cores' rate everywhere but the dense
// prefill.
//
// They run on the tensor-core template of K5/K6a (camp_gemm_tc.cuh, which
// states the design), with x in place of int8 A: each row's scale from its
// whole K row (the block's own warps at row tiles 8 and 32, a scale pass
// kernel before the product at 128), then every K step of x loaded one
// step ahead into registers and quantized by the reference's f32 chain
// straight into the swizzled int8 A slot that the wgmma descriptors read.
// The TPU kernel kept the whole K row of x resident in VMEM; here only the
// M row scales reach device memory (for the flush), never the int8
// activations. B streams from HBM by TMA on every SM, rewritten K-major on
// chip (int4: unpacked and sign-extended), into wgmma s8 x s8 -> s32;
// split-K brings the grid to about one block an SM, and a flush kernel
// (or, with one split and a full card, the product block itself) applies
// the scales and the epilogue once per output.
#include "camp_gemm_tc.cuh"

CAMP_GEMM_TC_ENTRY(camp_gemm_fused_w8a8, false, 127, false)
CAMP_GEMM_TC_ENTRY(camp_gemm_fused_w4a8, true, 127, false)
CAMP_GEMM_TC_ENTRY(camp_gemm_fused_w4a4, true, 7, false)
