// K1 and K4: fused activation quantize + integer GEMM + epilogue, for Hopper
// (sm_90a).
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
// The kernel itself is camp::camp_gemm_kernel (camp_gemm_common.cuh, shared
// with the unfused K5/K6 in camp_gemm.cu); its header states the arithmetic.
//
// What bounds it on this card: at the serving shapes (M = batch 1-8 in
// decode, M = chunk 256 in prefill; (K, N) in {(896, 896), (896, 128),
// (896, 4864), (4864, 896)}) the least time is the bytes of W over HBM
// bandwidth (one byte per weight for K1, half a byte for K4); the product
// itself (2MNK int8 operations) is far below the tensor cores' rate. The
// TPU kernel kept the whole K row of A resident in VMEM; here a prologue
// pass over K computes each row's absmax and A is quantized tile by tile
// inside the K loop, so the quantized activations never reach device
// memory. K4 reads W packed, half K1's bytes, and unpacks each tile in
// shared memory. This is the simple first version: wgmma, TMA and a split-K
// for decode shapes are later work.
#include "camp_gemm_common.cuh"

CAMP_GEMM_ENTRY(camp_gemm_fused_w8a8, camp::kAFloat, false, 127)
CAMP_GEMM_ENTRY(camp_gemm_fused_w4a8, camp::kAFloat, true, 127)
CAMP_GEMM_ENTRY(camp_gemm_fused_w4a4, camp::kAFloat, true, 7)
