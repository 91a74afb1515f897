// The rowwise quantize's f32 chain, one source for every kernel that runs
// it: K7 (quantize.cu) and the fused prologue and scale pass of K1/K4
// (camp_gemm_tc.cuh). Each reproduces the reference as XLA compiles it:
//   s[m] = absmax_k |x[m, k]| * f32(1/QMAX)        (1 where absmax is 0)
//   q[m, k] = clamp(rint(x[m, k] / s[m]), -QMAX, QMAX)
// (an IEEE quotient, rounded half to even; no fast-math), so
// quantize-then-GEMM equals the fused kernels bit for bit.
//
// x arrives in 16-byte groups: XB = 2, 8 bf16 values; XB = 4, 4 f32.
//
// Everything here has internal linkage (an anonymous namespace), as in
// hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace camp_quant {
namespace {

// Value e of a 16-byte group of x (XB 2: bf16, 8 values; XB 4: f32, 4).
template <int XB>
__device__ __forceinline__ float group_value(const uint32_t (&w)[4], int e) {
  if constexpr (XB == 2)
    return __uint_as_float((e & 1) ? (w[e >> 1] & 0xFFFF0000u)
                                   : (w[e >> 1] << 16));
  else
    return __uint_as_float(w[e]);
}

// The first `left` values of a group whose row is not 16-byte aligned,
// loaded one at a time; zeros after them.
template <int XB>
__device__ __forceinline__ uint4 gather_x(const uint8_t* src, int left) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16 / XB; ++e) {
    if (e >= left) break;
    if constexpr (XB == 2)
      w[e >> 1] |= (uint32_t)reinterpret_cast<const uint16_t*>(src)[e]
                   << (16 * (e & 1));
    else
      w[e] = reinterpret_cast<const uint32_t*>(src)[e];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The scale of a row whose absmax is amax: amax * f32(1/QMAX), 1 where it
// is 0.
template <int QMAX>
__device__ __forceinline__ float scale_of(float amax) {
  return amax == 0.f ? 1.f : __fmul_rn(amax, 1.0f / (float)QMAX);
}

// A row's scale from x[m, lo:hi) (the whole row but in the control), by
// one warp: the absmax, then scale_of. With xvec, lo and hi * XB are
// multiples of 16 bytes.
template <int QMAX, int XB>
__device__ __forceinline__ float row_scale(const uint8_t* x, long m, int K,
                                           int lo, int hi, int xvec,
                                           int lane) {
  const uint8_t* row = x + m * K * XB;
  float amax = 0.f;
  if (xvec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int g = lo * XB / 16 + lane; g < hi * XB / 16; g += 32) {
      const uint4 u = __ldg(v + g);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 16 / XB; ++e)
        amax = fmaxf(amax, fabsf(group_value<XB>(w, e)));
    }
  } else {
    for (int k = lo + lane; k < hi; k += 32) {
      const float v =
          XB == 2 ? __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(row)[k])
                  : reinterpret_cast<const float*>(row)[k];
      amax = fmaxf(amax, fabsf(v));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return scale_of<QMAX>(amax);
}

// A quotient that rounds this close to a half-integer (1/2 - 2^-14) is
// decided by the division itself (quantize_group).
constexpr float kNearHalf = 0.49993896484375f;
constexpr float kRoundMagic = 12582912.f;        // 1.5 * 2^23

// The low bytes of four words, in order.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The reference's chain for one value: clamp(rint(__fdiv_rn(v, s))) as an
// int8 bit pattern in the low byte.
template <int QMAX>
__device__ __forceinline__ uint32_t quantize_exact(float v, float s) {
  return (uint32_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -(float)QMAX),
                              (float)QMAX);
}

// A group by quantize_exact, value by value: int8 bytes in q[0] (and q[1]
// for bf16's 8 values).
template <int QMAX, int XB>
__device__ __forceinline__ void quantize_group_exact(const uint4& u, float s,
                                                     uint32_t (&q)[2]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t b[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16 / XB; ++e)
    b[e] = quantize_exact<QMAX>(group_value<XB>(w, e), s);
  q[0] = pack_low_bytes(b[0], b[1], b[2], b[3]);
  q[1] = pack_low_bytes(b[4], b[5], b[6], b[7]);
}

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

// A group of x quantized with row scale s's reciprocal r (1/s, rounded),
// as int8 bytes in q[0] (and q[1] for bf16's 8 values); false where the
// group must take the reference's chain instead (quantize_group_exact).
// The result is the reference's
//   clamp(rint(fl(v / s)), -QMAX, QMAX)
// with fl(v / s) the IEEE quotient, computed without a division or a
// conversion where that provably gives the same integer. The exact product
// p = v * r lies within 2^-24 |v / s| of v / s (r rounds once), and so
// does fl(v / s): within 2^-16 of each other, since |v| <= absmax gives
// |v / s| <= QMAX (1 + 2^-22). One fma rounds p to the integer n, half to
// even, by adding 1.5 * 2^23, whose float holds n in its low mantissa bits
// (its low byte is the int8); a second one gives p - n. If
// |p - n| <= 1/2 - 2^-14, fl(v / s) rounds to n too, and |n| <= QMAX
// leaves the clamp nothing to do. A group with a value near a
// half-integer (about one in 1,000 groups) or not finite returns false.
template <int QMAX, int XB>
__device__ __forceinline__ bool quantize_group(const uint4& u, float r,
                                               uint32_t (&q)[2]) {
  constexpr int NV = 16 / XB;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t b[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  float near[8];
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    const float v = group_value<XB>(w, e);
    const float tr = __fmaf_rn(v, r, kRoundMagic);
    near[e] = fabsf(__fmaf_rn(v, r, __fsub_rn(kRoundMagic, tr)));
    b[e] = __float_as_uint(tr);
  }
#pragma unroll
  for (int h = NV / 2; h > 0; h /= 2)
#pragma unroll
    for (int e = 0; e < h; ++e) near[e] = fmax_nan(near[e], near[e + h]);
  q[0] = pack_low_bytes(b[0], b[1], b[2], b[3]);
  q[1] = pack_low_bytes(b[4], b[5], b[6], b[7]);
  return near[0] <= kNearHalf;
}

// Whether a row whose reciprocal scale is r must take quantize_group_exact
// for every group: r is 0 or infinite (a scale that is infinite or
// subnormal), where the product proves nothing.
__device__ __forceinline__ bool exact_only(float r) {
  return !(r > 0.f && r <= 3.4028234663852886e38f);
}

}  // namespace
}  // namespace camp_quant
