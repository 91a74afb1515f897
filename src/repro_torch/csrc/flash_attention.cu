// K8: dense flash attention (causal or not, online softmax) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (reached through the pallas_call at flash_attention.py:88).
//
// Computes, for q, k, v (BH, S, D) contiguous, D a multiple of 8 up to 128:
// scores = (q . k) in f32 times D^-0.5; causal: column c visible from row r
// when r >= c, masked scores -1e30; an online softmax with m, l and acc in
// f32; p rounded to v's dtype before the PV product; out = acc / max(l,
// 1e-30) in q's dtype. A ragged last tile (S not a multiple of 64) is
// masked: its columns score -1e30 and its rows are not stored.
//
// What bounds it on this card: at the long-prefill shapes (S = 4,096 to
// 32,768, D = 64, 14 heads) the work is 4 * BH * S^2 * D operations (half
// that causal) against 4 * BH * S * D values of traffic, thousands of
// operations a byte: it is bound by operations. So the bf16 path runs both
// products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), and the score tile, the softmax statistics and the output
// accumulator live in registers: device memory sees q, k, v and the output
// once each per query tile, as in the TPU kernel, which kept them in VMEM.
// The f32 path runs on the CUDA cores (TF32 would not hold the reference's
// 2e-5), with the tiles in shared memory.
//
// Design (a simple first version; no wgmma, TMA or warp specialisation):
// one block per (head, 64-row query tile); K and V tiles of 64 rows are
// staged in shared memory, V transposed so that the PV product's operand
// pairs are contiguous; the kv loop stops at the causal bound of the
// tile's last row, so tiles wholly above the diagonal are never loaded.
// The first tile holds column 0, so no row sees only masked scores. Query
// tiles are issued heaviest first (the last tile of a causal run does the
// most work), so the tail of the grid is short.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // kv rows per staged tile
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores. 4 warps, 16 query rows each.
// ---------------------------------------------------------------------------
constexpr int BF_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half (the fragment
// element with the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8):             c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// The score accumulator of two adjacent n-tiles is, element for element, the
// A fragment of the PV product, so p never leaves the registers.
template <int DP>
__global__ void __launch_bounds__(BF_THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int S, int D, int causal,
                  float scale) {
  constexpr int KST = DP + 8;    // K tile row stride: conflict-free b loads
  constexpr int VST = BK + 8;    // V^T tile row stride
  constexpr int NC = DP / 8;     // 16-byte chunks in a padded row
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KST];
  __shared__ __align__(16) __nv_bfloat16 Vt[DP * VST];

  const int tile = gridDim.y - 1 - blockIdx.y;    // heaviest tiles first
  const int q0 = tile * BQ;
  const long base = (long)blockIdx.x * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;

  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const int c0 = kc * 16 + 2 * t, c1 = c0 + 8;
    qa[kc][0] = (r_lo < S && c0 < D) ? ld32(q + base + (long)r_lo * D + c0) : 0u;
    qa[kc][1] = (r_hi < S && c0 < D) ? ld32(q + base + (long)r_hi * D + c0) : 0u;
    qa[kc][2] = (r_lo < S && c1 < D) ? ld32(q + base + (long)r_lo * D + c1) : 0u;
    qa[kc][3] = (r_hi < S && c1 < D) ? ld32(q + base + (long)r_hi * D + c1) : 0u;
  }

  float o[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;  // l: this thread's share

  const int last_row = min(q0 + BQ, S) - 1;
  const int n_tiles = causal ? last_row / BK + 1 : (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();                 // the previous tile's readers are done
    // K: row-major, 16 bytes a thread, neighbouring threads on one row
    for (int i = threadIdx.x; i < BK * NC; i += BF_THREADS) {
      const int r = i / NC, c = (i % NC) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S && c < D)
        x = *reinterpret_cast<const uint4*>(k + base + (long)(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(&Ks[r * KST + c]) = x;
    }
    // V, transposed: neighbouring threads on neighbouring rows, so the
    // 2-byte stores of one column land in consecutive banks
    for (int i = threadIdx.x; i < BK * NC; i += BF_THREADS) {
      const int r = i % BK, c = (i / BK) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S && c < D)
        x = *reinterpret_cast<const uint4*>(v + base + (long)(k0 + r) * D + c);
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * VST + r] = xe[e];
    }
    __syncthreads();

    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        const __nv_bfloat16* kr = &Ks[(nt * 8 + g) * KST + kc * 16 + 2 * t];
        mma_bf16(sc[nt], qa[kc], ld32(kr), ld32(kr + 8));
      }
    }

    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + nt * 8 + 2 * t + e;
        const bool in = col < S;
        float s_lo = sc[nt][e] * scale, s_hi = sc[nt][2 + e] * scale;
        if (!in || (causal && r_lo < col)) s_lo = kNeg;
        if (!in || (causal && r_hi < col)) s_hi = kNeg;
        sc[nt][e] = s_lo;
        sc[nt][2 + e] = s_hi;
        mx_lo = fmaxf(mx_lo, s_lo);
        mx_hi = fmaxf(mx_hi, s_hi);
      }
    }
    // the four lanes of a quad hold one row between them
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = expf(sc[nt][e] - mn_lo);
        sc[nt][2 + e] = expf(sc[nt][2 + e] - mn_hi);
        sum_lo += sc[nt][e];
        sum_hi += sc[nt][2 + e];
      }
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      o[dt][0] *= corr_lo;
      o[dt][1] *= corr_lo;
      o[dt][2] *= corr_hi;
      o[dt][3] *= corr_hi;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const __nv_bfloat16* vr = &Vt[(dt * 8 + g) * VST + kc * 16 + 2 * t];
        mma_bf16(o[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, w);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, w);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c >= D) continue;
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(out + base + (long)r_lo * D + c) =
          pack_bf16(o[dt][0] / d_lo, o[dt][1] / d_lo);
    if (r_hi < S)
      *reinterpret_cast<uint32_t*>(out + base + (long)r_hi * D + c) =
          pack_bf16(o[dt][2] / d_hi, o[dt][3] / d_hi);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. 256 threads as 16 x 16; thread (ty, tx) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 c (c < DP / 16). The 16 threads of one ty are one half-warp.
// ---------------------------------------------------------------------------
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

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bf16,
           int BH, int S, int D, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(BH, (S + BQ - 1) / BQ);
  if (bf16) {
    flash_bf16_kernel<DP><<<grid, BF_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), S, D, causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = f32_smem_floats(DP) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_f32_kernel<DP><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, D, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (BH, S, D) contiguous, 16-byte aligned, bf16 (bf16 != 0) or
// f32; D a multiple of 8, at most 128. Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bf16, int BH, int S, int D,
                               int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  if (D <= 32) return launch<32>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  if (D <= 64) return launch<64>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
  return launch<128>(q, k, v, out, bf16, BH, S, D, causal, scale, s);
}
