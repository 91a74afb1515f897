// Shared device code of the two paged-attention kernels (K2 paged prefill,
// K3 paged decode): one block attends a tile of up to BQ query rows of one
// kv head over int8 pages reached through a block table, with per-token
// dequantization and an online softmax.
//
// Query row r of the tile sits at token position pos0 + (rg0 + r) / G (G
// query heads share a kv head); it sees every cached token at a position
// <= its own. The block walks pages 0 .. floor(last_pos / ps) only, where
// last_pos is the tile's last row's position, so it never reads a table
// slot past the causal bound. Each step stages `pp` pages: int8 rows times
// their per-token scales, dequantized once into shared memory and shared by
// all BQ rows. Masked scores are -1e30 and the final division uses
// max(l, 1e-30), as the reference does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int BQ = 32;           // query rows per block
constexpr int THREADS = 256;
constexpr int MAX_HD = 128;
constexpr int MAX_ACC = BQ * MAX_HD / THREADS;   // (row, dim) pairs per thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared memory in floats for a tile of kt = pp * ps staged tokens.
__host__ __device__ inline size_t smem_floats(int hd, int kt) {
  return (size_t)BQ * hd + (size_t)kt * (hd + 1) + (size_t)kt * hd +
         (size_t)BQ * kt + 3 * BQ;
}

template <typename T>
__device__ void attend(const T* __restrict__ q, T* __restrict__ out,
                       int n_rows, int pos0, int rg0, int G,
                       const int8_t* __restrict__ kp,
                       const int8_t* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table, int KV, int h, int ps,
                       int hd, int pp, float sm_scale, float* smem) {
  const int kt = pp * ps;
  float* Qs = smem;                    // [BQ][hd]
  float* Ks = Qs + BQ * hd;            // [kt][hd + 1] (padded: no conflicts)
  float* Vs = Ks + kt * (hd + 1);      // [kt][hd]
  float* S = Vs + kt * hd;             // [BQ][kt] scores, then probabilities
  float* Ms = S + BQ * kt;             // running max
  float* Ls = Ms + BQ;                 // running sum
  float* Cs = Ls + BQ;                 // this step's correction factor
  const int tid = threadIdx.x;

  for (int i = tid; i < BQ * hd; i += THREADS)
    Qs[i] = (i / hd < n_rows) ? to_f(q[i]) : 0.f;
  for (int r = tid; r < BQ; r += THREADS) {
    Ms[r] = kNeg;
    Ls[r] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;
  const int last_pos = pos0 + (rg0 + n_rows - 1) / G;
  const int n_pages = last_pos / ps + 1;
  __syncthreads();

  for (int p0 = 0; p0 < n_pages; p0 += pp) {
    // Stage pp pages, dequantized per token; slots past n_pages are zero
    // (their positions exceed every row's, so they are masked anyway).
    for (int i = tid; i < kt * hd; i += THREADS) {
      const int t = i / hd, d = i % hd;
      const int p = p0 + t / ps;
      float kv = 0.f, vv = 0.f;
      if (p < n_pages) {
        const long row = ((long)table[p] * KV + h) * ps + (t % ps);
        kv = (float)kp[row * hd + d] * ks[row];
        vv = (float)vp[row * hd + d] * vs[row];
      }
      Ks[t * (hd + 1) + d] = kv;
      Vs[t * hd + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < BQ * kt; i += THREADS) {
      const int r = i / kt, t = i % kt;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += Qs[r * hd + d] * Ks[t * (hd + 1) + d];
      s = s * sm_scale;
      const int col = p0 * ps + t;
      const int row_pos = pos0 + (rg0 + r) / G;
      S[i] = (r < n_rows && col <= row_pos) ? s : kNeg;
    }
    __syncthreads();
    for (int r = tid; r < BQ; r += THREADS) {
      float mx = kNeg;
      for (int t = 0; t < kt; ++t) mx = fmaxf(mx, S[r * kt + t]);
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < kt; ++t) {
        const float e = expf(S[r * kt + t] - m_new);
        S[r * kt + t] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      Ls[r] = Ls[r] * corr + sum;
      Ms[r] = m_new;
      Cs[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int i = tid + a * THREADS;
      if (i < BQ * hd) {
        const int r = i / hd, d = i % hd;
        float v = acc[a] * Cs[r];
        for (int t = 0; t < kt; ++t) v += S[r * kt + t] * Vs[t * hd + d];
        acc[a] = v;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int i = tid + a * THREADS;
    if (i < BQ * hd && i / hd < n_rows)
      store(out + i, acc[a] / fmaxf(Ls[i / hd], 1e-30f));
  }
}

// Launch helper: opt in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

}  // namespace paged
