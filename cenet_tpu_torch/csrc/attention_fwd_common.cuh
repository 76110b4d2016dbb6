// Shared body of the two forward attention kernels (CUDA C++, sm_90a).
//
// One block computes BQ = 64 query rows of one (batch, head) for GROUPS
// softmax groups that share V:
//   GROUPS = 2 (diff_attention_fwd.cu, diff_attention_split_fwd.cu):
//                                        o = softmax(q1 k1^T) V - lam * softmax(q2 k2^T) V
//   GROUPS = 1 (attention_fwd.cu):       o = softmax(q k^T) V
// q is pre-scaled by the caller. Logits, maxima, sums and exponentials are
// fp32, and the output is accumulated in fp32.
//
// Two passes over the keys, in tiles of BK = 64 staged in shared memory:
//   pass 1  computes each row's max m and sum l = sum exp(s - m) with a
//           per-tile rescale (the running max changes at most once per tile);
//   pass 2  recomputes the logits and accumulates w V, where
//             GROUPS = 2: w = exp(s1 - m1) / l1 - lam * exp(s2 - m2) / l2,
//                         formed in fp32 and rounded to V's dtype before the
//                         product, as the Pallas kernel does;
//             GROUPS = 1: w = exp(s - m), rounded to V's dtype, and the fp32
//                         sum is divided by l at the end (deferred
//                         normalisation, as the Pallas kernel does).
// Both passes see whole rows, so the result is the full-row softmax of the
// Pallas kernels; only the summation order differs.
//
// The row log-sum-exp m + log(l) of each group is written as fp32 (B, H, N).
//
// Threads: 256 as a 16 x 16 grid (ty, tx). Thread (ty, tx) owns query rows
// ty*4 .. ty*4+3; for logits it owns keys tx + 16 j (j < 4) of a tile, for
// the output it owns value columns tx + 16 j (j < DV/16 rounded up). Row
// statistics are reduced over the 16 tx lanes of a half-warp with shuffles.
// The ragged edges (N, M not multiples of 64; any d) are bounds checks: rows
// past N are computed on zeros and not stored, keys past M get w = 0 and zero
// V rows.
//
// Layouts: group g reads q_g (B, Hv, N, D) and k_g (B, Hv, M, D) from a base
// pointer and a (batch, head, row) stride triple of its own, and every group
// reads v (B, Hv, M, DV); all have unit stride on the last dim. So the split
// operands of diff_attention_split_fwd.cu (q1/k1/q2/k2, any views) and the
// interleaved layout of diff_attention_fwd.cu (group g of head pair p at head
// 2p + g of one tensor: base + g head strides, head stride doubled) are the
// same kernel. o is (B, Hv, N, DV) contiguous in q's dtype.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cenet {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LD = 65;        // padded leading dim of the transposed tiles
constexpr int MAX_D = 128;    // largest head dim of q/k
constexpr int MAX_DV = 128;   // largest head dim of v

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
// round an fp32 value to T and back (the cast of w to V's dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

struct Strides {
  long long b, h, n;
};

// base advanced by `elems` elements of the kernel's dtype (group 2's view of
// an interleaved tensor starts one head stride in)
inline const void* offset(const void* base, long long elems, int is_bf16) {
  return static_cast<const char*>(base) + elems * (is_bf16 ? 2 : 4);
}

struct Params {
  const void* q[2];  // per group (group 2 for GROUPS == 2 only)
  const void* k[2];
  const void* v;
  const float* lam;  // device scalar (GROUPS == 2 only)
  void* o;
  float* lse1;
  float* lse2;
  int B, Hv, N, M, D, DV;
  Strides sq[2], sk[2], sv;
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline size_t smem_bytes(int groups, int D, int DV) {
  // Qt, Kt per group (D x LD each), V tile (BK x DV), Wt (BK x LD)
  return sizeof(float) * (size_t(2 * groups * D * LD) + size_t(BK * DV) + size_t(BK * LD));
}

// JV: value columns per thread (tx + 16 j, j < JV), so DV <= 16 * JV
template <typename T, int GROUPS, int JV>
__global__ void __launch_bounds__(THREADS) attention_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, DV = p.DV, N = p.N, M = p.M;
  float* Qt = smem;                      // [GROUPS][D][LD]   Qt[g][e][r]
  float* Kt = Qt + GROUPS * D * LD;      // [GROUPS][D][LD]   Kt[g][e][c]
  float* Vs = Kt + GROUPS * D * LD;      // [BK][DV]
  float* Wt = Vs + BK * DV;              // [BK][LD]          Wt[c][r]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;           // v head (= head pair for GROUPS == 2)
  const int b = blockIdx.z;
  const T* v = static_cast<const T*>(p.v);
  float lam = 0.f;
  if constexpr (GROUPS == 2) lam = *p.lam;

  // ---- stage this block's query rows, transposed: Qt[g][e][r]
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const T* qg = static_cast<const T*>(p.q[g]) + b * p.sq[g].b + (long long)head * p.sq[g].h;
    for (int idx = tid; idx < BQ * D; idx += THREADS) {
      const int e = idx % D, r = idx / D;
      const int n = q0 + r;
      Qt[(g * D + e) * LD + r] = n < N ? to_f(qg[n * p.sq[g].n + e]) : 0.f;
    }
  }

  float m_run[GROUPS][4], l_run[GROUPS][4];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_run[g][i] = -INFINITY;
      l_run[g][i] = 0.f;
    }

  auto load_k = [&](int k0) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const T* kg = static_cast<const T*>(p.k[g]) + b * p.sk[g].b + (long long)head * p.sk[g].h;
      for (int idx = tid; idx < BK * D; idx += THREADS) {
        const int e = idx % D, c = idx / D;
        const int m = k0 + c;
        Kt[(g * D + e) * LD + c] = m < M ? to_f(kg[m * p.sk[g].n + e]) : 0.f;
      }
    }
  };

  // s[g][i][j]: logit of row ty*4+i against key tx+16j of the staged tile
  auto logits = [&](float (&s)[GROUPS][4][4]) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[g][i][j] = 0.f;
      const float* Qg = Qt + g * D * LD;
      const float* Kg = Kt + g * D * LD;
      for (int e = 0; e < D; ++e) {
        float qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = Qg[e * LD + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = Kg[e * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[g][i][j] = fmaf(qa[i], ka[j], s[g][i][j]);
      }
    }
  };

  // ---- pass 1: row max and sum of exponentials
  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    float s[GROUPS][4][4];
    logits(s);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tx + 16 * j < M) tmax = fmaxf(tmax, s[g][i][j]);
        tmax = half_warp_max(tmax);
        const float m_new = fmaxf(m_run[g][i], tmax);  // finite: every tile has a key
        float tsum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tx + 16 * j < M) tsum += __expf(s[g][i][j] - m_new);
        tsum = half_warp_sum(tsum);
        l_run[g][i] = l_run[g][i] * __expf(m_run[g][i] - m_new) + tsum;
        m_run[g][i] = m_new;
      }
  }

  float inv_l[GROUPS][4];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) inv_l[g][i] = 1.f / l_run[g][i];

  // ---- pass 2: o = w V
  float acc[4][JV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JV; ++j) acc[i][j] = 0.f;

  const T* vh = v + b * p.sv.b + (long long)head * p.sv.h;
  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();
    load_k(k0);
    for (int idx = tid; idx < BK * DV; idx += THREADS) {
      const int e = idx % DV, c = idx / DV;
      const int m = k0 + c;
      Vs[c * DV + e] = m < M ? to_f(vh[m * p.sv.n + e]) : 0.f;
    }
    __syncthreads();
    float s[GROUPS][4][4];
    logits(s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w = __expf(s[0][i][j] - m_run[0][i]);
        if constexpr (GROUPS == 2)
          w = w * inv_l[0][i] - lam * (__expf(s[1][i][j] - m_run[1][i]) * inv_l[1][i]);
        if (k0 + tx + 16 * j >= M) w = 0.f;
        Wt[(tx + 16 * j) * LD + ty * 4 + i] = round_to<T>(w);
      }
    __syncthreads();
    const int kn = min(BK, M - k0);
    for (int c = 0; c < kn; ++c) {
      float wa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wa[i] = Wt[c * LD + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < JV; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < DV ? Vs[c * DV + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wa[i], vv, acc[i][j]);
      }
    }
  }

  // ---- epilogue: o in q's dtype, fp32 LSE
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    T* orow = o + (((long long)b * p.Hv + head) * N + n) * DV;
#pragma unroll
    for (int j = 0; j < JV; ++j) {
      const int col = tx + 16 * j;
      if (col < DV) orow[col] = from_f<T>(GROUPS == 2 ? acc[i][j] : acc[i][j] / l_run[0][i]);
    }
    if (tx == 0) {
      const long long li = ((long long)b * p.Hv + head) * N + n;
      p.lse1[li] = m_run[0][i] + logf(l_run[0][i]);
      if constexpr (GROUPS == 2) p.lse2[li] = m_run[1][i] + logf(l_run[1][i]);
    }
  }
}

template <typename T, int GROUPS, int JV>
inline int launch_jv(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(GROUPS, p.D, p.DV);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, GROUPS, JV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + BQ - 1) / BQ, p.Hv, p.B);
  attention_fwd_kernel<T, GROUPS, JV><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Returns the launch's cudaError_t (0 on success); the kernel runs on `stream`.
template <typename T, int GROUPS>
inline int launch(const Params& p, cudaStream_t stream) {
  if (p.D < 1 || p.D > MAX_D || p.DV < 1 || p.DV > MAX_DV || p.N < 1 || p.M < 1)
    return (int)cudaErrorInvalidValue;
  // the fewest value columns per thread that cover DV (16, 32, 40, 64, 128 on
  // the main path), so no FMA runs on a column past DV
  if (p.DV <= 16) return launch_jv<T, GROUPS, 1>(p, stream);
  if (p.DV <= 32) return launch_jv<T, GROUPS, 2>(p, stream);
  if (p.DV <= 48) return launch_jv<T, GROUPS, 3>(p, stream);
  if (p.DV <= 64) return launch_jv<T, GROUPS, 4>(p, stream);
  return launch_jv<T, GROUPS, 8>(p, stream);
}

}  // namespace cenet
