// Shared body of the two backward attention kernels (CUDA C++, sm_90a).
//
// GROUPS softmax groups share V, as in attention_fwd_common.cuh:
//   GROUPS = 2 (diff_attention_bwd.cu):  o = P1 V - lam * P2 V
//   GROUPS = 1 (attention_bwd.cu):       o = P V
// with P_g = exp(q_g k_g^T - lse_g) recomputed from the forward's fp32 row
// log-sum-exp, and G = dO V^T. Per group:
//   GROUPS = 1: ds = P (G - Delta), Delta = rowsum(dO o) given by the caller;
//   GROUPS = 2: ds_g = P_g (G - delta_g), delta_g = rowsum(P_g G), computed here
//               (o mixes the groups, so rowsum(dO o) is not delta_g).
//   dq_g = c_g round(ds_g) k_g,  dk_g = c_g round(ds_g)^T q_g,  c_1 = 1, c_2 = -lam;
//   dv   = round(w)^T dO with w = P (GROUPS = 1) or P1 - lam P2 (GROUPS = 2).
// "round" is the cast to the operands' dtype that the Pallas kernels make
// before each product; logits, P, G, ds and delta are fp32, and every product
// accumulates in fp32, cast to the output dtype once at the end.
//
// Two kernels, so that every output element is written by one block, with no
// atomics and no sum carried across blocks (blocks run in no order):
//   dq kernel   one block per BQ = 64 query rows of one (batch, head pair),
//               looping over key tiles of BK = 64. For GROUPS = 2 a first pass
//               over the keys computes delta_g and writes it out (the caller
//               sums -delta_2 into dlam), a second forms ds_g and dq_g.
//   dkv kernel  one block per 64 key rows, looping over query tiles and
//               recomputing P_g from the LSE; launched after the dq kernel on
//               the same stream, so delta_g is there.
// Threads: 256 as a 16 x 16 grid (ty, tx). For logits a thread owns 4 rows
// (ty*4 + i) of the block's own side against 4 columns (tx + 16 j) of the
// streamed tile; for the products it owns 4 rows against the output columns
// tx + 16 j (j < J, J*16 >= max(D, DV)). Tiles are staged transposed in shared
// memory as fp32 (X[e*LD + row]); ds and w go through one shared buffer,
// group by group. Ragged edges: rows past N and keys past M are staged as
// zeros, get P = 0 and are not stored.
//
// Layouts: q, k (B, GROUPS*Hv, N|M, D), v (B, Hv, M, DV), dO (B, Hv, N, DV)
// with arbitrary batch/head/row strides and unit stride on the last dim;
// lse_g and delta_g (B, Hv, N) fp32 contiguous; dq, dk, dv contiguous in the
// dtype of q.

#pragma once

#include "attention_fwd_common.cuh"

namespace cenet {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lam;    // device scalar (GROUPS == 2 only)
  const float* lse1;   // (B, Hv, N)
  const float* lse2;   // GROUPS == 2 only
  float* delta1;       // GROUPS == 1: Delta, read; GROUPS == 2: delta_1, written by the dq kernel
  float* delta2;       // GROUPS == 2 only: delta_2, written by the dq kernel
  void* dq;
  void* dk;
  void* dv;
  int B, Hv, N, M, D, DV;
  Strides sq, sk, sv, so;
};

// dst[e*LD + r] = src[(row0 + r)*stride + e] for the tile's 64 rows, zero past `rows`
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* src, long long stride, int row0, int rows, int E,
                                        int tid) {
  for (int idx = tid; idx < 64 * E; idx += THREADS) {
    const int e = idx % E, r = idx / E;
    const int n = row0 + r;
    dst[e * LD + r] = n < rows ? to_f(src[n * stride + e]) : 0.f;
  }
}

// s[i][j] = sum_e A[e*LD + ty*4 + i] * B[e*LD + tx + 16 j]
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int E, int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int e = 0; e < E; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[e * LD + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[e * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_{c < n} S[c*LD + ty*4 + i] * X[(tx + 16 j)*LD + c] for columns tx + 16 j < E
template <int J>
__device__ __forceinline__ void tile_acc(const float* S, const float* X, int n, int E, int ty, int tx,
                                         float (&acc)[4][J]) {
  for (int c = 0; c < n; ++c) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = S[c * LD + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = tx + 16 * j;
      const float x = col < E ? X[col * LD + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], x, acc[i][j]);
    }
  }
}

inline size_t bwd_smem_bytes(int groups, int D, int DV) {
  // two transposed tiles per group (D x LD), two of V/dO (DV x LD), the ds/w
  // buffer (64 x LD) and 2*groups rows of statistics
  return sizeof(float) * (size_t(2 * groups * D * LD) + size_t(2 * DV * LD) + size_t(64 * LD) + size_t(2 * groups * 64));
}

template <typename T, int GROUPS, int J>
__global__ void __launch_bounds__(THREADS) attention_bwd_dq_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, DV = p.DV, N = p.N, M = p.M;
  float* Qt = smem;                   // [GROUPS][D][LD]  q rows of this block
  float* Ot = Qt + GROUPS * D * LD;   // [DV][LD]         dO rows of this block
  float* Kt = Ot + DV * LD;           // [GROUPS][D][LD]  key tile
  float* Vt = Kt + GROUPS * D * LD;   // [DV][LD]         value tile
  float* Sh = Vt + DV * LD;           // [BK][LD]         round(ds)[c][r]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  float lam = 0.f;
  if constexpr (GROUPS == 2) lam = *p.lam;

  for (int g = 0; g < GROUPS; ++g)
    stage_t(Qt + g * D * LD, q + b * p.sq.b + (long long)(GROUPS * head + g) * p.sq.h, p.sq.n, q0, N, D, tid);
  stage_t(Ot, dout + b * p.so.b + (long long)head * p.so.h, p.so.n, q0, N, DV, tid);

  // row statistics of rows ty*4 + i, in registers (zero past N)
  const long long row0 = ((long long)b * p.Hv + head) * N;
  float lse[GROUPS][4], dl[GROUPS][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    lse[0][i] = n < N ? p.lse1[row0 + n] : 0.f;
    if constexpr (GROUPS == 1) dl[0][i] = n < N ? p.delta1[row0 + n] : 0.f;
    if constexpr (GROUPS == 2) lse[1][i] = n < N ? p.lse2[row0 + n] : 0.f;
  }

  auto load_kv = [&](int k0) {
    for (int g = 0; g < GROUPS; ++g)
      stage_t(Kt + g * D * LD, k + b * p.sk.b + (long long)(GROUPS * head + g) * p.sk.h, p.sk.n, k0, M, D, tid);
    stage_t(Vt, v + b * p.sv.b + (long long)head * p.sv.h, p.sv.n, k0, M, DV, tid);
  };

  // ---- GROUPS == 2, pass 1: delta_g = rowsum(P_g G)
  if constexpr (GROUPS == 2) {
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < M; k0 += BK) {
      __syncthreads();
      load_kv(k0);
      __syncthreads();
      float gg[4][4];
      tile_dot(Ot, Vt, DV, ty, tx, gg);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float s[4][4];
        tile_dot(Qt + g * D * LD, Kt + g * D * LD, D, ty, tx, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k0 + tx + 16 * j < M) part[g][i] += __expf(s[i][j] - lse[g][i]) * gg[i][j];
      }
    }
    float* dst[2] = {p.delta1, p.delta2};
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dl[g][i] = half_warp_sum(part[g][i]);
        const int n = q0 + ty * 4 + i;
        if (tx == 0 && n < N) dst[g][row0 + n] = dl[g][i];
      }
  }

  // ---- dq_g = c_g round(ds_g) k_g
  float acc[GROUPS][4][J];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[g][i][j] = 0.f;

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();
    load_kv(k0);
    __syncthreads();
    float gg[4][4];
    tile_dot(Ot, Vt, DV, ty, tx, gg);
    const int kn = min(BK, M - k0);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      float s[4][4];
      tile_dot(Qt + g * D * LD, Kt + g * D * LD, D, ty, tx, s);
      if (g > 0) __syncthreads();  // the previous group's ds is read
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float ds = __expf(s[i][j] - lse[g][i]) * (gg[i][j] - dl[g][i]);
          if (k0 + tx + 16 * j >= M) ds = 0.f;
          Sh[(tx + 16 * j) * LD + ty * 4 + i] = round_to<T>(ds);
        }
      __syncthreads();
      tile_acc<J>(Sh, Kt + g * D * LD, kn, D, ty, tx, acc[g]);
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const float c = g == 0 ? 1.f : -lam;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = q0 + ty * 4 + i;
      if (n >= N) continue;
      T* row = dq + (((long long)b * GROUPS * p.Hv + GROUPS * head + g) * N + n) * D;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = tx + 16 * j;
        if (col < D) row[col] = from_f<T>(c * acc[g][i][j]);
      }
    }
  }
}

template <typename T, int GROUPS, int J>
__global__ void __launch_bounds__(THREADS) attention_bwd_dkv_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, DV = p.DV, N = p.N, M = p.M;
  float* Kt = smem;                   // [GROUPS][D][LD]  key rows of this block
  float* Vt = Kt + GROUPS * D * LD;   // [DV][LD]         value rows of this block
  float* Qt = Vt + DV * LD;           // [GROUPS][D][LD]  query tile
  float* Ot = Qt + GROUPS * D * LD;   // [DV][LD]         dO tile
  float* Sh = Ot + DV * LD;           // [BQ][LD]         round(ds or w)[r][c]
  float* st = Sh + BQ * LD;           // [GROUPS][2][BQ]  lse_g, delta_g of the tile's rows

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BK;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  float lam = 0.f;
  if constexpr (GROUPS == 2) lam = *p.lam;

  for (int g = 0; g < GROUPS; ++g)
    stage_t(Kt + g * D * LD, k + b * p.sk.b + (long long)(GROUPS * head + g) * p.sk.h, p.sk.n, m0, M, D, tid);
  stage_t(Vt, v + b * p.sv.b + (long long)head * p.sv.h, p.sv.n, m0, M, DV, tid);

  const long long row0 = ((long long)b * p.Hv + head) * N;
  const float* lse_src[2] = {p.lse1, p.lse2};
  const float* dl_src[2] = {p.delta1, p.delta2};

  float acc_k[GROUPS][4][J], acc_v[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      acc_v[i][j] = 0.f;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) acc_k[g][i][j] = 0.f;
    }

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();
    for (int g = 0; g < GROUPS; ++g)
      stage_t(Qt + g * D * LD, q + b * p.sq.b + (long long)(GROUPS * head + g) * p.sq.h, p.sq.n, q0, N, D, tid);
    stage_t(Ot, dout + b * p.so.b + (long long)head * p.so.h, p.so.n, q0, N, DV, tid);
    for (int idx = tid; idx < GROUPS * BQ; idx += THREADS) {
      const int g = idx / BQ, r = idx % BQ, n = q0 + r;
      st[(2 * g) * BQ + r] = n < N ? lse_src[g][row0 + n] : 0.f;
      st[(2 * g + 1) * BQ + r] = n < N ? dl_src[g][row0 + n] : 0.f;
    }
    __syncthreads();
    const int rn = min(BQ, N - q0);

    // this thread: key rows ty*4 + i against query rows tx + 16 j of the tile
    float gg[4][4];
    tile_dot(Vt, Ot, DV, ty, tx, gg);
    float pr[GROUPS][4][4];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      float s[4][4];
      tile_dot(Kt + g * D * LD, Qt + g * D * LD, D, ty, tx, s);
      if (g > 0) __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          pr[g][i][j] = r < rn ? __expf(s[i][j] - st[(2 * g) * BQ + r]) : 0.f;
          Sh[r * LD + ty * 4 + i] = round_to<T>(pr[g][i][j] * (gg[i][j] - st[(2 * g + 1) * BQ + r]));
        }
      __syncthreads();
      tile_acc<J>(Sh, Qt + g * D * LD, rn, D, ty, tx, acc_k[g]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w = pr[0][i][j];
        if constexpr (GROUPS == 2) w -= lam * pr[1][i][j];
        Sh[(tx + 16 * j) * LD + ty * 4 + i] = round_to<T>(w);
      }
    __syncthreads();
    tile_acc<J>(Sh, Ot, rn, DV, ty, tx, acc_v);
  }

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const float c = g == 0 ? 1.f : -lam;
      T* row = dk + (((long long)b * GROUPS * p.Hv + GROUPS * head + g) * M + m) * D;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = tx + 16 * j;
        if (col < D) row[col] = from_f<T>(c * acc_k[g][i][j]);
      }
    }
    T* vrow = dv + (((long long)b * p.Hv + head) * M + m) * DV;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = tx + 16 * j;
      if (col < DV) vrow[col] = from_f<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int GROUPS, int J>
inline int bwd_launch_j(const BwdParams& p, cudaStream_t stream) {
  const int smem = (int)bwd_smem_bytes(GROUPS, p.D, p.DV);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, GROUPS, J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T, GROUPS, J>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<T, GROUPS, J><<<dim3((p.N + BQ - 1) / BQ, p.Hv, p.B), THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<T, GROUPS, J><<<dim3((p.M + BK - 1) / BK, p.Hv, p.B), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches the dq kernel, then the dkv kernel, on `stream`; returns the first
// launch's cudaError_t (0 on success).
template <typename T, int GROUPS>
inline int bwd_launch(const BwdParams& p, cudaStream_t stream) {
  if (p.D < 1 || p.D > MAX_D || p.DV < 1 || p.DV > MAX_DV || p.N < 1 || p.M < 1)
    return (int)cudaErrorInvalidValue;
  // the fewest output columns per thread that cover max(D, DV)
  const int w = p.D > p.DV ? p.D : p.DV;
  if (w <= 16) return bwd_launch_j<T, GROUPS, 1>(p, stream);
  if (w <= 32) return bwd_launch_j<T, GROUPS, 2>(p, stream);
  if (w <= 48) return bwd_launch_j<T, GROUPS, 3>(p, stream);
  if (w <= 64) return bwd_launch_j<T, GROUPS, 4>(p, stream);
  return bwd_launch_j<T, GROUPS, 8>(p, stream);
}

}  // namespace cenet
