// Shared body of the backward attention kernels (CUDA C++, sm_90a).
//
// GROUPS softmax groups share V, as in attention_fwd_common.cuh:
//   GROUPS = 2 (diff_attention_bwd.cu, diff_attention_split_bwd*.cu):
//                                        o = P1 V - lam * P2 V
//   GROUPS = 1 (attention_bwd.cu, attention_bwd_fused.cu):  o = P V
// with P_g = exp(q_g k_g^T - lse_g) recomputed from the forward's fp32 row
// log-sum-exp, and G = dO V^T. Per group:
//   GROUPS = 1: ds = P (G - Delta), Delta = rowsum(dO o) given by the caller;
//   GROUPS = 2: ds_g = P_g (G - delta_g), delta_g = rowsum(P_g G), computed here
//               (o mixes the groups, so rowsum(dO o) is not delta_g).
//   dq_g = c_g round(ds_g) k_g,  dk_g = c_g round(ds_g)^T q_g,  c_1 = 1, c_2 = -lam;
//   dv, with one of two rounding points (template SPLIT_DV):
//     false: dv = round(w)^T dO, w = P (GROUPS = 1) or P1 - lam P2 formed in
//            fp32 and rounded once (the interleaved pair kernel, K3);
//     true:  dv = round(P1)^T dO - lam round(P2)^T dO, each product in fp32
//            and the difference in fp32 (the split-group kernels, K6 and K7).
// "round" is the cast to the operands' dtype that the Pallas kernels make
// before each product; logits, P, G, ds and delta are fp32, and every product
// accumulates in fp32, cast to the output dtype once at the end.
// Which calls run this body: fp32 calls of K3, K4, K7 and K8, and K6 in both
// dtypes; bf16 calls of K3, K4, K7 and K8 run the tensor-core kernels of
// attention_tc.cuh and diff_attention_tc.cuh.
//
// Two kernels:
//   dq kernel   one block per BQ = 64 query rows of one (batch, head),
//               looping over key tiles of BK = 64. For GROUPS = 2 a first pass
//               over the keys computes delta_g and writes it out (the caller
//               sums -delta_2 into dlam), a second forms ds_g and dq_g.
//   dkv kernel  one block per 64 key rows, looping over query tiles and
//               recomputing P_g from the LSE.
// and two launch plans:
//   bwd_launch        the dq kernel, then the dkv kernel on the same stream
//                     (so delta_g is there): every output element is written
//                     by one block, no atomics, and repeat runs are
//                     bit-identical (K3, K4, K7).
//   bwd_fused_launch  one kernel (ATOMIC). GROUPS = 2 (K6): the dq kernel also
//                     forms each key tile's dk_g and dv over its 64 query rows
//                     and adds them into zeroed fp32 buffers with atomicAdd.
//                     GROUPS = 1 (K8): the dkv kernel also forms each query
//                     tile's dq over its 64 keys and adds it into a zeroed fp32
//                     buffer. Blocks run in no order, so the order of those
//                     additions changes from run to run and repeat runs differ
//                     in the last bits of the atomically summed gradients; the
//                     caller casts the buffers to the output dtype.
// Threads: 256 as a 16 x 16 grid (ty, tx). For logits a thread owns 4 rows
// (ty*4 + i) of the block's own side against 4 columns (tx + 16 j) of the
// streamed tile; for the products it owns 4 rows against the output columns
// tx + 16 j (j < J, J*16 >= max(D, DV)). Tiles are staged transposed in shared
// memory as fp32 (X[e*LD + row]); ds, P and w go through one shared buffer,
// in turn. Ragged edges: rows past N and keys past M are staged as zeros,
// get P = 0 and are not stored.
//
// Layouts: group g reads q_g (B, Hv, N, D) and k_g (B, Hv, M, D) by a base
// pointer and (batch, head, row) strides of its own, as the forward does, and
// writes dq_g, dk_g by strides of their own (the interleaved (B, 2Hv, ., D)
// gradients of K3 are two such views); v (B, Hv, M, DV) and dO (B, Hv, N, DV)
// have arbitrary strides; all have unit stride on the last dim. lse_g and
// delta_g (B, Hv, N) fp32 contiguous; dv (B, Hv, M, DV) contiguous. Outputs
// are in the dtype of q, except the atomically summed ones (fp32).

#pragma once

#include <type_traits>

#include "attention_fwd_common.cuh"

namespace cenet {

struct BwdParams {
  const void* q[2];    // per group (group 2 for GROUPS == 2 only)
  const void* k[2];
  const void* v;
  const void* dout;
  const float* lam;    // device scalar (GROUPS == 2 only)
  const float* lse1;   // (B, Hv, N)
  const float* lse2;   // GROUPS == 2 only
  float* delta1;       // GROUPS == 1: Delta, read; GROUPS == 2: delta_1, written by the dq kernel
  float* delta2;       // GROUPS == 2 only: delta_2, written by the dq kernel
  void* dq[2];
  void* dk[2];
  void* dv;
  int B, Hv, N, M, D, DV;
  Strides sq[2], sk[2], sv, so, sdq[2], sdk[2];
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

// tile_acc with S read the other way round: acc[i][j] += sum_{c < n} S[(ty*4 + i)*LD + c] * X[(tx + 16 j)*LD + c]
template <int J>
__device__ __forceinline__ void tile_acc_t(const float* S, const float* X, int n, int E, int ty, int tx,
                                           float (&acc)[4][J]) {
  for (int c = 0; c < n; ++c) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = S[(ty * 4 + i) * LD + c];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = tx + 16 * j;
      const float x = col < E ? X[col * LD + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], x, acc[i][j]);
    }
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&acc)[4][J]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

// dst[(row0 + ty*4 + i)*ld + tx + 16 j] = c * acc[i][j] as T, for rows < rows and columns < E
template <typename T, int J>
__device__ __forceinline__ void store_rows(T* dst, long long ld, int row0, int rows, int E, int ty, int tx, float c,
                                           const float (&acc)[4][J]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = tx + 16 * j;
      if (col < E) dst[r * ld + col] = from_f<T>(c * acc[i][j]);
    }
  }
}

// the same, added into an fp32 buffer with atomicAdd
template <int J>
__device__ __forceinline__ void atomic_add_rows(float* dst, long long ld, int row0, int rows, int E, int ty, int tx,
                                                float c, const float (&acc)[4][J]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = tx + 16 * j;
      if (col < E) atomicAdd(dst + r * ld + col, c * acc[i][j]);
    }
  }
}

inline size_t bwd_smem_bytes(int groups, int D, int DV) {
  // two transposed tiles per group (D x LD), two of V/dO (DV x LD), the
  // ds/P/w buffer (64 x LD) and 2*groups rows of statistics
  return sizeof(float) * (size_t(2 * groups * D * LD) + size_t(2 * DV * LD) + size_t(64 * LD) + size_t(2 * groups * 64));
}

// ATOMIC (K6): also add each key tile's dk_g and dv over this block's query rows
// into the fp32 buffers p.dk[g], p.dv
template <typename T, int GROUPS, int J, bool ATOMIC>
__global__ void __launch_bounds__(THREADS) attention_bwd_dq_kernel(BwdParams p) {
  static_assert(!ATOMIC || GROUPS == 2, "the fused dq kernel is the split diff-attention backward (K6)");
  extern __shared__ float smem[];
  const int D = p.D, DV = p.DV, N = p.N, M = p.M;
  float* Qt = smem;                   // [GROUPS][D][LD]  q rows of this block
  float* Ot = Qt + GROUPS * D * LD;   // [DV][LD]         dO rows of this block
  float* Kt = Ot + DV * LD;           // [GROUPS][D][LD]  key tile
  float* Vt = Kt + GROUPS * D * LD;   // [DV][LD]         value tile
  float* Sh = Vt + DV * LD;           // [BK][LD]         round(ds or P)[c][r]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + (long long)head * p.sv.h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.so.b + (long long)head * p.so.h;
  const T* qh[GROUPS];
  const T* kh[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    qh[g] = static_cast<const T*>(p.q[g]) + b * p.sq[g].b + (long long)head * p.sq[g].h;
    kh[g] = static_cast<const T*>(p.k[g]) + b * p.sk[g].b + (long long)head * p.sk[g].h;
  }
  float lam = 0.f;
  if constexpr (GROUPS == 2) lam = *p.lam;

#pragma unroll
  for (int g = 0; g < GROUPS; ++g) stage_t(Qt + g * D * LD, qh[g], p.sq[g].n, q0, N, D, tid);
  stage_t(Ot, dout, p.so.n, q0, N, DV, tid);
  const int rn = min(BQ, N - q0);

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
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) stage_t(Kt + g * D * LD, kh[g], p.sk[g].n, k0, M, D, tid);
    stage_t(Vt, v, p.sv.n, k0, M, DV, tid);
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

  // ---- dq_g = c_g round(ds_g) k_g (ATOMIC: and the key tile's dk_g and dv)
  float acc[GROUPS][4][J];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) zero(acc[g]);

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();
    load_kv(k0);
    __syncthreads();
    float gg[4][4];
    tile_dot(Ot, Vt, DV, ty, tx, gg);
    const int kn = min(BK, M - k0);
    float pv[GROUPS][4][J];  // ATOMIC: round(P_g)^T dO for the tile's keys over this block's rows
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      float s[4][4], pr[4][4];
      tile_dot(Qt + g * D * LD, Kt + g * D * LD, D, ty, tx, s);
      if (g > 0) __syncthreads();  // the previous group's ds or P is read
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool live = k0 + tx + 16 * j < M && q0 + ty * 4 + i < N;
          pr[i][j] = live ? __expf(s[i][j] - lse[g][i]) : 0.f;
          Sh[(tx + 16 * j) * LD + ty * 4 + i] = round_to<T>(pr[i][j] * (gg[i][j] - dl[g][i]));
        }
      __syncthreads();
      tile_acc<J>(Sh, Kt + g * D * LD, kn, D, ty, tx, acc[g]);
      if constexpr (ATOMIC) {
        // dk_g for keys k0 + ty*4 + i over this block's rows, into the fp32 buffer
        float pk[4][J];
        zero(pk);
        tile_acc_t<J>(Sh, Qt + g * D * LD, rn, D, ty, tx, pk);
        float* dk = static_cast<float*>(p.dk[g]) + b * p.sdk[g].b + (long long)head * p.sdk[g].h;
        atomic_add_rows<J>(dk, p.sdk[g].n, k0, M, D, ty, tx, g == 0 ? 1.f : -lam, pk);
        __syncthreads();  // dq_g and dk_g have read ds_g
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) Sh[(tx + 16 * j) * LD + ty * 4 + i] = round_to<T>(pr[i][j]);
        __syncthreads();
        zero(pv[g]);
        tile_acc_t<J>(Sh, Ot, rn, DV, ty, tx, pv[g]);
      }
    }
    if constexpr (ATOMIC) {
      float dvp[4][J];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) dvp[i][j] = pv[0][i][j] - lam * pv[1][i][j];
      float* dv = static_cast<float*>(p.dv) + ((long long)b * p.Hv + head) * M * DV;
      atomic_add_rows<J>(dv, DV, k0, M, DV, ty, tx, 1.f, dvp);
    }
  }

#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    T* dq = static_cast<T*>(p.dq[g]) + b * p.sdq[g].b + (long long)head * p.sdq[g].h;
    store_rows<T, J>(dq, p.sdq[g].n, q0, N, D, ty, tx, g == 0 ? 1.f : -lam, acc[g]);
  }
}

// ATOMIC (K8): also add each query tile's dq over this block's keys into the
// fp32 buffer p.dq[0]
template <typename T, int GROUPS, int J, bool SPLIT_DV, bool ATOMIC>
__global__ void __launch_bounds__(THREADS) attention_bwd_dkv_kernel(BwdParams p) {
  static_assert(!ATOMIC || GROUPS == 1, "the fused dk/dv kernel is the attention backward (K8)");
  extern __shared__ float smem[];
  const int D = p.D, DV = p.DV, N = p.N, M = p.M;
  float* Kt = smem;                   // [GROUPS][D][LD]  key rows of this block
  float* Vt = Kt + GROUPS * D * LD;   // [DV][LD]         value rows of this block
  float* Qt = Vt + DV * LD;           // [GROUPS][D][LD]  query tile
  float* Ot = Qt + GROUPS * D * LD;   // [DV][LD]         dO tile
  float* Sh = Ot + DV * LD;           // [BQ][LD]         round(ds, P or w)[r][c]
  float* st = Sh + BQ * LD;           // [GROUPS][2][BQ]  lse_g, delta_g of the tile's rows

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BK;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + (long long)head * p.sv.h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.so.b + (long long)head * p.so.h;
  const T* qh[GROUPS];
  const T* kh[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    qh[g] = static_cast<const T*>(p.q[g]) + b * p.sq[g].b + (long long)head * p.sq[g].h;
    kh[g] = static_cast<const T*>(p.k[g]) + b * p.sk[g].b + (long long)head * p.sk[g].h;
  }
  float lam = 0.f;
  if constexpr (GROUPS == 2) lam = *p.lam;

#pragma unroll
  for (int g = 0; g < GROUPS; ++g) stage_t(Kt + g * D * LD, kh[g], p.sk[g].n, m0, M, D, tid);
  stage_t(Vt, v, p.sv.n, m0, M, DV, tid);
  const int kn = min(BK, M - m0);

  const long long row0 = ((long long)b * p.Hv + head) * N;
  const float* lse_src[2] = {p.lse1, p.lse2};
  const float* dl_src[2] = {p.delta1, p.delta2};
  constexpr int NV = SPLIT_DV ? GROUPS : 1;

  float acc_k[GROUPS][4][J], acc_v[NV][4][J];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) zero(acc_k[g]);
#pragma unroll
  for (int g = 0; g < NV; ++g) zero(acc_v[g]);

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) stage_t(Qt + g * D * LD, qh[g], p.sq[g].n, q0, N, D, tid);
    stage_t(Ot, dout, p.so.n, q0, N, DV, tid);
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
      if constexpr (ATOMIC) {
        // dq for query rows q0 + ty*4 + i over this block's keys, into the fp32 buffer
        float pq[4][J];
        zero(pq);
        tile_acc_t<J>(Sh, Kt, kn, D, ty, tx, pq);
        float* dq = static_cast<float*>(p.dq[0]) + b * p.sdq[0].b + (long long)head * p.sdq[0].h;
        atomic_add_rows<J>(dq, p.sdq[0].n, q0, N, D, ty, tx, 1.f, pq);
      }
    }
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      __syncthreads();  // the last ds, or the previous group's P, is read
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float w = pr[g][i][j];
          if constexpr (GROUPS == 2 && !SPLIT_DV) w -= lam * pr[1][i][j];
          Sh[(tx + 16 * j) * LD + ty * 4 + i] = round_to<T>(w);
        }
      __syncthreads();
      tile_acc<J>(Sh, Ot, rn, DV, ty, tx, acc_v[g]);
    }
  }

#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    T* dk = static_cast<T*>(p.dk[g]) + b * p.sdk[g].b + (long long)head * p.sdk[g].h;
    store_rows<T, J>(dk, p.sdk[g].n, m0, M, D, ty, tx, g == 0 ? 1.f : -lam, acc_k[g]);
  }
  if constexpr (SPLIT_DV) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc_v[0][i][j] -= lam * acc_v[NV - 1][i][j];
  }
  T* dv = static_cast<T*>(p.dv) + ((long long)b * p.Hv + head) * M * DV;
  store_rows<T, J>(dv, DV, m0, M, DV, ty, tx, 1.f, acc_v[0]);
}

template <typename Kernel>
inline int launch_one(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const BwdParams& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, J>) with the fewest output columns per thread
// J that cover max(D, DV) (J*16 >= max(D, DV)); cudaErrorInvalidValue past the
// kernels' head dims
template <typename F>
inline int with_j(const BwdParams& p, F&& f) {
  if (p.D < 1 || p.D > MAX_D || p.DV < 1 || p.DV > MAX_DV || p.N < 1 || p.M < 1)
    return (int)cudaErrorInvalidValue;
  const int w = p.D > p.DV ? p.D : p.DV;
  if (w <= 16) return f(std::integral_constant<int, 1>{});
  if (w <= 32) return f(std::integral_constant<int, 2>{});
  if (w <= 48) return f(std::integral_constant<int, 3>{});
  if (w <= 64) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

// The dq kernel, then the dkv kernel, on `stream`; returns the first failing
// launch's cudaError_t (0 on success).
template <typename T, int GROUPS, bool SPLIT_DV = false>
inline int bwd_launch(const BwdParams& p, cudaStream_t stream) {
  return with_j(p, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    const int smem = (int)bwd_smem_bytes(GROUPS, p.D, p.DV);
    const int rc = launch_one(attention_bwd_dq_kernel<T, GROUPS, J, false>,
                                 dim3((p.N + BQ - 1) / BQ, p.Hv, p.B), smem, stream, p);
    if (rc != 0) return rc;
    return launch_one(attention_bwd_dkv_kernel<T, GROUPS, J, SPLIT_DV, false>,
                         dim3((p.M + BK - 1) / BK, p.Hv, p.B), smem, stream, p);
  });
}

// One kernel with atomically summed gradients (K6 for GROUPS = 2, K8 for
// GROUPS = 1); the caller zeroes the fp32 buffers first.
template <typename T, int GROUPS>
inline int bwd_fused_launch(const BwdParams& p, cudaStream_t stream) {
  return with_j(p, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    const int smem = (int)bwd_smem_bytes(GROUPS, p.D, p.DV);
    if constexpr (GROUPS == 2)
      return launch_one(attention_bwd_dq_kernel<T, 2, J, true>, dim3((p.N + BQ - 1) / BQ, p.Hv, p.B), smem,
                           stream, p);
    else
      return launch_one(attention_bwd_dkv_kernel<T, 1, J, false, true>, dim3((p.M + BK - 1) / BK, p.Hv, p.B),
                           smem, stream, p);
  });
}

}  // namespace cenet
