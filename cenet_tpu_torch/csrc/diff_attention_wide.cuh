// Interleaved differential attention at head dims past 128 (d <= 1024,
// dv <= 2048), hand-written for Hopper (sm_90a): the wide designs of K1
// (diff_attention_fwd.cu) and K3 (diff_attention_bwd.cu), which replace
// _diff_fwd_pair_impl and _diff_bwd_pair_impl of
// cenet_tpu/ops/pallas_attention.py where the Pallas blocks span the whole
// head dim. The sites: the DSEBs of a ResNet CENet (the skin presets' DSEB1 at
// d = 128, dv = 256 and DSEB2 at 256, 512; ACDC's DSEB2 at 128, 256) and the
// DSEB3 of a PVT CENet from 55 or 110 images (d = 80 or 160, dv = 2d); with
// one head a site reaches d = 1024, dv = 2048 (ResNet-50's DSEB3). The
// functions and their rounding points are the narrow designs'
// (diff_attention_tc.cuh, attention_{fwd,bwd}_common.cuh):
//   o = w V,  w = P1 - lam P2 rounded to V's dtype,  P_g = exp(q_g k_g^T - lse_g),
//     whole-row fp32 max and sum per group, both fp32 row LSEs written;
//   with G = dO V^T:  delta_g = rowsum(P_g G),  ds_g = P_g (G - delta_g),
//   dq_g = c_g round(ds_g) k_g,  dk_g = c_g round(ds_g)^T q_g  (c_1 = 1, c_2 = -lam),
//   dv = round(P1 - lam P2)^T dO,  dlam = -sum(delta_2) (summed by the caller),
// every product summed in fp32 and cast once at the end.
//
// A warp's accumulator of 16 rows by 2048 fp32 columns does not fit in
// registers, so every design tiles the output columns: a block owns 64 rows of
// one (batch, head) and one slice of one output's columns, streams the other
// side in tiles of 64 rows, and forms each tile's logits again over all of d
// (and G over all of dv) in chunks staged through shared memory. Blocks of
// different slices of the same rows compute the same logits in the same order,
// so the row statistics they derive agree to the bit; one of them writes them.
// Nothing sums across blocks: each output element is written by one block, no
// atomics, and repeat runs are bit-identical.
//   forward  one block per (64 query rows, slice of 128 columns of o): pass 1
//            over the keys forms both groups' logits and the row max and sum
//            (each lane its own keys, rescaled when its max grows; the four
//            lanes of a row combined at the end), pass 2 forms them again,
//            w in fp32, rounds it and accumulates w V[:, slice];
//   delta    one block per 64 query rows: S_1, S_2 and G over the keys,
//            delta_g = rowsum(P_g G), written for the other two kernels;
//   dq       one block per (64 query rows, group, slice of 128 columns of
//            dq_g): S_g and G over the keys, ds_g, dq_g += round(ds_g) K_g[:, slice];
//   dkv      one block per (64 keys, slice): a slice of dk_1, of dk_2 (S_g^T,
//            G^T, ds_g^T, dk_g += round(ds_g^T) Q_g[:, slice]) or of dv (S_1^T,
//            S_2^T, w^T, dv += round(w^T) dO[:, slice]).
// The recomputation is the price of the register budget: against the least
// work, 2 N M (2d + dv) per head pair forward and 2 N M (6d + 2dv) backward,
// the forward does 2 N M (4 s_v d + dv) (s_v slices of dv) and the backward
// 2 N M (6d + 2dv + 4 s_d (d + dv) + 2 s_v d) (s_d slices of d): 2.5x and
// 2.6x at d = 128, dv = 256; 4.5x and 4.2x at d = 256, dv = 512.
//
// Two designs, by dtype, as for the narrow kernels:
//   bf16  the tensor cores (namespace dwide, *_tc_kernel): 4 warps of 16 rows,
//         mma.sync m16n8k16 on the fragments of attention_tc.cuh; logits in
//         chunks of 64 columns (both sides staged by cp.async, then one
//         ldmatrix of the own rows' A fragments and the products), the
//         streamed tile's output slice staged beside them; P, ds and w go
//         from the logits' accumulators straight into the A fragments of the
//         output product, exponentials as ex2.approx.ftz with the max or lse
//         folded into one fused multiply-add.
//   fp32  CUDA cores in fp32 FMA (*_f32_kernel): the 16 x 16 thread grid and
//         transposed tiles of attention_wide.cuh's fp32 design, whose
//         chunked_dot forms the logits 128 columns of d (or dv) at a time.
//         The tensor cores take fp32 only as TF32, which would break the
//         fp32 kernels' 1e-4 agreement with their twins.
// Loads are synchronous (each chunk waits for its copies): simple first; a
// pipelined design, wgmma and a single pass over the logits come later.
//
// Edges: any N, M >= 1; 1 <= d <= 1024, 1 <= dv <= 2048. Rows past N or M and
// columns past d or dv are staged as zeros; keys past M get no share of the
// statistics and w = P = 0; query rows past N give P = 0 in the key-side
// kernel; nothing past the ends is stored. Inputs take any (batch, head, row)
// strides with unit last stride; o, dq, dk and dv have contiguous rows.

#pragma once

#include "attention_wide.cuh"
#include "diff_attention_tc.cuh"

namespace cenet {
namespace dwide {

constexpr int MAX_D = 1024;  // largest d of q and k
constexpr int MAX_DV = 2048;  // largest dv of v

inline bool dims_ok(int N, int M, int D, int DV) {
  return N >= 1 && M >= 1 && D >= 1 && D <= MAX_D && DV >= 1 && DV <= MAX_DV;
}

// ---------------------------------------------------------------------------
// fp32, CUDA cores
// ---------------------------------------------------------------------------

using wide::CW;
using wide::chunked_dot;
using wide::chunks;

// One block: 64 query rows of one (batch, head pair), value columns v0 .. v0 + 127.
template <int = 0>
__global__ void __launch_bounds__(THREADS) diff_fwd_f32_kernel(Params p) {
  extern __shared__ float smem[];
  float* At = smem;          // [CW][LD]  q_g chunk, transposed
  float* Bt = At + CW * LD;  // [CW][LD]  k_g chunk, transposed
  float* Vs = Bt + CW * LD;  // [BK][CW]  v slice
  float* Wt = Vs + BK * CW;  // [BK][LD]  w, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DV = p.DV, N = p.N, M = p.M, ns = chunks(DV);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y / ns, v0 = (blockIdx.y % ns) * CW, b = blockIdx.z;
  const int E = min(CW, DV - v0);
  const float* q[2];
  const float* k[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    q[g] = static_cast<const float*>(p.q[g]) + b * p.sq[g].b + (long long)head * p.sq[g].h;
    k[g] = static_cast<const float*>(p.k[g]) + b * p.sk[g].b + (long long)head * p.sk[g].h;
  }
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + (long long)head * p.sv.h + v0;
  const float lam = *p.lam;

  // ---- pass 1: each group's row max and sum of exponentials
  float m_run[2][4], l_run[2][4];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) m_run[g][i] = -INFINITY, l_run[g][i] = 0.f;
  for (int k0 = 0; k0 < M; k0 += BK) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float s[4][4];
      chunked_dot(At, Bt, q[g], p.sq[g].n, q0, N, k[g], p.sk[g].n, k0, M, D, tid, ty, tx, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tx + 16 * j < M) tmax = fmaxf(tmax, s[i][j]);
        tmax = half_warp_max(tmax);
        const float m_new = fmaxf(m_run[g][i], tmax);  // finite: every tile has a key
        float tsum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tx + 16 * j < M) tsum += __expf(s[i][j] - m_new);
        tsum = half_warp_sum(tsum);
        l_run[g][i] = l_run[g][i] * __expf(m_run[g][i] - m_new) + tsum;
        m_run[g][i] = m_new;
      }
    }
  }
  float inv_l[2][4];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) inv_l[g][i] = 1.f / l_run[g][i];

  // ---- pass 2: o = w V over this block's value columns
  float acc[4][8];
  zero(acc);
  for (int k0 = 0; k0 < M; k0 += BK) {
    float s1[4][4], s2[4][4];
    chunked_dot(At, Bt, q[0], p.sq[0].n, q0, N, k[0], p.sk[0].n, k0, M, D, tid, ty, tx, s1);
    chunked_dot(At, Bt, q[1], p.sq[1].n, q0, N, k[1], p.sk[1].n, k0, M, D, tid, ty, tx, s2);
    for (int idx = tid; idx < BK * E; idx += THREADS) {
      const int e = idx % E, c = idx / E;
      const int m = k0 + c;
      Vs[c * CW + e] = m < M ? v[m * p.sv.n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w = __expf(s1[i][j] - m_run[0][i]) * inv_l[0][i] - lam * (__expf(s2[i][j] - m_run[1][i]) * inv_l[1][i]);
        if (k0 + tx + 16 * j >= M) w = 0.f;
        Wt[(tx + 16 * j) * LD + ty * 4 + i] = w;
      }
    __syncthreads();
    const int kn = min(BK, M - k0);
    for (int c = 0; c < kn; ++c) {
      float wa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wa[i] = Wt[c * LD + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < E ? Vs[c * CW + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wa[i], vv, acc[i][j]);
      }
    }
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    const long long row = ((long long)b * p.Hv + head) * N + n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < E) o[row * DV + v0 + col] = acc[i][j];
    }
    if (tx == 0 && v0 == 0) {
      p.lse1[row] = m_run[0][i] + logf(l_run[0][i]);
      p.lse2[row] = m_run[1][i] + logf(l_run[1][i]);
    }
  }
}

// One block: 64 query rows of one (batch, head pair); delta_1 and delta_2.
template <int = 0>
__global__ void __launch_bounds__(THREADS) diff_bwd_delta_f32_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* At = smem;          // [CW][LD]
  float* Bt = At + CW * LD;  // [CW][LD]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DV = p.DV, N = p.N, M = p.M;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const float* q[2];
  const float* k[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    q[g] = static_cast<const float*>(p.q[g]) + b * p.sq[g].b + (long long)head * p.sq[g].h;
    k[g] = static_cast<const float*>(p.k[g]) + b * p.sk[g].b + (long long)head * p.sk[g].h;
  }
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + (long long)head * p.sv.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.so.b + (long long)head * p.so.h;
  const long long row0 = ((long long)b * p.Hv + head) * N;
  const float* lse_g[2] = {p.lse1 + row0, p.lse2 + row0};

  float lse[2][4], dl[2][4];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = q0 + ty * 4 + i;
      lse[g][i] = n < N ? lse_g[g][n] : 0.f;
      dl[g][i] = 0.f;
    }
  for (int k0 = 0; k0 < M; k0 += BK) {
    float s1[4][4], s2[4][4], gg[4][4];
    chunked_dot(At, Bt, q[0], p.sq[0].n, q0, N, k[0], p.sk[0].n, k0, M, D, tid, ty, tx, s1);
    chunked_dot(At, Bt, q[1], p.sq[1].n, q0, N, k[1], p.sk[1].n, k0, M, D, tid, ty, tx, s2);
    chunked_dot(At, Bt, dout, p.so.n, q0, N, v, p.sv.n, k0, M, DV, tid, ty, tx, gg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < M) {
          dl[0][i] = fmaf(__expf(s1[i][j] - lse[0][i]), gg[i][j], dl[0][i]);
          dl[1][i] = fmaf(__expf(s2[i][j] - lse[1][i]), gg[i][j], dl[1][i]);
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d1 = half_warp_sum(dl[0][i]), d2 = half_warp_sum(dl[1][i]);
    const int n = q0 + ty * 4 + i;
    if (tx == 0 && n < N) {
      p.delta1[row0 + n] = d1;
      p.delta2[row0 + n] = d2;
    }
  }
}

// One block: 64 query rows of one (batch, head pair), group g, dq_g columns c0 .. c0 + 127.
template <int = 0>
__global__ void __launch_bounds__(THREADS) diff_bwd_dq_f32_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* At = smem;          // [CW][LD]  q_g or dO chunk, transposed
  float* Bt = At + CW * LD;  // [CW][LD]  k_g or v chunk, transposed
  float* Xt = Bt + CW * LD;  // [CW][LD]  k_g slice, transposed
  float* Sh = Xt + CW * LD;  // [BK][LD]  ds[c][r]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DV = p.DV, N = p.N, M = p.M, nd = chunks(D);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y / (2 * nd), sl = blockIdx.y % (2 * nd), b = blockIdx.z;
  const int g = sl / nd, c0 = (sl % nd) * CW, E = min(CW, D - c0);
  const float* q = static_cast<const float*>(p.q[g]) + b * p.sq[g].b + (long long)head * p.sq[g].h;
  const float* k = static_cast<const float*>(p.k[g]) + b * p.sk[g].b + (long long)head * p.sk[g].h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + (long long)head * p.sv.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.so.b + (long long)head * p.so.h;
  const long long row0 = ((long long)b * p.Hv + head) * N;
  const float* lse_g = (g == 0 ? p.lse1 : p.lse2) + row0;
  const float* delta_g = (g == 0 ? p.delta1 : p.delta2) + row0;

  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    lse[i] = n < N ? lse_g[n] : 0.f;
    dl[i] = n < N ? delta_g[n] : 0.f;
  }

  float acc[4][8];
  zero(acc);
  for (int k0 = 0; k0 < M; k0 += BK) {
    float s[4][4], gg[4][4];
    chunked_dot(At, Bt, q, p.sq[g].n, q0, N, k, p.sk[g].n, k0, M, D, tid, ty, tx, s);
    chunked_dot(At, Bt, dout, p.so.n, q0, N, v, p.sv.n, k0, M, DV, tid, ty, tx, gg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = k0 + tx + 16 * j < M && q0 + ty * 4 + i < N;
        Sh[(tx + 16 * j) * LD + ty * 4 + i] = live ? __expf(s[i][j] - lse[i]) * (gg[i][j] - dl[i]) : 0.f;
      }
    stage_t(Xt, k + c0, p.sk[g].n, k0, M, E, tid);
    __syncthreads();
    tile_acc<8>(Sh, Xt, min(BK, M - k0), E, ty, tx, acc);
  }
  float* dq = static_cast<float*>(p.dq[g]) + b * p.sdq[g].b + (long long)head * p.sdq[g].h + c0;
  store_rows<float, 8>(dq, p.sdq[g].n, q0, N, E, ty, tx, g == 0 ? 1.f : -*p.lam, acc);
}

// One block: 64 keys of one (batch, head pair) and one slice: dk_1 columns
// (slices 0 .. nd - 1), dk_2 columns (nd .. 2 nd - 1) or dv columns (the rest),
// 128 a slice.
template <int = 0>
__global__ void __launch_bounds__(THREADS) diff_bwd_dkv_f32_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* At = smem;          // [CW][LD]  k_g or v chunk, transposed
  float* Bt = At + CW * LD;  // [CW][LD]  q_g or dO chunk, transposed
  float* Xt = Bt + CW * LD;  // [CW][LD]  q_g or dO slice, transposed
  float* Sh = Xt + CW * LD;  // [BQ][LD]  ds_g^T or w^T, [query][key]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DV = p.DV, N = p.N, M = p.M, nd = chunks(D), ns = 2 * nd + chunks(DV);
  const int m0 = blockIdx.x * BK, head = blockIdx.y / ns, sl = blockIdx.y % ns, b = blockIdx.z;
  const bool is_dk = sl < 2 * nd;
  const int g = is_dk ? sl / nd : 0;
  const int c0 = (is_dk ? sl % nd : sl - 2 * nd) * CW, E = min(CW, (is_dk ? D : DV) - c0);
  const float* q[2];
  const float* k[2];
#pragma unroll
  for (int gr = 0; gr < 2; ++gr) {
    q[gr] = static_cast<const float*>(p.q[gr]) + b * p.sq[gr].b + (long long)head * p.sq[gr].h;
    k[gr] = static_cast<const float*>(p.k[gr]) + b * p.sk[gr].b + (long long)head * p.sk[gr].h;
  }
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + (long long)head * p.sv.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.so.b + (long long)head * p.so.h;
  const long long row0 = ((long long)b * p.Hv + head) * N;
  const float* lse_g[2] = {p.lse1 + row0, p.lse2 + row0};
  const float* delta_g = (g == 0 ? p.delta1 : p.delta2) + row0;
  const float lam = *p.lam;

  float acc[4][8];
  zero(acc);
  for (int q0 = 0; q0 < N; q0 += BQ) {
    // this thread: keys ty*4 + i against query rows tx + 16 j of the tile
    const int rn = min(BQ, N - q0);
    if (is_dk) {
      float s[4][4], gg[4][4];
      chunked_dot(At, Bt, k[g], p.sk[g].n, m0, M, q[g], p.sq[g].n, q0, N, D, tid, ty, tx, s);
      chunked_dot(At, Bt, v, p.sv.n, m0, M, dout, p.so.n, q0, N, DV, tid, ty, tx, gg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float ls = r < rn ? lse_g[g][q0 + r] : 0.f, dl = r < rn ? delta_g[q0 + r] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) Sh[r * LD + ty * 4 + i] = r < rn ? __expf(s[i][j] - ls) * (gg[i][j] - dl) : 0.f;
      }
    } else {
      float s1[4][4], s2[4][4];
      chunked_dot(At, Bt, k[0], p.sk[0].n, m0, M, q[0], p.sq[0].n, q0, N, D, tid, ty, tx, s1);
      chunked_dot(At, Bt, k[1], p.sk[1].n, m0, M, q[1], p.sq[1].n, q0, N, D, tid, ty, tx, s2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float l1 = r < rn ? lse_g[0][q0 + r] : 0.f, l2 = r < rn ? lse_g[1][q0 + r] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Sh[r * LD + ty * 4 + i] = r < rn ? __expf(s1[i][j] - l1) - lam * __expf(s2[i][j] - l2) : 0.f;
      }
    }
    stage_t(Xt, (is_dk ? q[g] : dout) + c0, is_dk ? p.sq[g].n : p.so.n, q0, N, E, tid);
    __syncthreads();
    tile_acc<8>(Sh, Xt, rn, E, ty, tx, acc);
  }
  if (is_dk) {
    float* dk = static_cast<float*>(p.dk[g]) + b * p.sdk[g].b + (long long)head * p.sdk[g].h + c0;
    store_rows<float, 8>(dk, p.sdk[g].n, m0, M, E, ty, tx, g == 0 ? 1.f : -lam, acc);
  } else {
    float* dv = static_cast<float*>(p.dv) + ((long long)b * p.Hv + head) * M * DV + c0;
    store_rows<float, 8>(dv, DV, m0, M, E, ty, tx, 1.f, acc);
  }
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

using tc::bf16;

constexpr int TB = 64;               // rows of a block's own tile and of a streamed tile
constexpr int TNT = 128;             // 4 warps of 16 own rows
constexpr int KC = 4;                // 16-deep steps of a logits chunk
constexpr int CC = 16 * KC;          // columns of a logits chunk
constexpr int SC = 128;              // columns of an output slice
constexpr int NS = SC / 8;           // n blocks of an output slice
constexpr int PC = tc::pitch(KC);    // pitch of a chunk tile
constexpr int PS = tc::pitch(SC / 16);  // pitch of a slice tile

__host__ __device__ constexpr int slices(int cols) { return (cols + SC - 1) / SC; }

// One (batch, head) slice of an operand: rows at stride sn, unit stride on columns
struct Rows {
  const bf16* p;
  long long sn;
  bool vec;
};

__device__ __forceinline__ Rows rows_of(const tc::Operand& o, int b, int h) {
  return {o.ptr + b * o.sb + h * o.sh, o.sn, o.vec != 0};
}

// acc[g] = x_g[x0 .. x0 + 63] y_g[y0 .. y0 + 63]^T over `cols` columns, for
// g < G: this warp's 16 own rows (from w0) against the 64 streamed rows, both
// sides staged CC columns at a time through Xs and Ys ([G][TB][PC] each), in
// order of columns. Starts with a barrier, so the caller's earlier readers of
// any shared buffer are done when it returns.
template <int G>
__device__ __forceinline__ void chunked_dots(float (&acc)[G][8][4], bf16* Xs, bf16* Ys, const Rows (&x)[G], int x0,
                                             int xrows, const Rows (&y)[G], int y0, int yrows, int cols, int w0) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][nb][j] = 0.f;
  for (int c0 = 0; c0 < cols; c0 += CC) {
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      tc::load_tile<TNT, TB, CC / 8>(Xs + g * TB * PC, PC, x[g].p + c0, x[g].sn, x0, xrows, cols - c0, x[g].vec);
      tc::load_tile<TNT, TB, CC / 8>(Ys + g * TB * PC, PC, y[g].p + c0, y[g].sn, y0, yrows, cols - c0, y[g].vec);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t a[KC][4];
      tc::load_a<KC>(a, Xs + g * TB * PC, PC, w0);
      tc::mma_nk<KC, 8>(acc[g], a, Ys + g * TB * PC, PC);
    }
  }
}

// Rows row0 .. row0 + TB - 1 of a shared slice tile into rows of `ld` elements
// at `g`, columns 0 .. cols - 1 (at most SC); rows past `rows` are not stored.
__device__ __forceinline__ void store_slice(const bf16* sm, bf16* g, long long ld, int row0, int rows, int cols,
                                            bool vec) {
  for (int i = threadIdx.x; i < TB * NS; i += TNT) {
    const int r = i / NS, c = (i % NS) * 8, row = row0 + r;
    if (row >= rows || c >= cols) continue;
    bf16* dst = g + (long long)row * ld + c;
    const bf16* src = sm + r * PS + c;
    if (vec && c + 8 <= cols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < cols; ++e) dst[e] = src[e];
    }
  }
}

// The shared memory of every bf16 kernel: Xs, Ys ([2][TB][PC] each) and a slice tile [TB][PS]
constexpr size_t TC_SMEM = sizeof(bf16) * (4 * TB * PC + TB * PS);

template <int = 0>
__global__ void __launch_bounds__(TNT) diff_fwd_tc_kernel(const tc::DiffFwdArgs p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(wide_smem);  // [2][TB][PC]   q_g chunks
  bf16* Ys = Xs + 2 * TB * PC;                     // [2][TB][PC]   k_g chunks
  bf16* Vs = Ys + 2 * TB * PC;                     // [TB][PS]      v slice, then o

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int ns = slices(p.DV), b = blockIdx.z, h = blockIdx.y / ns, v0 = (blockIdx.y % ns) * SC;
  const int q0 = blockIdx.x * TB, w0 = warp * 16, N = p.N, M = p.M, T = (M + TB - 1) / TB;
  const Rows q[2] = {rows_of(p.q[0], b, h), rows_of(p.q[1], b, h)};
  const Rows k[2] = {rows_of(p.k[0], b, h), rows_of(p.k[1], b, h)};
  const Rows v = rows_of(p.v, b, h);
  const float nlam = -*p.lam;

  // per group, rows g and g + 8 of the warp: in pass 1 this lane's running max
  // of its keys and its sum of exp(s - max); from the end of pass 1 the row's
  // max and sum, and lse log2 e
  float mx[2][2], l[2][2], ls[2][2];
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[gr][i] = tc::NO_KEY, l[gr][i] = 0.f, ls[gr][i] = 0.f;
  float acc[NS][4] = {};
  for (int s = 0; s < 2 * T; ++s) {
    const int k0 = (s < T ? s : s - T) * TB;
    float sc[2][8][4];
    chunked_dots<2>(sc, Xs, Ys, q, q0, N, k, k0, M, p.D, w0);
    // keys past M (in a ragged last tile only) take no part in the statistics and get w = 0
    const int live = M - k0 - 2 * t;  // element (nb, j) is a key below M iff nb * 8 + (j & 1) < live
    const bool full = k0 + TB <= M;
    if (s < T) {
      auto stats = [&](auto masked) {
#pragma unroll
        for (int gr = 0; gr < 2; ++gr)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float m = mx[gr][i];
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
#pragma unroll
              for (int j = 2 * i; j < 2 * i + 2; ++j)
                if (!decltype(masked)::value || nb * 8 + (j & 1) < live) m = fmaxf(m, sc[gr][nb][j]);
            const float ms = m * tc::LOG2E;
            float sum = 0.f;
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
#pragma unroll
              for (int j = 2 * i; j < 2 * i + 2; ++j) {
                const float e = tc::ex2(fmaf(sc[gr][nb][j], tc::LOG2E, -ms));  // exp(s - m)
                sum += decltype(masked)::value && nb * 8 + (j & 1) >= live ? 0.f : e;
              }
            l[gr][i] = fmaf(l[gr][i], tc::ex2((mx[gr][i] - m) * tc::LOG2E), sum);  // the old sum, rescaled to m
            mx[gr][i] = m;
          }
      };
      if (full) stats(std::false_type{}); else stats(std::true_type{});
      if (s == T - 1) {
        // the row's max and sum from its four lanes (a lane that saw no key has l = 0)
#pragma unroll
        for (int gr = 0; gr < 2; ++gr)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m = tc::quad_max(mx[gr][i]);
            l[gr][i] = tc::quad_sum(l[gr][i] * tc::ex2((mx[gr][i] - m) * tc::LOG2E));
            mx[gr][i] = m;
            ls[gr][i] = (m + logf(l[gr][i])) * tc::LOG2E;
          }
      }
    } else {
      // the tile's V slice (Vs is free: chunked_dots passed a barrier after its last reader)
      tc::load_tile<TNT, TB, NS>(Vs, PS, v.p + v0, v.sn, k0, M, p.DV - v0, v.vec);
      tc::cp_async_commit();
      uint32_t wa[KC][4];
      auto weights = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p1 = tc::ex2(fmaf(sc[0][nb][j], tc::LOG2E, -ls[0][j >> 1]));  // exp(s1 - lse1)
            const float p2 = tc::ex2(fmaf(sc[1][nb][j], tc::LOG2E, -ls[1][j >> 1]));  // exp(s2 - lse2)
            const float w = fmaf(nlam, p2, p1);
            sc[0][nb][j] = decltype(masked)::value && nb * 8 + (j & 1) >= live ? 0.f : w;
          }
        tc::acc_to_a<KC>(wa, sc[0]);
      };
      if (full) weights(std::false_type{}); else weights(std::true_type{});
      tc::cp_async_wait<0>();
      __syncthreads();
      tc::mma_kn<KC, NS>(acc, wa, Vs, PS);
    }
  }
  __syncthreads();  // every warp's last reader of Vs is done

  // o through Vs, and both groups' fp32 LSEs from the first slice's blocks
  const long long bh = (long long)b * p.H + h;
  const float one[2] = {1.f, 1.f};
  tc::acc_to_smem<NS>(Vs, PS, w0, acc, one);
  if (t == 0 && v0 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + g + 8 * i;
      if (n < N) {
#pragma unroll
        for (int gr = 0; gr < 2; ++gr) p.lse[gr][bh * N + n] = mx[gr][i] + logf(l[gr][i]);
      }
    }
  }
  __syncthreads();
  store_slice(Vs, p.o + bh * N * p.DV + v0, p.DV, q0, N, p.DV - v0, p.vec_o);
}

// One block: 64 query rows of one (batch, head pair); delta_1 and delta_2.
template <int = 0>
__global__ void __launch_bounds__(TNT) diff_bwd_delta_tc_kernel(const tc::DiffBwdArgs p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(wide_smem);  // [2][TB][PC]   q_g or dO chunks
  bf16* Ys = Xs + 2 * TB * PC;                     // [2][TB][PC]   k_g or v chunks

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TB, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + TB - 1) / TB;
  const long long bh = (long long)b * p.H + h;
  const Rows q[2] = {rows_of(p.q[0], b, h), rows_of(p.q[1], b, h)};
  const Rows k[2] = {rows_of(p.k[0], b, h), rows_of(p.k[1], b, h)};
  const Rows o[1] = {rows_of(p.dout, b, h)}, v[1] = {rows_of(p.v, b, h)};

  // per group, rows g and g + 8 of the warp: lse log2 e, and this lane's share of delta
  float lse[2][2], delta[2][2];
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + g + 8 * i;
      lse[gr][i] = n < N ? p.lse[gr][bh * N + n] * tc::LOG2E : 0.f;
      delta[gr][i] = 0.f;
    }
  for (int s = 0; s < T; ++s) {
    const int k0 = s * TB;
    float sc[2][8][4], gp[1][8][4];
    chunked_dots<2>(sc, Xs, Ys, q, q0, N, k, k0, M, p.D, w0);
    chunked_dots<1>(gp, Xs, Ys, o, q0, N, v, k0, M, p.DV, w0);  // G = dO V^T
    const int live = M - k0 - 2 * t;  // keys past M (ragged last tile only) get P = 0
    auto deltas = [&](auto masked) {
#pragma unroll
      for (int gr = 0; gr < 2; ++gr)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float pr = tc::ex2(fmaf(sc[gr][nb][j], tc::LOG2E, -lse[gr][j >> 1]));  // exp(s - lse)
            if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr = 0.f;
            delta[gr][j >> 1] = fmaf(pr, gp[0][nb][j], delta[gr][j >> 1]);
          }
    };
    if (k0 + TB <= M) deltas(std::false_type{}); else deltas(std::true_type{});
  }
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float d = tc::quad_sum(delta[gr][i]);
      const int n = q0 + w0 + g + 8 * i;
      if (t == 0 && n < N) p.delta[gr][bh * N + n] = d;
    }
}

// One block: 64 query rows of one (batch, head pair), group gr, dq_gr columns
// c0 .. c0 + 127.
template <int = 0>
__global__ void __launch_bounds__(TNT) diff_bwd_dq_tc_kernel(const tc::DiffBwdArgs p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(wide_smem);  // [TB][PC]   q_g or dO chunk
  bf16* Ys = Xs + 2 * TB * PC;                     // [TB][PC]   k_g or v chunk
  bf16* Ks = Ys + 2 * TB * PC;                     // [TB][PS]   k_g slice, then dq_g

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nd = slices(p.D), b = blockIdx.z, h = blockIdx.y / (2 * nd), sl = blockIdx.y % (2 * nd);
  const int gr = sl / nd, c0 = (sl % nd) * SC;
  const int q0 = blockIdx.x * TB, w0 = warp * 16, N = p.N, M = p.M, T = (M + TB - 1) / TB;
  const long long bh = (long long)b * p.H + h;
  const Rows q[1] = {rows_of(p.q[gr], b, h)}, k[1] = {rows_of(p.k[gr], b, h)};
  const Rows o[1] = {rows_of(p.dout, b, h)}, v[1] = {rows_of(p.v, b, h)};

  // rows g and g + 8 of the warp: lse_gr log2 e and delta_gr
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + w0 + g + 8 * i;
    lse[i] = n < N ? p.lse[gr][bh * N + n] * tc::LOG2E : 0.f;
    delta[i] = n < N ? p.delta[gr][bh * N + n] : 0.f;
  }
  float acc[NS][4] = {};
  for (int s = 0; s < T; ++s) {
    const int k0 = s * TB;
    float sc[1][8][4], gp[1][8][4];
    chunked_dots<1>(sc, Xs, Ys, q, q0, N, k, k0, M, p.D, w0);
    chunked_dots<1>(gp, Xs, Ys, o, q0, N, v, k0, M, p.DV, w0);  // G = dO V^T
    tc::load_tile<TNT, TB, NS>(Ks, PS, k[0].p + c0, k[0].sn, k0, M, p.D - c0, k[0].vec);
    tc::cp_async_commit();
    const int live = M - k0 - 2 * t;  // keys past M (ragged last tile only) get P = 0
    uint32_t dsa[KC][4];
    auto grads = [&](auto masked) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float pr = tc::ex2(fmaf(sc[0][nb][j], tc::LOG2E, -lse[j >> 1]));  // exp(s - lse)
          if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr = 0.f;
          sc[0][nb][j] = pr * (gp[0][nb][j] - delta[j >> 1]);  // ds
        }
      tc::acc_to_a<KC>(dsa, sc[0]);
    };
    if (k0 + TB <= M) grads(std::false_type{}); else grads(std::true_type{});
    tc::cp_async_wait<0>();
    __syncthreads();
    tc::mma_kn<KC, NS>(acc, dsa, Ks, PS);
  }
  __syncthreads();  // every warp's last reader of Ks is done

  // c_gr dq_gr through Ks
  if (gr == 1) tc::scale_acc<NS>(acc, -*p.lam);
  const float one[2] = {1.f, 1.f};
  tc::acc_to_smem<NS>(Ks, PS, w0, acc, one);
  __syncthreads();
  const tc::OutRows& out = p.dq[gr];
  store_slice(Ks, out.ptr + b * out.sb + h * out.sh + c0, p.D, q0, N, p.D - c0, out.vec);
}

// One block: 64 keys of one (batch, head pair) and one slice: dk_1 columns
// (slices 0 .. nd - 1), dk_2 columns (nd .. 2 nd - 1) or dv columns (the rest),
// 128 a slice. Works on the transposes (S_g^T = K_g Q_g^T, G^T = V dO^T), so
// every A operand comes from the logits' accumulators.
template <int = 0>
__global__ void __launch_bounds__(TNT) diff_bwd_dkv_tc_kernel(const tc::DiffBwdArgs p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(wide_smem);  // [2][TB][PC]   k_g or v chunks
  bf16* Ys = Xs + 2 * TB * PC;                     // [2][TB][PC]   q_g or dO chunks
  bf16* Zs = Ys + 2 * TB * PC;                     // [TB][PS]      q_g or dO slice, then the output

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int nd = slices(p.D), ns = 2 * nd + slices(p.DV);
  const int b = blockIdx.z, h = blockIdx.y / ns, sl = blockIdx.y % ns;
  const bool is_dk = sl < 2 * nd;
  const int gr = is_dk ? sl / nd : 0, c0 = (is_dk ? sl % nd : sl - 2 * nd) * SC;
  const int m0 = blockIdx.x * TB, w0 = warp * 16, N = p.N, M = p.M, T = (N + TB - 1) / TB;
  const long long bh = (long long)b * p.H + h;
  const Rows q[2] = {rows_of(p.q[0], b, h), rows_of(p.q[1], b, h)};
  const Rows k[2] = {rows_of(p.k[0], b, h), rows_of(p.k[1], b, h)};
  const Rows o[1] = {rows_of(p.dout, b, h)}, v[1] = {rows_of(p.v, b, h)};
  const Rows qg[1] = {q[gr]}, kg[1] = {k[gr]};
  const Rows z = is_dk ? q[gr] : o[0];  // the B operand of the output product
  const float* lse[2] = {p.lse[0] + bh * N, p.lse[1] + bh * N};
  const float* dl = p.delta[gr] + bh * N;
  const float lam = *p.lam;

  float acc[NS][4] = {};
  for (int s = 0; s < T; ++s) {
    const int n0 = s * TB;
    // the output product's B tile (Zs is free: chunked_dots passed a barrier after its last reader)
    auto stage_z = [&] {
      tc::load_tile<TNT, TB, NS>(Zs, PS, z.p + c0, z.sn, n0, N, (is_dk ? p.D : p.DV) - c0, z.vec);
      tc::cp_async_commit();
    };
    const int live = N - n0 - 2 * t;  // query rows past N (ragged last tile only) get P = 0
    const bool full = n0 + TB <= N;
    uint32_t a[KC][4];
    if (is_dk) {
      float st[1][8][4], gt[1][8][4];
      chunked_dots<1>(st, Xs, Ys, kg, m0, M, qg, n0, N, p.D, w0);  // S_g^T
      chunked_dots<1>(gt, Xs, Ys, v, m0, M, o, n0, N, p.DV, w0);   // G^T
      stage_z();
      auto grads = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = nb * 8 + 2 * t + i;  // this lane's query row of elements j = i, i + 2
            const bool in = !decltype(masked)::value || nb * 8 + i < live;
            const float l1 = in ? lse[gr][n0 + c] * tc::LOG2E : 0.f, d1 = in ? dl[n0 + c] : 0.f;
#pragma unroll
            for (int j = i; j < 4; j += 2) {
              const float pr = in ? tc::ex2(fmaf(st[0][nb][j], tc::LOG2E, -l1)) : 0.f;
              st[0][nb][j] = pr * (gt[0][nb][j] - d1);  // ds_g^T
            }
          }
        tc::acc_to_a<KC>(a, st[0]);
      };
      if (full) grads(std::false_type{}); else grads(std::true_type{});
    } else {
      float st[2][8][4];
      chunked_dots<2>(st, Xs, Ys, k, m0, M, q, n0, N, p.D, w0);  // S_1^T, S_2^T
      stage_z();
      auto weights = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = nb * 8 + 2 * t + i;
            const bool in = !decltype(masked)::value || nb * 8 + i < live;
            const float l1 = in ? lse[0][n0 + c] * tc::LOG2E : 0.f, l2 = in ? lse[1][n0 + c] * tc::LOG2E : 0.f;
#pragma unroll
            for (int j = i; j < 4; j += 2) {
              const float p1 = tc::ex2(fmaf(st[0][nb][j], tc::LOG2E, -l1));
              const float p2 = tc::ex2(fmaf(st[1][nb][j], tc::LOG2E, -l2));
              st[0][nb][j] = in ? fmaf(-lam, p2, p1) : 0.f;  // w^T
            }
          }
        tc::acc_to_a<KC>(a, st[0]);
      };
      if (full) weights(std::false_type{}); else weights(std::true_type{});
    }
    tc::cp_async_wait<0>();
    __syncthreads();
    tc::mma_kn<KC, NS>(acc, a, Zs, PS);
  }
  __syncthreads();  // every warp's last reader of Zs is done

  // c_g dk_g or dv through Zs
  if (is_dk && gr == 1) tc::scale_acc<NS>(acc, -lam);
  const float one[2] = {1.f, 1.f};
  tc::acc_to_smem<NS>(Zs, PS, w0, acc, one);
  __syncthreads();
  if (is_dk) {
    const tc::OutRows& out = p.dk[gr];
    store_slice(Zs, out.ptr + b * out.sb + h * out.sh + c0, p.D, m0, M, p.D - c0, out.vec);
  } else {
    store_slice(Zs, p.dv + bh * M * p.DV + c0, p.DV, m0, M, p.DV - c0, p.vec_dv);
  }
}

// ---------------------------------------------------------------------------
// launchers: templates so that a source compiles only what it launches
// ---------------------------------------------------------------------------

template <typename Kernel, typename Args>
inline int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The fp32 forward on `stream`; returns the launch's cudaError_t (0 on success).
template <int = 0>
inline int fwd_f32_launch(const Params& p, cudaStream_t stream) {
  if (!dims_ok(p.N, p.M, p.D, p.DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t(2 * CW * LD) + size_t(BK * CW) + size_t(BK * LD));
  return launch(diff_fwd_f32_kernel<>, dim3((p.N + BQ - 1) / BQ, p.Hv * chunks(p.DV), p.B), THREADS, smem, stream,
                p);
}

// The fp32 delta, dq and dk/dv kernels, in that order on `stream`; returns the
// first failing launch's cudaError_t (0 on success).
template <int = 0>
inline int bwd_f32_launch(const BwdParams& p, cudaStream_t stream) {
  if (!dims_ok(p.N, p.M, p.D, p.DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t(3 * CW * LD) + size_t(BQ * LD));
  const int qb = (p.N + BQ - 1) / BQ, nd = chunks(p.D);
  int rc = launch(diff_bwd_delta_f32_kernel<>, dim3(qb, p.Hv, p.B), THREADS, smem, stream, p);
  if (rc == 0) rc = launch(diff_bwd_dq_f32_kernel<>, dim3(qb, p.Hv * 2 * nd, p.B), THREADS, smem, stream, p);
  if (rc == 0)
    rc = launch(diff_bwd_dkv_f32_kernel<>, dim3((p.M + BK - 1) / BK, p.Hv * (2 * nd + chunks(p.DV)), p.B), THREADS,
                smem, stream, p);
  return rc;
}

// The bf16 forward on `stream`.
template <int = 0>
inline int fwd_tc_launch(const tc::DiffFwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  return launch(diff_fwd_tc_kernel<>, dim3((a.N + TB - 1) / TB, a.H * slices(a.DV), B), TNT, TC_SMEM, stream, a);
}

// The bf16 delta, dq and dk/dv kernels, in that order on `stream`.
template <int = 0>
inline int bwd_tc_launch(const tc::DiffBwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  const int qb = (a.N + TB - 1) / TB, nd = slices(a.D);
  int rc = launch(diff_bwd_delta_tc_kernel<>, dim3(qb, a.H, B), TNT, TC_SMEM, stream, a);
  if (rc == 0) rc = launch(diff_bwd_dq_tc_kernel<>, dim3(qb, a.H * 2 * nd, B), TNT, TC_SMEM, stream, a);
  if (rc == 0)
    rc = launch(diff_bwd_dkv_tc_kernel<>, dim3((a.M + TB - 1) / TB, a.H * (2 * nd + slices(a.DV)), B), TNT, TC_SMEM,
                stream, a);
  return rc;
}

}  // namespace dwide
}  // namespace cenet
