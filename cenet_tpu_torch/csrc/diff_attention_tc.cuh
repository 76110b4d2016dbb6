// Differential attention forward and backward on Hopper's tensor cores, bf16
// (sm_90a).
//
// The bf16 designs of K1 (diff_attention_fwd.cu), K3 (diff_attention_bwd.cu),
// K6 (diff_attention_split_bwd.cu) and K7 (diff_attention_split_bwd_two_kernel.cu),
// which replace _diff_fwd_pair_impl, _diff_bwd_pair_impl,
// _diff_bwd_onekernel_impl and _diff_bwd_impl of
// cenet_tpu/ops/pallas_attention.py; K5 (diff_attention_split_fwd.cu) launches
// K1's kernel. Two softmax groups share V:
//   o = w V,  w = P1 - lam P2,  P_g = exp(q_g k_g^T - lse_g),  q pre-scaled;
//   with G = dO V^T:  delta_g = rowsum(P_g G),  ds_g = P_g (G - delta_g),
//   dq_g = c_g round(ds_g) k_g,  dk_g = c_g round(ds_g)^T q_g  (c_1 = 1, c_2 = -lam),
//   dv = round(P1 - lam P2)^T dO  (K3), or
//   dv = round(P1)^T dO - lam round(P2)^T dO  (K6, and K7 with SPLIT_DV: two
//        products into two fp32 accumulators, combined in fp32, as
//        _diff_bwd_onekernel and _diff_dkv_kernel).
// Every product is mma.sync.m16n8k16 (bf16 operands, fp32 sums) on the tiles,
// fragments and pipeline of attention_tc.cuh (K2, K4), which these kernels
// reuse. Each group reads its q and k through an Operand of its own (base
// pointer and strides), so the interleaved layout (group 2 at base + one head
// stride, head stride doubled) and split head views are the same kernels.
//
// What bounds them on an H100 SXM: at the DSEB sites (d = 8, 16, 20; dv = 2d)
// the products are small (d fills at most two 16-deep steps) and the work is
// the exponentials and the fp32 arithmetic around each logit. The forward needs
// 2 exponentials per logit and group (the row statistics, then w), the
// backward 3 (delta, dq, dk/dv). The special-function unit gives 16 ex2 per SM
// per clock, so the design keeps one ex2.approx.ftz per logit and pass with the
// max or lse folded into one fused multiply-add, and the fp32 work per logit
// to a few instructions:
//   pass 1   x = fmaf(s, log2 e, -m log2 e), e = 2^x, a max and an add;
//   pass 2   w = fmaf(-lam, 2^(s2 log2 e - lse2 log2 e), 2^(s1 log2 e - lse1 log2 e)),
//            two w rounded to bf16 in one conversion.
//
// Numerics: the rounding points of the Pallas bodies.
//   forward  (_diff_fwd_pair_kernel) normalises each group before it rounds w
//            to bf16, so every row's max and sum must be known before any w
//            is formed. Pass 1 over the keys computes them: each lane keeps a
//            running max of its own keys and its sum of exp(s - max), rescaled
//            when that max grows (one exponential per row and tile), and the
//            four lanes of a row combine theirs once at the end into the row's
//            max m and sum l. Pass 2 recomputes the logits with the same
//            fragment code, forms w = exp(s1 - lse1) - lam exp(s2 - lse2) in
//            fp32 (exp(s - lse) = exp(s - m) / l), rounds it to bf16 in
//            registers as the A operand of w V (both groups' logits of one
//            (row, key) come out of identically tiled accumulators, so one
//            thread holds both) and accumulates o in fp32. lse_g = m_g + log l_g.
//            A one-pass online softmax would round w before l is known, which
//            is not the Pallas function.
//   backward (_diff_bwd_pair_kernel) P_g and ds_g in fp32 from the forward's
//            lse_g, rounded to bf16 only as the A operand of the next product;
//            delta_g from fp32 P_g and G inside the kernel (o mixes the groups,
//            so rowsum(dO o) is not delta_g); c_g multiplies the fp32 product.
//
// Kernels (NW warps of 16 rows each, the other side streamed through two
// shared buffers by cp.async, one barrier per step, as attention_tc.cuh):
//   diff_fwd_tc_kernel      query rows; Q1, Q2 in registers; streams K1, K2
//                           (pass 1), K1, K2 and V (pass 2).
//   diff_bwd_dq_tc_kernel   query rows; Q1, Q2, dO in registers, lse_g per row;
//                           streams K1, K2, V twice: pass 1 forms delta_g and
//                           writes it out, pass 2 dq_g += round(ds_g) K_g.
//   diff_bwd_dkv_tc_kernel  keys; K1, K2, V in registers; streams Q1, Q2, dO
//                           and each query row's lse_g, delta_g: S_g^T = K_g Q_g^T,
//                           G^T = V dO^T, dk_g += round(ds_g^T) Q_g,
//                           dv += round(P1^T - lam P2^T) dO, or with SPLIT_DV
//                           dv_g += round(P_g^T) dO and dv = dv_1 - lam dv_2.
//                           Working on the transposes keeps every A operand
//                           in registers.
//   diff_bwd_one_tc_kernel  K6, one launch: the dq kernel whose pass 2 also
//                           writes round(ds_g) and round(P_g) of each key tile
//                           to shared [query][key] tiles; after one barrier
//                           each warp reads them back transposed (ldmatrix
//                           .trans) for 16 keys of the tile and forms their
//                           dk_g = c_g round(ds_g)^T Q_g and
//                           dv = round(P1)^T dO - lam round(P2)^T dO over the
//                           block's query rows (Q_g, dO stay in shared memory
//                           as B operands), added into the caller's zeroed fp32
//                           dk_g, dv with 16-byte red.global.add.v4.f32
//                           (red_add_rows). Two passes over the keys, not three.
// The dq and dkv kernels run one after the other on the caller's stream (the
// dkv kernel reads delta_g) and every output element is written by one block:
// no atomics, and repeat runs are bit-identical. K6's dq and delta are written
// the same way and repeat exactly; its dk and dv sum across query blocks in no
// fixed order, so repeat runs differ in their last bits.
//
// Edges as in attention_tc.cuh: any N, M >= 1; d, dv <= 128 zero-padded to
// 16-deep steps; rows past N or M staged as zeros; masked keys (or query rows)
// get P = w = 0 in the one ragged tile; inputs with any (batch, head, row)
// strides and unit last stride; outputs with contiguous rows.

#pragma once

#include "attention_tc.cuh"

namespace cenet {
namespace tc {

// A (B, H, rows, cols) bf16 output with contiguous rows of `cols`, slices at
// any batch and head strides
struct OutRows {
  bf16* ptr;
  long long sb, sh;
  int vec;  // 16-byte stores: base aligned, cols a multiple of 8
};

inline OutRows out_rows(void* p, long long sb, long long sh, int cols) {
  return {static_cast<bf16*>(p), sb, sh, out_vec(p, cols) && sb % 8 == 0 && sh % 8 == 0};
}

struct DiffFwdArgs {
  Operand q[2], k[2], v;  // group g's q_g, k_g; the shared v
  const float* lam;       // device scalar
  bf16* o;                // (B, H, N, DV) contiguous
  float* lse[2];          // (B, H, N)
  int H, N, M, D, DV;
  int vec_o;
};

struct DiffBwdArgs {
  Operand q[2], k[2], v, dout;
  const float* lam;
  const float* lse[2];  // (B, H, N)
  float* delta[2];      // (B, H, N): written by the dq kernel, read by the dkv kernel
  OutRows dq[2], dk[2];
  bf16* dv;             // (B, H, M, DV) contiguous
  int H, N, M, D, DV;
  int vec_dv;
  float* dk_acc[2];     // K6: fp32 (B, H, M, D), zeroed by the caller (dk, dv unused)
  float* dv_acc;        // K6: fp32 (B, H, M, DV), zeroed by the caller
};

constexpr float NO_KEY = -1e30f;  // a lane's running max before it has seen a key

template <int KD, int KV, class C>
__global__ void __launch_bounds__(C::THREADS) diff_fwd_tc_kernel(const DiffFwdArgs p) {
  constexpr int PD = pitch(KD), PV = pitch(KV), BM = C::BM, BK = C::BS, NT = C::THREADS, NB = BK / 8;
  static_assert(BM <= STAGES * BK, "o is staged in V's buffers");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [2][BM][PD]
  bf16* Ks = Qs + 2 * BM * PD;                   // [STAGES][2][BK][PD]
  bf16* Vs = Ks + STAGES * 2 * BK * PD;          // [STAGES][BK][PV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + BK - 1) / BK;
  const bf16* kg[2] = {p.k[0].ptr + b * p.k[0].sb + h * p.k[0].sh, p.k[1].ptr + b * p.k[1].sb + h * p.k[1].sh};
  const bf16* vg = p.v.ptr + b * p.v.sb + h * p.v.sh;
  const float nlam = -*p.lam;

  // step s < T: pass 1 over key tile s (K1, K2); s >= T: pass 2 over key tile
  // s - T (K1, K2, V). One commit group per step, empty past the last.
  auto issue = [&](int s) {
    if (s < 2 * T) {
      const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
#pragma unroll
      for (int gr = 0; gr < 2; ++gr)
        load_tile<NT, BK, 2 * KD>(Ks + (2 * buf + gr) * BK * PD, PD, kg[gr], p.k[gr].sn, k0, M, p.D, p.k[gr].vec);
      if (s >= T) load_tile<NT, BK, 2 * KV>(Vs + buf * BK * PV, PV, vg, p.v.sn, k0, M, p.DV, p.v.vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
    load_tile<NT, BM, 2 * KD>(Qs + gr * BM * PD, PD, p.q[gr].ptr + b * p.q[gr].sb + h * p.q[gr].sh, p.q[gr].sn, q0,
                              N, p.D, p.q[gr].vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  uint32_t qa[2][KD][4];
  // per group, rows g and g + 8 of the warp: in pass 1 this lane's running max
  // of its keys and its sum of exp(s - max); from the end of pass 1 the row's
  // max and sum, and lse log2 e
  float mx[2][2], l[2][2], ls[2][2];
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[gr][i] = NO_KEY, l[gr][i] = 0.f, ls[gr][i] = 0.f;
  float acc[2 * KV][4] = {};
  for (int s = 0; s < 2 * T; ++s) {
    cp_async_wait<STAGES - 2>();  // step s's tiles have landed
    __syncthreads();              // ... for every thread, and step s - 1's buffers are free
    issue(s + STAGES - 1);
    if (s == 0) {
      load_a<KD>(qa[0], Qs, PD, w0);
      load_a<KD>(qa[1], Qs + BM * PD, PD, w0);
    }
    const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
    float sc[2][NB][4] = {};
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) mma_nk<KD, NB>(sc[gr], qa[gr], Ks + (2 * buf + gr) * BK * PD, PD);
    // keys past M (in a ragged last tile only) take no part in the statistics and get w = 0
    const int live = M - k0 - 2 * t;  // element (nb, j) is a key below M iff nb * 8 + (j & 1) < live
    const bool full = k0 + BK <= M;
    if (s < T) {
      auto stats = [&](auto masked) {
#pragma unroll
        for (int gr = 0; gr < 2; ++gr)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float m = mx[gr][i];
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
              for (int j = 2 * i; j < 2 * i + 2; ++j)
                if (!decltype(masked)::value || nb * 8 + (j & 1) < live) m = fmaxf(m, sc[gr][nb][j]);
            const float ms = m * LOG2E;
            float sum = 0.f;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
              for (int j = 2 * i; j < 2 * i + 2; ++j) {
                const float e = ex2(fmaf(sc[gr][nb][j], LOG2E, -ms));  // exp(s - m)
                sum += decltype(masked)::value && nb * 8 + (j & 1) >= live ? 0.f : e;
              }
            l[gr][i] = fmaf(l[gr][i], ex2((mx[gr][i] - m) * LOG2E), sum);  // the old sum, rescaled to m
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
            const float m = quad_max(mx[gr][i]);
            l[gr][i] = quad_sum(l[gr][i] * ex2((mx[gr][i] - m) * LOG2E));
            mx[gr][i] = m;
            ls[gr][i] = (m + logf(l[gr][i])) * LOG2E;
          }
      }
    } else {
      uint32_t wa[NB / 2][4];
      auto weights = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p1 = ex2(fmaf(sc[0][nb][j], LOG2E, -ls[0][j >> 1]));  // exp(s1 - lse1)
            const float p2 = ex2(fmaf(sc[1][nb][j], LOG2E, -ls[1][j >> 1]));  // exp(s2 - lse2)
            const float w = fmaf(nlam, p2, p1);
            sc[0][nb][j] = decltype(masked)::value && nb * 8 + (j & 1) >= live ? 0.f : w;
          }
        acc_to_a<NB / 2>(wa, sc[0]);
      };
      if (full) weights(std::false_type{}); else weights(std::true_type{});
      mma_kn<NB / 2, 2 * KV>(acc, wa, Vs + buf * BK * PV, PV);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // o through V's buffers (free now), and both groups' fp32 LSEs
  const long long bh = (long long)b * p.H + h;
  const float one[2] = {1.f, 1.f};
  acc_to_smem<2 * KV>(Vs, PV, w0, acc, one);
  if (t == 0) {
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
  store_tile<NT, BM, 2 * KV>(Vs, PV, p.o + bh * N * p.DV, q0, N, p.DV, p.vec_o);
}

template <int NB>
__device__ __forceinline__ void scale_acc(float (&c)[NB][4], float s) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[nb][j] *= s;
}

template <int KD, int KV, class C>
__global__ void __launch_bounds__(C::THREADS) diff_bwd_dq_tc_kernel(const DiffBwdArgs p) {
  constexpr int PD = pitch(KD), PV = pitch(KV), BM = C::BM, BK = C::BS, NT = C::THREADS, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [2][BM][PD]
  bf16* Os = Qs + 2 * BM * PD;                   // [BM][PV]   dO
  bf16* Ks = Os + BM * PV;                       // [STAGES][2][BK][PD]
  bf16* Vs = Ks + STAGES * 2 * BK * PD;          // [STAGES][BK][PV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + BK - 1) / BK;
  const long long bh = (long long)b * p.H + h;
  const bf16* kg[2] = {p.k[0].ptr + b * p.k[0].sb + h * p.k[0].sh, p.k[1].ptr + b * p.k[1].sb + h * p.k[1].sh};
  const bf16* vg = p.v.ptr + b * p.v.sb + h * p.v.sh;
  const float lam = *p.lam;

  // step s < T: pass 1 over key tile s; s >= T: pass 2 over key tile s - T.
  // Both read K1, K2 and V. One commit group per step, empty past the last.
  auto issue = [&](int s) {
    if (s < 2 * T) {
      const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
#pragma unroll
      for (int gr = 0; gr < 2; ++gr)
        load_tile<NT, BK, 2 * KD>(Ks + (2 * buf + gr) * BK * PD, PD, kg[gr], p.k[gr].sn, k0, M, p.D, p.k[gr].vec);
      load_tile<NT, BK, 2 * KV>(Vs + buf * BK * PV, PV, vg, p.v.sn, k0, M, p.DV, p.v.vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
    load_tile<NT, BM, 2 * KD>(Qs + gr * BM * PD, PD, p.q[gr].ptr + b * p.q[gr].sb + h * p.q[gr].sh, p.q[gr].sn, q0,
                              N, p.D, p.q[gr].vec);
  load_tile<NT, BM, 2 * KV>(Os, PV, p.dout.ptr + b * p.dout.sb + h * p.dout.sh, p.dout.sn, q0, N, p.DV, p.dout.vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // per group, rows g and g + 8 of the warp: lse log2 e, and delta (this
  // lane's share in pass 1, the row's from the end of pass 1)
  float lse[2][2], delta[2][2];
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + g + 8 * i;
      lse[gr][i] = n < N ? p.lse[gr][bh * N + n] * LOG2E : 0.f;
      delta[gr][i] = 0.f;
    }

  uint32_t qa[2][KD][4], da[KV][4];
  float dq[2][2 * KD][4] = {};
  for (int s = 0; s < 2 * T; ++s) {
    cp_async_wait<STAGES - 2>();  // step s's tiles have landed
    __syncthreads();              // ... for every thread, and step s - 1's buffers are free
    issue(s + STAGES - 1);
    if (s == 0) {
      load_a<KD>(qa[0], Qs, PD, w0);
      load_a<KD>(qa[1], Qs + BM * PD, PD, w0);
      load_a<KV>(da, Os, PV, w0);
    }
    const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
    float sc[2][NB][4] = {}, gp[NB][4] = {};
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) mma_nk<KD, NB>(sc[gr], qa[gr], Ks + (2 * buf + gr) * BK * PD, PD);
    mma_nk<KV, NB>(gp, da, Vs + buf * BK * PV, PV);  // G = dO V^T
    const int live = M - k0 - 2 * t;  // keys past M (ragged last tile only) get P = 0
    const bool full = k0 + BK <= M;
    if (s < T) {
      auto deltas = [&](auto masked) {
#pragma unroll
        for (int gr = 0; gr < 2; ++gr)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float pr = ex2(fmaf(sc[gr][nb][j], LOG2E, -lse[gr][j >> 1]));  // exp(s - lse)
              if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr = 0.f;
              delta[gr][j >> 1] = fmaf(pr, gp[nb][j], delta[gr][j >> 1]);
            }
      };
      if (full) deltas(std::false_type{}); else deltas(std::true_type{});
      if (s == T - 1) {
#pragma unroll
        for (int gr = 0; gr < 2; ++gr)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            delta[gr][i] = quad_sum(delta[gr][i]);
            const int n = q0 + w0 + g + 8 * i;
            if (t == 0 && n < N) p.delta[gr][bh * N + n] = delta[gr][i];
          }
      }
    } else {
#pragma unroll
      for (int gr = 0; gr < 2; ++gr) {
        uint32_t dsa[NB / 2][4];
        auto grads = [&](auto masked) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float pr = ex2(fmaf(sc[gr][nb][j], LOG2E, -lse[gr][j >> 1]));  // exp(s - lse)
              if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr = 0.f;
              sc[gr][nb][j] = pr * (gp[nb][j] - delta[gr][j >> 1]);  // ds
            }
          acc_to_a<NB / 2>(dsa, sc[gr]);
        };
        if (full) grads(std::false_type{}); else grads(std::true_type{});
        mma_kn<NB / 2, 2 * KD>(dq[gr], dsa, Ks + (2 * buf + gr) * BK * PD, PD);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // c_g dq_g through Q's buffers (free now)
  scale_acc<2 * KD>(dq[1], -lam);
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int gr = 0; gr < 2; ++gr) acc_to_smem<2 * KD>(Qs + gr * BM * PD, PD, w0, dq[gr], one);
  __syncthreads();
#pragma unroll
  for (int gr = 0; gr < 2; ++gr) {
    const OutRows& o = p.dq[gr];
    store_tile<NT, BM, 2 * KD>(Qs + gr * BM * PD, PD, o.ptr + b * o.sb + h * o.sh, q0, N, p.D, o.vec);
  }
}

template <int KD, int KV, class C, bool SPLIT_DV>
__global__ void __launch_bounds__(C::THREADS) diff_bwd_dkv_tc_kernel(const DiffBwdArgs p) {
  constexpr int PD = pitch(KD), PV = pitch(KV), BM = C::BM, BN = C::BS, NT = C::THREADS, NB = BN / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);  // [2][BM][PD]
  bf16* Vs = Ks + 2 * BM * PD;                   // [BM][PV]
  bf16* Qs = Vs + BM * PV;                       // [STAGES][2][BN][PD]
  bf16* Os = Qs + STAGES * 2 * BN * PD;          // [STAGES][BN][PV]   dO
  float* Ss = reinterpret_cast<float*>(Os + STAGES * BN * PV);  // [STAGES][4][BN]   lse1, lse2, delta1, delta2

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (N + BN - 1) / BN;
  const long long bh = (long long)b * p.H + h;
  const bf16* qg[2] = {p.q[0].ptr + b * p.q[0].sb + h * p.q[0].sh, p.q[1].ptr + b * p.q[1].sb + h * p.q[1].sh};
  const bf16* og = p.dout.ptr + b * p.dout.sb + h * p.dout.sh;
  const float* stat[4] = {p.lse[0] + bh * N, p.lse[1] + bh * N, p.delta[0] + bh * N, p.delta[1] + bh * N};
  const float lam = *p.lam;

  auto issue = [&](int s) {  // one commit group per query tile, empty past the last
    if (s < T) {
      const int buf = s % STAGES, n0 = s * BN;
#pragma unroll
      for (int gr = 0; gr < 2; ++gr)
        load_tile<NT, BN, 2 * KD>(Qs + (2 * buf + gr) * BN * PD, PD, qg[gr], p.q[gr].sn, n0, N, p.D, p.q[gr].vec);
      load_tile<NT, BN, 2 * KV>(Os + buf * BN * PV, PV, og, p.dout.sn, n0, N, p.DV, p.dout.vec);
      for (int i = threadIdx.x; i < 4 * BN; i += NT) {
        const int r = i % BN, a = i / BN;
        float* dst = Ss + (4 * buf + a) * BN + r;
        if (n0 + r < N) cp_async4(dst, stat[a] + n0 + r); else *dst = 0.f;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
    load_tile<NT, BM, 2 * KD>(Ks + gr * BM * PD, PD, p.k[gr].ptr + b * p.k[gr].sb + h * p.k[gr].sh, p.k[gr].sn, k0,
                              M, p.D, p.k[gr].vec);
  load_tile<NT, BM, 2 * KV>(Vs, PV, p.v.ptr + b * p.v.sb + h * p.v.sh, p.v.sn, k0, M, p.DV, p.v.vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  uint32_t ka[2][KD][4], va[KV][4];
  float dk[2][2 * KD][4] = {}, dv[2 * KV][4] = {}, dv2[2 * KV][4] = {};  // dv2: SPLIT_DV only
  for (int s = 0; s < T; ++s) {
    cp_async_wait<STAGES - 2>();  // query tile s has landed
    __syncthreads();              // ... for every thread, and tile s - 1's buffers are free
    issue(s + STAGES - 1);
    if (s == 0) {
      load_a<KD>(ka[0], Ks, PD, w0);
      load_a<KD>(ka[1], Ks + BM * PD, PD, w0);
      load_a<KV>(va, Vs, PV, w0);
    }
    const int buf = s % STAGES, n0 = s * BN;
    const bf16* Ob = Os + buf * BN * PV;
    const float* Sb = Ss + 4 * buf * BN;
    float st[2][NB][4] = {}, gt[NB][4] = {}, p2t[NB][4];
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) mma_nk<KD, NB>(st[gr], ka[gr], Qs + (2 * buf + gr) * BN * PD, PD);  // S_g^T
    mma_nk<KV, NB>(gt, va, Ob, PV);  // G^T = V dO^T
    uint32_t wa[NB / 2][4], wa2[NB / 2][4], dsa[2][NB / 2][4];
    const int live = N - n0 - 2 * t;  // query rows past N (ragged last tile only) get P = 0
    auto grads = [&](auto masked) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = nb * 8 + 2 * t + i;  // this lane's query row of elements j = i, i + 2
          const float l1 = Sb[c] * LOG2E, l2 = Sb[BN + c] * LOG2E, d1 = Sb[2 * BN + c], d2 = Sb[3 * BN + c];
#pragma unroll
          for (int j = i; j < 4; j += 2) {
            float p1 = ex2(fmaf(st[0][nb][j], LOG2E, -l1)), p2 = ex2(fmaf(st[1][nb][j], LOG2E, -l2));
            if (decltype(masked)::value && nb * 8 + i >= live) p1 = p2 = 0.f;
            const float gv = gt[nb][j];
            st[0][nb][j] = p1 * (gv - d1);  // ds_1^T
            st[1][nb][j] = p2 * (gv - d2);  // ds_2^T
            if constexpr (SPLIT_DV) {
              gt[nb][j] = p1;  // P1^T
              p2t[nb][j] = p2;  // P2^T
            } else {
              gt[nb][j] = fmaf(-lam, p2, p1);  // w^T
            }
          }
        }
      acc_to_a<NB / 2>(wa, gt);
      if constexpr (SPLIT_DV) acc_to_a<NB / 2>(wa2, p2t);
      acc_to_a<NB / 2>(dsa[0], st[0]);
      acc_to_a<NB / 2>(dsa[1], st[1]);
    };
    if (n0 + BN <= N) grads(std::false_type{}); else grads(std::true_type{});
    mma_kn<NB / 2, 2 * KV>(dv, wa, Ob, PV);
    if constexpr (SPLIT_DV) mma_kn<NB / 2, 2 * KV>(dv2, wa2, Ob, PV);
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) mma_kn<NB / 2, 2 * KD>(dk[gr], dsa[gr], Qs + (2 * buf + gr) * BN * PD, PD);
  }
  cp_async_wait<0>();
  __syncthreads();

  // c_g dk_g and dv through K's and V's buffers (free now)
  scale_acc<2 * KD>(dk[1], -lam);
  if constexpr (SPLIT_DV) {
#pragma unroll
    for (int nb = 0; nb < 2 * KV; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[nb][j] -= lam * dv2[nb][j];
  }
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int gr = 0; gr < 2; ++gr) acc_to_smem<2 * KD>(Ks + gr * BM * PD, PD, w0, dk[gr], one);
  acc_to_smem<2 * KV>(Vs, PV, w0, dv, one);
  __syncthreads();
#pragma unroll
  for (int gr = 0; gr < 2; ++gr) {
    const OutRows& o = p.dk[gr];
    store_tile<NT, BM, 2 * KD>(Ks + gr * BM * PD, PD, o.ptr + b * o.sb + h * o.sh, k0, M, p.D, o.vec);
  }
  store_tile<NT, BM, 2 * KV>(Vs, PV, p.dv + bh * M * p.DV, k0, M, p.DV, p.vec_dv);
}

// K6's one launch. The dq kernel's two passes over the keys; in pass 2 each
// warp also writes round(ds_g) (the bits of its A fragments, so dq and dk use
// one rounded ds) and round(P_g) of its 16 query rows to the shared tiles Ts,
// passes one barrier, and takes its share of the key tile's dk_g and dv
// partials over the block's BM query rows: with NW = BK / 16 warps, warp w all
// of keys 16w .. 16w+15; with NW = 2 BK / 16, warps w < BK / 16 the dk_g of
// those keys and warps w >= BK / 16 the dv of keys 16 (w - BK / 16) .. . The
// loop-top barrier orders the next tile's writes after every read.
template <int KD, int KV, class C>
__global__ void __launch_bounds__(C::THREADS) diff_bwd_one_tc_kernel(const DiffBwdArgs p) {
  constexpr int PD = pitch(KD), PV = pitch(KV), BM = C::BM, BK = C::BS, NT = C::THREADS, NB = BK / 8;
  constexpr int R = BK / 16, KS = BM / 16;  // 16-key blocks of a key tile; 16-query steps of the block
  constexpr int PS = pitch(R);              // the Ts tiles' pitch: stores and ldmatrix rows on distinct banks
  static_assert(C::NW == R || C::NW == 2 * R, "one warp, or a dk and a dv warp, for each 16 keys");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [2][BM][PD]
  bf16* Os = Qs + 2 * BM * PD;                   // [BM][PV]   dO
  bf16* Ks = Os + BM * PV;                       // [STAGES][2][BK][PD]
  bf16* Vs = Ks + STAGES * 2 * BK * PD;          // [STAGES][BK][PV]
  bf16* Ts = Vs + STAGES * BK * PV;              // [4][BM][PS]   round(ds_1), round(ds_2), round(P_1), round(P_2)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + BK - 1) / BK;
  const long long bh = (long long)b * p.H + h;
  const bf16* kg[2] = {p.k[0].ptr + b * p.k[0].sb + h * p.k[0].sh, p.k[1].ptr + b * p.k[1].sb + h * p.k[1].sh};
  const bf16* vg = p.v.ptr + b * p.v.sb + h * p.v.sh;
  const float lam = *p.lam;

  // step s < T: pass 1 over key tile s; s >= T: pass 2 over key tile s - T.
  // Both read K1, K2 and V. One commit group per step, empty past the last.
  auto issue = [&](int s) {
    if (s < 2 * T) {
      const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
#pragma unroll
      for (int gr = 0; gr < 2; ++gr)
        load_tile<NT, BK, 2 * KD>(Ks + (2 * buf + gr) * BK * PD, PD, kg[gr], p.k[gr].sn, k0, M, p.D, p.k[gr].vec);
      load_tile<NT, BK, 2 * KV>(Vs + buf * BK * PV, PV, vg, p.v.sn, k0, M, p.DV, p.v.vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
    load_tile<NT, BM, 2 * KD>(Qs + gr * BM * PD, PD, p.q[gr].ptr + b * p.q[gr].sb + h * p.q[gr].sh, p.q[gr].sn, q0,
                              N, p.D, p.q[gr].vec);
  load_tile<NT, BM, 2 * KV>(Os, PV, p.dout.ptr + b * p.dout.sb + h * p.dout.sh, p.dout.sn, q0, N, p.DV, p.dout.vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // per group, rows g and g + 8 of the warp: lse log2 e (+inf past N, so that
  // those rows get P = ds = 0 and add nothing to dk and dv), and delta (this
  // lane's share in pass 1, the row's from the end of pass 1)
  float lse[2][2], delta[2][2];
#pragma unroll
  for (int gr = 0; gr < 2; ++gr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + g + 8 * i;
      lse[gr][i] = n < N ? p.lse[gr][bh * N + n] * LOG2E : INFINITY;
      delta[gr][i] = 0.f;
    }

  uint32_t qa[2][KD][4], da[KV][4];
  float dq[2][2 * KD][4] = {};
  for (int s = 0; s < 2 * T; ++s) {
    cp_async_wait<STAGES - 2>();  // step s's tiles have landed
    __syncthreads();              // ... for every thread; step s - 1's buffers and the Ts tiles are free
    issue(s + STAGES - 1);
    if (s == 0) {
      load_a<KD>(qa[0], Qs, PD, w0);
      load_a<KD>(qa[1], Qs + BM * PD, PD, w0);
      load_a<KV>(da, Os, PV, w0);
    }
    const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
    float sc[2][NB][4] = {}, gp[NB][4] = {};
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) mma_nk<KD, NB>(sc[gr], qa[gr], Ks + (2 * buf + gr) * BK * PD, PD);
    mma_nk<KV, NB>(gp, da, Vs + buf * BK * PV, PV);  // G = dO V^T
    const int live = M - k0 - 2 * t;  // keys past M (ragged last tile only) get P = 0
    const bool full = k0 + BK <= M;
    if (s < T) {
      auto deltas = [&](auto masked) {
#pragma unroll
        for (int gr = 0; gr < 2; ++gr)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float pr = ex2(fmaf(sc[gr][nb][j], LOG2E, -lse[gr][j >> 1]));  // exp(s - lse)
              if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr = 0.f;
              delta[gr][j >> 1] = fmaf(pr, gp[nb][j], delta[gr][j >> 1]);
            }
      };
      if (full) deltas(std::false_type{}); else deltas(std::true_type{});
      if (s == T - 1) {
#pragma unroll
        for (int gr = 0; gr < 2; ++gr)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            delta[gr][i] = quad_sum(delta[gr][i]);
            const int n = q0 + w0 + g + 8 * i;
            if (t == 0 && n < N) p.delta[gr][bh * N + n] = delta[gr][i];
          }
      }
      continue;
    }
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) {
      bf16* ds_t = Ts + gr * BM * PS;
      bf16* p_t = Ts + (2 + gr) * BM * PS;
      uint32_t dsa[NB / 2][4];
      auto grads = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          float pr[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pr[j] = ex2(fmaf(sc[gr][nb][j], LOG2E, -lse[gr][j >> 1]));  // exp(s - lse)
            if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr[j] = 0.f;
            sc[gr][nb][j] = pr[j] * (gp[nb][j] - delta[gr][j >> 1]);  // ds
          }
          *reinterpret_cast<uint32_t*>(p_t + (w0 + g) * PS + nb * 8 + 2 * t) = pack_bf16(pr[0], pr[1]);
          *reinterpret_cast<uint32_t*>(p_t + (w0 + g + 8) * PS + nb * 8 + 2 * t) = pack_bf16(pr[2], pr[3]);
        }
        acc_to_a<NB / 2>(dsa, sc[gr]);
      };
      if (full) grads(std::false_type{}); else grads(std::true_type{});
      mma_kn<NB / 2, 2 * KD>(dq[gr], dsa, Ks + (2 * buf + gr) * BK * PD, PD);
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {  // the A fragments' bits: row g, g + 8; columns 16 kk + 2t, + 8
        uint32_t* r0 = reinterpret_cast<uint32_t*>(ds_t + (w0 + g) * PS + 16 * kk + 2 * t);
        uint32_t* r8 = reinterpret_cast<uint32_t*>(ds_t + (w0 + g + 8) * PS + 16 * kk + 2 * t);
        r0[0] = dsa[kk][0];
        r8[0] = dsa[kk][1];
        r0[4] = dsa[kk][2];
        r8[4] = dsa[kk][3];
      }
    }
    __syncthreads();
    // this warp's 16 keys of the tile: A fragments of round(ds_g)^T or
    // round(P_g)^T (rows: keys) from a [query][key] tile, transposed by ldmatrix
    const int kb = warp % R, key0 = k0 + 16 * kb;
    const int a_off = ((lane & 7) + (lane >> 4) * 8) * PS + 16 * kb + ((lane >> 3) & 1) * 8;
    auto tile_t = [&](uint32_t (&a)[KS][4], const bf16* tile) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4_trans(a[kk], tile + a_off + kk * 16 * PS);
    };
    if (C::NW == R || warp < R) {
#pragma unroll
      for (int gr = 0; gr < 2; ++gr) {
        uint32_t a[KS][4];
        tile_t(a, Ts + gr * BM * PS);
        float part[2 * KD][4] = {};
        mma_kn<KS, 2 * KD>(part, a, Qs + gr * BM * PD, PD);
        if (gr == 1) scale_acc<2 * KD>(part, -lam);
        red_add_rows<2 * KD>(p.dk_acc[gr] + bh * M * p.D, key0, 0, M, p.D, part);
      }
    }
    if (C::NW == R || warp >= R) {
      uint32_t a[KS][4];
      float part[2 * KV][4] = {}, part2[2 * KV][4] = {};
      tile_t(a, Ts + 2 * BM * PS);
      mma_kn<KS, 2 * KV>(part, a, Os, PV);
      tile_t(a, Ts + 3 * BM * PS);
      mma_kn<KS, 2 * KV>(part2, a, Os, PV);
#pragma unroll
      for (int nb = 0; nb < 2 * KV; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[nb][j] -= lam * part2[nb][j];
      red_add_rows<2 * KV>(p.dv_acc + bh * M * p.DV, key0, 0, M, p.DV, part);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // c_g dq_g through Q's buffers (free now)
  scale_acc<2 * KD>(dq[1], -lam);
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int gr = 0; gr < 2; ++gr) acc_to_smem<2 * KD>(Qs + gr * BM * PD, PD, w0, dq[gr], one);
  __syncthreads();
#pragma unroll
  for (int gr = 0; gr < 2; ++gr) {
    const OutRows& o = p.dq[gr];
    store_tile<NT, BM, 2 * KD>(Qs + gr * BM * PD, PD, o.ptr + b * o.sb + h * o.sh, q0, N, p.D, o.vec);
  }
}

template <class C>
inline size_t diff_fwd_smem(int kd, int kv) {
  return 2 * (2 * C::BM * pitch(kd) + STAGES * C::BS * (2 * pitch(kd) + pitch(kv)));
}
template <class C>
inline size_t diff_dq_smem(int kd, int kv) {
  return 2 * (C::BM + STAGES * C::BS) * (2 * pitch(kd) + pitch(kv));
}
template <class C>
inline size_t diff_one_smem(int kd, int kv) {
  return diff_dq_smem<C>(kd, kv) + 2 * 4 * C::BM * pitch(C::BS / 16);  // and the four Ts tiles
}
template <class C>
inline size_t diff_dkv_smem(int kd, int kv) {
  return 2 * (C::BM + STAGES * C::BS) * (2 * pitch(kd) + pitch(kv)) + 4 * 4 * STAGES * C::BS;
}

using DiffFwdTiles = Tiles<4, 64>;
using DiffDqTiles = Tiles<4, 64>;
using DiffDkvTiles = Tiles<4, 32>;
// K6: 64 query rows (4 warps) against key tiles of 64 (PERF.md; timed with
// cenet_tpu_torch/tools/time_tilings.py)
using DiffOneTiles = Tiles<4, 64>;

// The forward on `stream`; returns the launch's cudaError_t (0 on success).
// Launchers are templates for the reason given in attention_tc.cuh.
template <int = 0>
inline int diff_fwd_launch(const DiffFwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  return with_steps(a.D, a.DV, [&](auto kd, auto kv) {
    constexpr int KD = decltype(kd)::value, KV = decltype(kv)::value;
    using C = DiffFwdTiles;
    return launch_one<C>(diff_fwd_tc_kernel<KD, KV, C>, a.N, a.H, B, diff_fwd_smem<C>(KD, KV), stream, a);
  });
}

// The dq kernel (which writes delta_1, delta_2), then the dkv kernel, on
// `stream`; returns the first failing launch's cudaError_t (0 on success).
// SPLIT_DV: K7's dv rounding (each P_g rounded apart), else K3's.
template <bool SPLIT_DV = false>
inline int diff_bwd_launch(const DiffBwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  return with_steps(a.D, a.DV, [&](auto kd, auto kv) {
    constexpr int KD = decltype(kd)::value, KV = decltype(kv)::value;
    const int rc = launch_one<DiffDqTiles>(diff_bwd_dq_tc_kernel<KD, KV, DiffDqTiles>, a.N, a.H, B,
                                           diff_dq_smem<DiffDqTiles>(KD, KV), stream, a);
    if (rc != 0) return rc;
    return launch_one<DiffDkvTiles>(diff_bwd_dkv_tc_kernel<KD, KV, DiffDkvTiles, SPLIT_DV>, a.M, a.H, B,
                                    diff_dkv_smem<DiffDkvTiles>(KD, KV), stream, a);
  });
}

// K6's one kernel on `stream` (a.dk_acc, a.dv_acc zeroed by the caller), with
// tiling C; returns the launch's cudaError_t (0 on success).
template <class C = DiffOneTiles>
inline int diff_bwd_one_launch(const DiffBwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  return with_steps(a.D, a.DV, [&](auto kd, auto kv) {
    constexpr int KD = decltype(kd)::value, KV = decltype(kv)::value;
    return launch_one<C>(diff_bwd_one_tc_kernel<KD, KV, C>, a.N, a.H, B, diff_one_smem<C>(KD, KV), stream, a);
  });
}

}  // namespace tc
}  // namespace cenet
