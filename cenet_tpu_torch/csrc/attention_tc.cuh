// Attention forward and backward on Hopper's tensor cores, bf16 (sm_90a).
//
// The bf16 designs of K2 (attention_fwd.cu), K4 (attention_bwd.cu) and K8
// (attention_bwd_fused.cu), which replace _pallas_attention_fwd_impl,
// _pallas_attention_bwd_impl and _pallas_attention_bwd_fused_impl of
// cenet_tpu/ops/pallas_attention.py:
//   o = softmax(q k^T) v,  q/k (B, H, N|M, d), v (B, H, M, dv), q pre-scaled;
//   P = exp(q k^T - lse), ds = P (dO v^T - Delta),
//   dq = round(ds) k,  dk = round(ds)^T q,  dv = round(P)^T dO.
// Every product is mma.sync.m16n8k16 (bf16 operands, fp32 sums), in the manner
// of FlashAttention-2. At the Nonlocal sites (d = dv = 64 and 128) the work is
// bound by operations on an H100 SXM (989 TFLOP/s bf16 against 3.35 TB/s);
// mma.sync reaches the tensor cores that the fp32 CUDA-core design of
// attention_{fwd,bwd}_common.cuh leaves idle.
//
// Numerics: the rounding points of the Pallas bodies.
//   forward   (_attn_fwd_kernel) whole-row max m, e = exp(s - m) in fp32,
//             l = sum of the unrounded e in fp32, o = (round(e) v) / l with
//             fp32 sums, lse = m + log l. So two passes over the keys: pass 1
//             computes the logits and the row max only; pass 2 recomputes the
//             logits with the same fragment code (bit-identical, so m is the
//             max of what pass 2 exponentiates), forms e and l and multiplies
//             by V. One exponential per logit; the arithmetic is
//             2 N M (2d + dv), 1.5x the 2 N M (d + dv) of the bound at d = dv.
//             A one-pass online softmax would round e against a running max,
//             which is not the Pallas function.
//   backward  (_attn_dq_kernel, _attn_dkv_kernel) P and ds in fp32, rounded to
//             bf16 only as the A operand of the next product; Delta =
//             rowsum(dO o) comes from the caller.
//   exp(x) is ex2.approx.ftz(x log2 e), the scaled max or lse folded into one
//   fused multiply-add.
//
// Blocks: NW warps; a block owns BM = 16 NW rows, 16 per warp, whose A
// fragments stay in registers, and streams tiles of BS rows of the other side
// through two shared buffers with cp.async (a step waits for its tile, passes
// one barrier, starts the copy of the next tile into the buffer the previous
// step used, and multiplies):
//   attention_fwd_tc_kernel      query rows; streams K (pass 1), K and V
//                                (pass 2). Probabilities go from the logits'
//                                accumulator straight into the A fragments of
//                                P V, in registers. o is divided by l, staged
//                                in shared memory and stored 16 bytes a thread.
//   attention_bwd_dq_tc_kernel   query rows (Q, dO in registers, lse and Delta
//                                per row); streams K and V: S = Q K^T,
//                                dP = dO V^T, ds = P (dP - Delta),
//                                dq += round(ds) K.
//   attention_bwd_dkv_tc_kernel  keys (K, V in registers); streams Q, dO, lse
//                                and Delta: S^T = K Q^T, dP^T = V dO^T,
//                                dv += round(P^T) dO, dk += round(ds^T) Q.
//                                Working on the transposes keeps every A
//                                operand in registers.
//   attention_bwd_fused_tc_kernel  K8: the dkv kernel that also forms dq, so
//                                each (key tile, query tile) pair's logits
//                                are computed once. Each step writes
//                                round(ds^T) (the A operand of dk) to a shared
//                                BM x BN tile and passes one barrier; warps
//                                then read it back as ds with ldmatrix.trans
//                                (the A operand of ds K) against the block's
//                                own K tile, and add the query tile's dq
//                                partial (BN x d, summed over the block's keys)
//                                into a zeroed fp32 (B, H, N, d) buffer with
//                                16-byte vector reductions (red.global.add
//                                .v4.f32, four columns a lane after one
//                                shuffle). The caller casts that buffer once.
// The dq and dkv kernels run one after the other on the caller's stream and
// each output element is written by one block: no atomics, and repeat runs
// are bit-identical. K8's dk and dv are written the same way and repeat
// exactly; its dq sums across key tiles in no fixed order, so repeat runs
// differ in dq's last bits, as the CUDA-core K8 does. The tilings (FwdTiles,
// DqTiles, DkvTiles, FusedTiles) were chosen by timing the Nonlocal sites on
// an H100.
//
// Shared tiles: rows of 16 KD (or 16 KV) bf16 with 8 more as padding, so the
// eight 16-byte rows of an ldmatrix tile fall on distinct banks. d and dv are
// zero-padded to KD, KV 16-deep steps (KD, KV in {1, 2, 4, 8}; zero columns add
// nothing). B operands come in with ldmatrix: plain for a tile stored [n][k]
// (K in q k^T), .trans for one stored [k][n] (V in P V).
//
// Edges: any N, M >= 1; d, dv <= 128. Rows past N or M are staged as zeros;
// masked keys get no share of the max and e = P = 0 (checked only in a
// ragged last tile); rows past the end are not stored. Inputs take any
// (batch, head, row) strides with unit last stride: a 16-byte chunk goes by
// cp.async where the base and strides keep it aligned and it lies inside the
// row, else by element loads in the same loop (d = 20: 40-byte rows). Outputs
// are contiguous.

#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_ptx.cuh"

namespace cenet {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int MAX_DIM = 128;
constexpr int STAGES = 2;  // shared buffers per streamed operand: one in flight, one multiplied
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

// A block's tiling: NW warps owning BM = 16 NW rows, against streamed tiles
// of BS rows.
template <int NW_, int BS_>
struct Tiles {
  static constexpr int NW = NW_, BS = BS_, THREADS = 32 * NW, BM = 16 * NW;
  static_assert(BS % 16 == 0, "whole 16-row blocks");
};

// A strided (B, H, rows, cols) bf16 operand with unit stride on cols.
struct Operand {
  const bf16* ptr;
  long long sb, sh, sn;
  int vec;  // base and strides keep every 8-column chunk 16-byte aligned
};

inline Operand operand(const void* p, long long sb, long long sh, long long sn, int B, int H) {
  const bool vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || sb % 8 == 0) && (H == 1 || sh % 8 == 0) &&
                   sn % 8 == 0;
  return {static_cast<const bf16*>(p), sb, sh, sn, vec ? 1 : 0};
}

// 16-byte stores of a contiguous output with rows of `cols`
inline int out_vec(const void* p, int cols) { return reinterpret_cast<uintptr_t>(p) % 16 == 0 && cols % 8 == 0; }

struct FwdArgs {
  Operand q, k, v;
  bf16* o;     // (B, H, N, DV)
  float* lse;  // (B, H, N)
  int H, N, M, D, DV;
  int vec_o;
};

struct BwdArgs {
  Operand q, k, v, dout;
  const float* lse;    // (B, H, N)
  const float* delta;  // (B, H, N)
  bf16* dq;            // (B, H, N, D)
  bf16* dk;            // (B, H, M, D)
  bf16* dv;            // (B, H, M, DV)
  int H, N, M, D, DV;
  int vec_dq, vec_dk, vec_dv;
  float* dq_acc;       // the fused kernel's dq: fp32 (B, H, N, D), zeroed by the caller
};

// Stage rows row0 .. row0+ROWS-1 (of `rows`) and columns 0 .. 8 CH - 1 (of
// `cols`) of one (batch, head) slice `g` into a shared tile of pitch `pitch`,
// with NT threads, each of which keeps one 8-column chunk; zeros outside. The
// cp.async copies join the caller's next commit group.
template <int NT, int ROWS, int CH>
__device__ __forceinline__ void load_tile(bf16* sm, int pitch, const bf16* g, long long sn, int row0, int rows,
                                          int cols, bool vec) {
  static_assert(NT % CH == 0, "each thread keeps one column chunk");
  constexpr int RSTEP = NT / CH;
  const int c = (threadIdx.x % CH) * 8, r0 = threadIdx.x / CH;
  const bool whole = vec && c + 8 <= cols, part = c < cols;
#pragma unroll
  for (int k = 0; k < (ROWS + RSTEP - 1) / RSTEP; ++k) {
    const int r = r0 + k * RSTEP, row = row0 + r;
    if (ROWS % RSTEP != 0 && r >= ROWS) break;
    bf16* dst = sm + r * pitch + c;
    if (row < rows && whole) {
      cp_async16(dst, g + row * sn + c);
    } else if (row < rows && part) {
      const bf16* src = g + row * sn + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = c + e < cols ? src[e] : __float2bfloat16(0.f);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Rows row0 .. of a shared tile into the contiguous (rows, cols) slice `g`,
// with NT threads; rows past `rows` are not stored.
template <int NT, int ROWS, int CH>
__device__ __forceinline__ void store_tile(const bf16* sm, int pitch, bf16* g, int row0, int rows, int cols,
                                           bool vec) {
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, row = row0 + r;
    if (row >= rows || c >= cols) continue;
    bf16* dst = g + (long long)row * cols + c;
    const bf16* src = sm + r * pitch + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < cols; ++e) dst[e] = src[e];
    }
  }
}

// A fragments of rows r0 .. r0+15 of a shared tile, all KS 16-column steps
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* sm, int pitch, int r0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = sm + (r0 + (lane & 15)) * pitch + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// acc (16 x 8 NB) += a (16 x 16 KS) B, with B (16 KS x 8 NB) stored as rows n of
// length k ([n][k] at `sm`: K in q k^T, Q in K Q^T). For each 16-deep step the
// B fragments of all NB blocks are loaded first, then the NB products, which
// are independent of each other.
template <int KS, int NB>
__device__ __forceinline__ void mma_nk(float (&acc)[NB][4], const uint32_t (&a)[KS][4], const bf16* sm, int pitch) {
  static_assert(NB % 2 == 0, "n blocks come in pairs");
  const int lane = threadIdx.x & 31;
  const bf16* p = sm + ((lane & 7) + ((lane >> 4) << 3)) * pitch + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t b[NB / 2][4];
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) ldsm_x4(b[n2], p + n2 * 16 * pitch + kk * 16);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      mma_bf16(acc[2 * n2], a[kk], b[n2][0], b[n2][1]);
      mma_bf16(acc[2 * n2 + 1], a[kk], b[n2][2], b[n2][3]);
    }
  }
}

// acc (16 x 8 NB) += a (16 x 16 KS) B, with B stored as rows k of length n
// ([k][n] at `sm`: V in P V, K in ds K, dO in P^T dO, Q in ds^T Q)
template <int KS, int NB>
__device__ __forceinline__ void mma_kn(float (&acc)[NB][4], const uint32_t (&a)[KS][4], const bf16* sm, int pitch) {
  static_assert(NB % 2 == 0, "n blocks come in pairs");
  const int lane = threadIdx.x & 31;
  const bf16* p = sm + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t b[NB / 2][4];
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) ldsm_x4_trans(b[n2], p + kk * 16 * pitch + n2 * 16);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      mma_bf16(acc[2 * n2], a[kk], b[n2][0], b[n2][1]);
      mma_bf16(acc[2 * n2 + 1], a[kk], b[n2][2], b[n2][3]);
    }
  }
}

// The accumulator of a 16 x 16 KS product, rounded to bf16, as the A fragments
// of the next product (the C and A layouts agree pairwise)
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4], const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rows r0 .. r0+15 of a shared tile from a warp's accumulator, divided by
// div[0] (rows g) and div[1] (rows g + 8), rounded to bf16
template <int NB>
__device__ __forceinline__ void acc_to_smem(bf16* sm, int pitch, int r0, const float (&c)[NB][4],
                                            const float (&div)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    *reinterpret_cast<uint32_t*>(sm + (r0 + g) * pitch + nb * 8 + 2 * t) =
        pack_bf16(c[nb][0] / div[0], c[nb][1] / div[0]);
    *reinterpret_cast<uint32_t*>(sm + (r0 + g + 8) * pitch + nb * 8 + 2 * t) =
        pack_bf16(c[nb][2] / div[1], c[nb][3] / div[1]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__host__ __device__ constexpr int pitch(int steps) { return 16 * steps + 8; }

template <int KD, int KV, class C>
__global__ void __launch_bounds__(C::THREADS) attention_fwd_tc_kernel(const FwdArgs p) {
  constexpr int PD = pitch(KD), PV = pitch(KV), BM = C::BM, BK = C::BS, NT = C::THREADS, NB = BK / 8;
  static_assert(BM <= STAGES * BK, "o is staged in V's buffers");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BM][PD]
  bf16* Ks = Qs + BM * PD;                       // [STAGES][BK][PD]
  bf16* Vs = Ks + STAGES * BK * PD;              // [STAGES][BK][PV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + BK - 1) / BK;
  const bf16* qg = p.q.ptr + b * p.q.sb + h * p.q.sh;
  const bf16* kg = p.k.ptr + b * p.k.sb + h * p.k.sh;
  const bf16* vg = p.v.ptr + b * p.v.sb + h * p.v.sh;

  // step s < T: pass 1 over key tile s (K); s >= T: pass 2 over key tile s - T (K, V).
  // One commit group per step, empty past the last.
  auto issue = [&](int s) {
    if (s < 2 * T) {
      const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
      load_tile<NT, BK, 2 * KD>(Ks + buf * BK * PD, PD, kg, p.k.sn, k0, M, p.D, p.k.vec);
      if (s >= T) load_tile<NT, BK, 2 * KV>(Vs + buf * BK * PV, PV, vg, p.v.sn, k0, M, p.DV, p.v.vec);
    }
    cp_async_commit();
  };
  load_tile<NT, BM, 2 * KD>(Qs, PD, qg, p.q.sn, q0, N, p.D, p.q.vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  uint32_t qa[KD][4];
  // rows g and g + 8 of the warp: the row max, it times log2 e, and this lane's share of the sum of e
  float mx[2] = {-INFINITY, -INFINITY}, ms[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
  float acc[2 * KV][4] = {};
  for (int s = 0; s < 2 * T; ++s) {
    cp_async_wait<STAGES - 2>();  // step s's tile has landed
    __syncthreads();              // ... for every thread, and step s - 1's buffer is free
    issue(s + STAGES - 1);
    if (s == 0) load_a<KD>(qa, Qs, PD, w0);
    const int buf = s % STAGES, k0 = (s < T ? s : s - T) * BK;
    float sc[NB][4] = {};
    mma_nk<KD, NB>(sc, qa, Ks + buf * BK * PD, PD);
    // keys past M (in a ragged last tile only) take no part in the max and get e = 0
    const int live = M - k0 - 2 * t;  // element (nb, j) is a key below M iff nb * 8 + (j & 1) < live
    const bool full = k0 + BK <= M;
    if (s < T) {
      auto row_max = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (!decltype(masked)::value || nb * 8 + (j & 1) < live) mx[j >> 1] = fmaxf(mx[j >> 1], sc[nb][j]);
      };
      if (full) row_max(std::false_type{}); else row_max(std::true_type{});
      if (s == T - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]), ms[i] = mx[i] * LOG2E;
      }
    } else {
      uint32_t pa[NB / 2][4];
      auto exps = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float e = ex2(fmaf(sc[nb][j], LOG2E, -ms[j >> 1]));  // exp(s - m)
            if (decltype(masked)::value && nb * 8 + (j & 1) >= live) e = 0.f;
            sc[nb][j] = e;
            l[j >> 1] += e;
          }
        acc_to_a<NB / 2>(pa, sc);
      };
      if (full) exps(std::false_type{}); else exps(std::true_type{});
      mma_kn<NB / 2, 2 * KV>(acc, pa, Vs + buf * BK * PV, PV);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // o / l through V's buffers (free now), and the fp32 LSE
  const long long bh = (long long)b * p.H + h;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  acc_to_smem<2 * KV>(Vs, PV, w0, acc, l);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + g + 8 * i;
      if (n < N) p.lse[bh * N + n] = mx[i] + logf(l[i]);
    }
  }
  __syncthreads();
  store_tile<NT, BM, 2 * KV>(Vs, PV, p.o + bh * N * p.DV, q0, N, p.DV, p.vec_o);
}

template <int KD, int KV, class C>
__global__ void __launch_bounds__(C::THREADS) attention_bwd_dq_tc_kernel(const BwdArgs p) {
  constexpr int PD = pitch(KD), PV = pitch(KV), BM = C::BM, BK = C::BS, NT = C::THREADS, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BM][PD]
  bf16* Os = Qs + BM * PD;                       // [BM][PV]   dO
  bf16* Ks = Os + BM * PV;                       // [STAGES][BK][PD]
  bf16* Vs = Ks + STAGES * BK * PD;              // [STAGES][BK][PV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + BK - 1) / BK;
  const long long bh = (long long)b * p.H + h;
  const bf16* kg = p.k.ptr + b * p.k.sb + h * p.k.sh;
  const bf16* vg = p.v.ptr + b * p.v.sb + h * p.v.sh;

  auto issue = [&](int s) {  // one commit group per key tile, empty past the last
    if (s < T) {
      const int buf = s % STAGES;
      load_tile<NT, BK, 2 * KD>(Ks + buf * BK * PD, PD, kg, p.k.sn, s * BK, M, p.D, p.k.vec);
      load_tile<NT, BK, 2 * KV>(Vs + buf * BK * PV, PV, vg, p.v.sn, s * BK, M, p.DV, p.v.vec);
    }
    cp_async_commit();
  };
  load_tile<NT, BM, 2 * KD>(Qs, PD, p.q.ptr + b * p.q.sb + h * p.q.sh, p.q.sn, q0, N, p.D, p.q.vec);
  load_tile<NT, BM, 2 * KV>(Os, PV, p.dout.ptr + b * p.dout.sb + h * p.dout.sh, p.dout.sn, q0, N, p.DV,
                            p.dout.vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  float lse[2], delta[2];  // rows g and g + 8 of the warp: lse log2 e, Delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + w0 + g + 8 * i;
    lse[i] = n < N ? p.lse[bh * N + n] * LOG2E : 0.f;
    delta[i] = n < N ? p.delta[bh * N + n] : 0.f;
  }

  uint32_t qa[KD][4], da[KV][4];
  float dq[2 * KD][4] = {};
  for (int s = 0; s < T; ++s) {
    cp_async_wait<STAGES - 2>();  // key tile s has landed
    __syncthreads();              // ... for every thread, and tile s - 1's buffer is free
    issue(s + STAGES - 1);
    if (s == 0) {
      load_a<KD>(qa, Qs, PD, w0);
      load_a<KV>(da, Os, PV, w0);
    }
    const int buf = s % STAGES, k0 = s * BK;
    const bf16* Kb = Ks + buf * BK * PD;
    float sc[NB][4] = {}, dp[NB][4] = {};
    mma_nk<KD, NB>(sc, qa, Kb, PD);
    mma_nk<KV, NB>(dp, da, Vs + buf * BK * PV, PV);
    uint32_t dsa[NB / 2][4];
    const int live = M - k0 - 2 * t;  // keys past M (ragged last tile only) get P = 0
    auto grads = [&](auto masked) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float pr = ex2(fmaf(sc[nb][j], LOG2E, -lse[j >> 1]));  // exp(s - lse)
          if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr = 0.f;
          sc[nb][j] = pr * (dp[nb][j] - delta[j >> 1]);  // ds
        }
      acc_to_a<NB / 2>(dsa, sc);
    };
    if (k0 + BK <= M) grads(std::false_type{}); else grads(std::true_type{});
    mma_kn<NB / 2, 2 * KD>(dq, dsa, Kb, PD);
  }
  cp_async_wait<0>();
  __syncthreads();

  const float one[2] = {1.f, 1.f};
  acc_to_smem<2 * KD>(Qs, PD, w0, dq, one);
  __syncthreads();
  store_tile<NT, BM, 2 * KD>(Qs, PD, p.dq + bh * N * p.D, q0, N, p.D, p.vec_dq);
}

// Rows row0 + g, row0 + g + 8 and columns col0 + 8 nb + 2t, + 1 of a warp's
// 16 x 8 NB fp32 accumulator, added into the fp32 (rows, cols) matrix `out`
// with reductions; rows past `rows` and columns past `cols` are skipped. Where
// cols % 4 == 0, lanes t and t ^ 1 trade half their sums (one shuffle pair),
// so that the even lane adds row g, columns 2t .. 2t+3 and the odd lane row
// g + 8, columns 2t-2 .. 2t+1, each as one 16-byte red.global.add.v4.f32.
template <int NB>
__device__ __forceinline__ void red_add_rows(float* out, int row0, int col0, int rows, int cols,
                                             const float (&c)[NB][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (cols % 4 == 0) {
    const bool odd = t & 1;
    const int row = row0 + g + (odd ? 8 : 0);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float x = __shfl_xor_sync(0xffffffffu, odd ? c[nb][0] : c[nb][2], 1);
      const float y = __shfl_xor_sync(0xffffffffu, odd ? c[nb][1] : c[nb][3], 1);
      const int col = col0 + nb * 8 + 2 * (t & 2);
      if (row < rows && col < cols)
        atomicAdd(reinterpret_cast<float4*>(out + (long long)row * cols + col),
                  odd ? make_float4(x, y, c[nb][2], c[nb][3]) : make_float4(c[nb][0], c[nb][1], x, y));
    }
  } else {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row0 + g + 8 * (j >> 1), col = col0 + nb * 8 + 2 * t + (j & 1);
        if (row < rows && col < cols) atomicAdd(out + (long long)row * cols + col, c[nb][j]);
      }
  }
}

// The dk/dv kernel's body (K4's attention_bwd_dkv_tc_kernel) and, with FUSED,
// K8's: the same loop, which then also adds each query tile's dq partial into
// p.dq_acc through a shared ds tile.
template <int KD, int KV, class C, bool FUSED>
__device__ __forceinline__ void bwd_dkv_body(const BwdArgs& p) {
  constexpr int PD = pitch(KD), PV = pitch(KV), BM = C::BM, BN = C::BS, NT = C::THREADS, NB = BN / 8;
  constexpr int PS = pitch(BN / 16);  // the ds tile's pitch
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);  // [BM][PD]
  bf16* Vs = Ks + BM * PD;                       // [BM][PV]
  bf16* Qs = Vs + BM * PV;                       // [STAGES][BN][PD]
  bf16* Os = Qs + STAGES * BN * PD;              // [STAGES][BN][PV]   dO
  float* Ls = reinterpret_cast<float*>(Os + STAGES * BN * PV);  // [STAGES][BN]   lse
  float* Ds = Ls + STAGES * BN;                                  // [STAGES][BN]   Delta
  bf16* Ss = reinterpret_cast<bf16*>(Ds + STAGES * BN);          // [BM][PS]   round(ds^T), FUSED only

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (N + BN - 1) / BN;
  const long long bh = (long long)b * p.H + h;
  const bf16* qg = p.q.ptr + b * p.q.sb + h * p.q.sh;
  const bf16* og = p.dout.ptr + b * p.dout.sb + h * p.dout.sh;
  const float* lse = p.lse + bh * N;
  const float* delta = p.delta + bh * N;

  auto issue = [&](int s) {  // one commit group per query tile, empty past the last
    if (s < T) {
      const int buf = s % STAGES, n0 = s * BN;
      load_tile<NT, BN, 2 * KD>(Qs + buf * BN * PD, PD, qg, p.q.sn, n0, N, p.D, p.q.vec);
      load_tile<NT, BN, 2 * KV>(Os + buf * BN * PV, PV, og, p.dout.sn, n0, N, p.DV, p.dout.vec);
      for (int i = threadIdx.x; i < BN; i += NT) {
        if (n0 + i < N) {
          cp_async4(Ls + buf * BN + i, lse + n0 + i);
          cp_async4(Ds + buf * BN + i, delta + n0 + i);
        } else {
          Ls[buf * BN + i] = 0.f;
          Ds[buf * BN + i] = 0.f;
        }
      }
    }
    cp_async_commit();
  };
  load_tile<NT, BM, 2 * KD>(Ks, PD, p.k.ptr + b * p.k.sb + h * p.k.sh, p.k.sn, k0, M, p.D, p.k.vec);
  load_tile<NT, BM, 2 * KV>(Vs, PV, p.v.ptr + b * p.v.sb + h * p.v.sh, p.v.sn, k0, M, p.DV, p.v.vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  uint32_t ka[KD][4], va[KV][4];
  float dk[2 * KD][4] = {}, dv[2 * KV][4] = {};
  for (int s = 0; s < T; ++s) {
    cp_async_wait<STAGES - 2>();  // query tile s has landed
    __syncthreads();              // ... for every thread, and tile s - 1's buffers (and ds tile) are free
    issue(s + STAGES - 1);
    if (s == 0) {
      load_a<KD>(ka, Ks, PD, w0);
      load_a<KV>(va, Vs, PV, w0);
    }
    const int buf = s % STAGES, n0 = s * BN;
    const bf16* Qb = Qs + buf * BN * PD;
    const bf16* Ob = Os + buf * BN * PV;
    const float* Lb = Ls + buf * BN;
    const float* Db = Ds + buf * BN;
    float st[NB][4] = {}, dpt[NB][4] = {};
    mma_nk<KD, NB>(st, ka, Qb, PD);
    mma_nk<KV, NB>(dpt, va, Ob, PV);
    uint32_t pa[NB / 2][4], dsa[NB / 2][4];
    const int live = N - n0 - 2 * t;  // query rows past N (ragged last tile only) get P = 0
    auto grads = [&](auto masked) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = nb * 8 + 2 * t + i;  // this lane's query row of elements j = i, i + 2
          const float ls = Lb[c] * LOG2E, dl = Db[c];
#pragma unroll
          for (int j = i; j < 4; j += 2) {
            float pr = ex2(fmaf(st[nb][j], LOG2E, -ls));  // exp(s - lse)
            if (decltype(masked)::value && nb * 8 + i >= live) pr = 0.f;
            st[nb][j] = pr;                       // P^T
            dpt[nb][j] = pr * (dpt[nb][j] - dl);  // ds^T
          }
        }
      acc_to_a<NB / 2>(pa, st);
      acc_to_a<NB / 2>(dsa, dpt);
    };
    if (n0 + BN <= N) grads(std::false_type{}); else grads(std::true_type{});
    mma_kn<NB / 2, 2 * KV>(dv, pa, Ob, PV);
    mma_kn<NB / 2, 2 * KD>(dk, dsa, Qb, PD);
    if constexpr (FUSED) {
      // round(ds^T) of this warp's 16 keys into the ds tile (dsa's bits, so dq
      // and dk use the same rounded ds); keys past M as zeros, since their
      // zero-staged K rows give them logits of 0 and P = exp(-lse)
      const int g = lane >> 2;
      const bool lo = k0 + w0 + g < M, hi = k0 + w0 + g + 8 < M;
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        uint32_t* r0 = reinterpret_cast<uint32_t*>(Ss + (w0 + g) * PS + 16 * kk + 2 * t);
        uint32_t* r8 = reinterpret_cast<uint32_t*>(Ss + (w0 + g + 8) * PS + 16 * kk + 2 * t);
        r0[0] = lo ? dsa[kk][0] : 0u;
        r8[0] = hi ? dsa[kk][1] : 0u;
        r0[4] = lo ? dsa[kk][2] : 0u;  // 8 columns on
        r8[4] = hi ? dsa[kk][3] : 0u;
      }
      __syncthreads();
      // dq partial = ds K (BN x 16 KD over the block's BM keys): R blocks of 16
      // query rows times CG groups of NQ 8-column blocks, one warp each
      constexpr int R = BN / 16, CG0 = C::NW / R, CG = CG0 < KD ? CG0 : KD, NQ = 2 * KD / CG, KS = BM / 16;
      static_assert(R <= C::NW, "a warp for each 16 query rows");
      if (warp < R * CG) {
        const int rb = warp % R, cg = warp / R;
        // A fragments of ds (rows: queries) from the [key][query] tile, transposed by ldmatrix
        uint32_t da[KS][4];
        const bf16* pa_s = Ss + ((lane & 7) + (lane >> 4) * 8) * PS + rb * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4_trans(da[kk], pa_s + kk * 16 * PS);
        float part[NQ][4] = {};
        mma_kn<KS, NQ>(part, da, Ks + cg * NQ * 8, PD);
        red_add_rows<NQ>(p.dq_acc + bh * N * p.D, n0 + rb * 16, cg * NQ * 8, N, p.D, part);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const float one[2] = {1.f, 1.f};
  acc_to_smem<2 * KD>(Ks, PD, w0, dk, one);
  acc_to_smem<2 * KV>(Vs, PV, w0, dv, one);
  __syncthreads();
  store_tile<NT, BM, 2 * KD>(Ks, PD, p.dk + bh * M * p.D, k0, M, p.D, p.vec_dk);
  store_tile<NT, BM, 2 * KV>(Vs, PV, p.dv + bh * M * p.DV, k0, M, p.DV, p.vec_dv);
}

template <int KD, int KV, class C>
__global__ void __launch_bounds__(C::THREADS) attention_bwd_dkv_tc_kernel(const BwdArgs p) {
  bwd_dkv_body<KD, KV, C, false>(p);
}

template <int KD, int KV, class C>
__global__ void __launch_bounds__(C::THREADS) attention_bwd_fused_tc_kernel(const BwdArgs p) {
  bwd_dkv_body<KD, KV, C, true>(p);
}

template <class C>
inline size_t fwd_smem(int kd, int kv) {
  return 2 * (C::BM * pitch(kd) + STAGES * C::BS * (pitch(kd) + pitch(kv)));
}
template <class C>
inline size_t dq_smem(int kd, int kv) {
  return 2 * (C::BM + STAGES * C::BS) * (pitch(kd) + pitch(kv));
}
template <class C>
inline size_t dkv_smem(int kd, int kv) {
  return 2 * (C::BM + STAGES * C::BS) * (pitch(kd) + pitch(kv)) + 2 * 4 * STAGES * C::BS;
}
template <class C>
inline size_t fused_smem(int kd, int kv) {
  return dkv_smem<C>(kd, kv) + 2 * C::BM * pitch(C::BS / 16);  // and the ds tile
}

// 16-deep steps that cover d, rounded up to a power of two
inline int steps16(int d) {
  const int k = (d + 15) / 16;
  return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8;
}

template <int K>
using steps = std::integral_constant<int, K>;

// f(steps<KD>, steps<KV>) for head dims d, dv
template <typename F>
inline int with_steps(int d, int dv, F&& f) {
  auto with_kv = [&](auto kd) -> int {
    switch (steps16(dv)) {
      case 1: return f(kd, steps<1>{});
      case 2: return f(kd, steps<2>{});
      case 4: return f(kd, steps<4>{});
      default: return f(kd, steps<8>{});
    }
  };
  switch (steps16(d)) {
    case 1: return with_kv(steps<1>{});
    case 2: return with_kv(steps<2>{});
    case 4: return with_kv(steps<4>{});
    default: return with_kv(steps<8>{});
  }
}

template <class C, typename Kernel, typename Args>
inline int launch_one(Kernel kernel, int rows, int H, int B, size_t smem, cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((rows + C::BM - 1) / C::BM, H, B), C::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline bool dims_ok(int N, int M, int D, int DV) {
  return N >= 1 && M >= 1 && D >= 1 && D <= MAX_DIM && DV >= 1 && DV <= MAX_DIM;
}

// The tilings launched. The forward gives the widest head dims (d + dv > 128)
// 8 warps; the dkv kernel streams 32 query rows a step (64 held more
// registers and ran slower at d = 64).
template <int KD, int KV>
using FwdTiles = Tiles<(KD + KV > 8 ? 8 : 4), 64>;
using DqTiles = Tiles<4, 64>;
using DkvTiles = Tiles<4, 32>;
// K8: 64 keys (4 warps) against query tiles of 32. 128 keys (8 warps) halve
// the dq reductions but ran a third slower at dec1 (PERF.md; timed with
// cenet_tpu_torch/tools/time_tilings.py)
using FusedTiles = Tiles<4, 32>;

// The launchers are templates (of no parameter that matters) so that a source
// compiles only the kernel instances it launches, not every (KD, KV) instance
// of every kernel in the headers it includes.

// The forward on `stream`; returns the launch's cudaError_t (0 on success).
template <int = 0>
inline int fwd_launch(const FwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  return with_steps(a.D, a.DV, [&](auto kd, auto kv) {
    constexpr int KD = decltype(kd)::value, KV = decltype(kv)::value;
    using C = FwdTiles<KD, KV>;
    return launch_one<C>(attention_fwd_tc_kernel<KD, KV, C>, a.N, a.H, B, fwd_smem<C>(KD, KV), stream, a);
  });
}

// The dq kernel, then the dkv kernel, on `stream`; returns the first failing
// launch's cudaError_t (0 on success).
template <int = 0>
inline int bwd_launch(const BwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  return with_steps(a.D, a.DV, [&](auto kd, auto kv) {
    constexpr int KD = decltype(kd)::value, KV = decltype(kv)::value;
    const int rc = launch_one<DqTiles>(attention_bwd_dq_tc_kernel<KD, KV, DqTiles>, a.N, a.H, B,
                                       dq_smem<DqTiles>(KD, KV), stream, a);
    if (rc != 0) return rc;
    return launch_one<DkvTiles>(attention_bwd_dkv_tc_kernel<KD, KV, DkvTiles>, a.M, a.H, B,
                                dkv_smem<DkvTiles>(KD, KV), stream, a);
  });
}

// K8's one kernel on `stream` (a.dq_acc zeroed by the caller; a.dq unused),
// with tiling C; returns the launch's cudaError_t (0 on success).
template <class C = FusedTiles>
inline int bwd_fused_launch(const BwdArgs& a, int B, cudaStream_t stream) {
  if (!dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  return with_steps(a.D, a.DV, [&](auto kd, auto kv) {
    constexpr int KD = decltype(kd)::value, KV = decltype(kv)::value;
    return launch_one<C>(attention_bwd_fused_tc_kernel<KD, KV, C>, a.M, a.H, B, fused_smem<C>(KD, KV), stream, a);
  });
}

}  // namespace tc
}  // namespace cenet
