// Attention forward and backward at head dims past 128 (d, dv <= 512),
// hand-written for Hopper (sm_90a): the wide designs of K2 (attention_fwd.cu)
// and K4 (attention_bwd.cu), which replace _pallas_attention_fwd_impl and
// _pallas_attention_bwd_impl of cenet_tpu/ops/pallas_attention.py where the
// Pallas kernels pad d to a multiple of 128 (pallas_attention.py:94-95,
// 265-266). The sites: the Nonlocal blocks of a ResNet-50/101/152 CENet, dec1
// at 56^2 tokens with d = dv = 256 and dec2 at 28^2 with d = dv = 512. The
// functions, and their numerics, are those of the narrow designs:
//   o = softmax(q k^T) v, q pre-scaled, whole-row fp32 max and sum, o =
//     (round(e) v) / l with e = exp(s - m), lse = m + log l;
//   P = exp(q k^T - lse), ds = P (dO v^T - Delta), Delta = rowsum(dO o) given,
//   dq = round(ds) k, dk = round(ds)^T q, dv = round(P)^T dO,
// "round" being the cast to the operands' dtype (none in fp32), every product
// summed in fp32 and cast once at the end.
//
// Two designs, by dtype, as for the narrow kernels:
//
// bf16: wgmma (namespace tc). Bound by operations on an H100 SXM (989 TFLOP/s
// bf16 against 3.35 TB/s) at every site; wgmma is the instruction that reaches
// the tensor cores' full rate, and these are the widest products of the port.
// Every product is wgmma m64nNk16 with bf16 operands and fp32 sums, each
// logit formed once a pass for all output columns of its rows:
//   fwd  pass 1 streams K (logits, row max), pass 2 streams K again and V
//        (logits, e = exp(s - m), l, o += round(e) V): the two passes of the
//        Pallas body's rounding point (whole-row max);
//   dq   own q and dO rows; streams K and V: S = q K^T, dP = dO V^T, ds = P (dP
//        - Delta), dq += round(ds) K;
//   dkv  own k and v rows; streams q and dO (with lse and Delta): S^T = k q^T,
//        dP^T = v dO^T, dv += round(P^T) dO, dk += round(ds^T) q;
// S and dP once per (own tile, streamed tile) in each backward kernel.
//
// The forward at d, dv <= 256 with q, k, v on TMA (the dec1 site):
// attention_fwd_rows_kernel, 128 query rows a block, each warpgroup owning 64
// of them whole (logits, max, sum, e as registers into P V, o), a producer
// warpgroup issuing the loads (its comment below).
//
// Everything else (dv past 256: o does not fit one warpgroup; the backward;
// operands TMA cannot take): attention_wide_wgmma_kernel, one template in the
// three roles. A block of two warpgroups (256 threads) owns 64 rows of one
// (batch, head) and streams the other side in tiles of 128 rows. The
// warpgroups split both halves of the work: warpgroup w forms the logits of
// streamed rows 64 w .. 64 w + 63 of a tile (64 x 64, m64n64k16, A = the own
// rows and B = the streamed rows in shared memory), rounds what its output
// product takes (e; ds; P^T and ds^T) into shared 64 x 128 tiles, and after
// one barrier multiplies those tiles, the whole 128 streamed rows, into its
// own output columns: fwd and dq half of dv (d) each, up to 256 columns
// (m64n256k16, 128 fp32 registers a thread), so o at dv = 512 fits; dkv dk in
// warpgroup 0 and dv in warpgroup 1, 256 columns each. The row max and l of
// the forward are combined across the two warpgroups through shared memory
// (max, then l0 + l1 in a fixed order, so repeat runs are bit-identical). dk or
// dv wider than 256 (d or dv past 256: ResNet-50's dec2, routed for training
// only from a batch of 14) are cut into column slices of 256 on the grid's y,
// and each slice's blocks form the logits again: at d = dv = 512 the dk/dv
// kernel makes 2 x 2 N M (d + dv) of logits beside its 2 N M (d + dv) of
// products. Nothing sums across blocks in either design: each output element
// is written by one block, so repeat runs are bit-identical and no atomics are
// needed.
//
// Loads of the split design. A ring of up to 4 stages of 32 KB in shared
// memory (fewer where the own rows are wide; at least 2) holds, per step, a
// chunk of 128 columns of a streamed tile for the logits, or R rows of every
// output column of a stage's operand (R = 128, 64 or 32 for 128, 256, 512
// columns). Tiles are 64 columns wide in the 128-byte swizzle that wgmma's
// descriptors read (wgmma_ptx.cuh): the same tile is K-major B of the logits
// and MN-major B (transposed) of the output products. An operand whose base
// and strides are 16-byte aligned is loaded by TMA (a 4-d tensor map per
// operand and box; thread 0 issues, the stage's mbarrier counts the bytes,
// zeros outside the operand); others (the token views of a Nonlocal with C =
// 130 or 20) by cp.async of 16, 8 or 4 bytes with zero fill, or element loads,
// swizzled by hand. Each step: wait for the stage, issue its wgmma batch, wait
// until at most `lag` batches are in flight (2 with 3 or more stages, else 1),
// one block barrier, and the load of the step ST - lag ahead into the stage
// that step s - lag used.
//
// Edges: any N, M >= 1; 1 <= d, dv <= 512, not multiples of 16 needed. Rows
// past N or M and columns past d or dv are staged as zeros; masked keys get no
// share of the max and e = P = 0; rows and columns past the end are not
// stored. Outputs are contiguous.
//
// fp32: CUDA cores in fp32 FMA (namespace wide), the 16 x 16 thread grid and
// transposed tiles of attention_{fwd,bwd}_common.cuh, both sides staged 128
// columns at a time; each block writes one 128-column slice of one output and
// forms the logits again for it. fp32 is the parity dtype, not the speed path.

#pragma once

#include <algorithm>

#include "attention_bwd_common.cuh"
#include "attention_tc.cuh"
#include "wgmma_ptx.cuh"

namespace cenet {
namespace wide {

constexpr int MAX_DIM = 512;  // largest d and dv
constexpr int CW = 128;       // columns of a chunk of d or dv, and of an output slice

__host__ __device__ constexpr int chunks(int d) { return (d + CW - 1) / CW; }

inline bool dims_ok(int N, int M, int D, int DV) {
  return N >= 1 && M >= 1 && D >= 1 && D <= MAX_DIM && DV >= 1 && DV <= MAX_DIM;
}

// ---------------------------------------------------------------------------
// fp32, CUDA cores
// ---------------------------------------------------------------------------

// s[i][j] += sum_{e < E} A[e*LD + ty*4 + i] * B[e*LD + tx + 16 j]
__device__ __forceinline__ void tile_dot_add(const float* A, const float* B, int E, int ty, int tx,
                                             float (&s)[4][4]) {
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

// s[i][j] = sum_{e < D} a[arow0 + ty*4 + i][e] * b[brow0 + tx + 16 j][e], both
// sides staged transposed through At and Bt (CW x LD each) a chunk at a time,
// in order of e. Starts with a barrier, so the caller's earlier readers of any
// shared buffer are done when it returns.
__device__ __forceinline__ void chunked_dot(float* At, float* Bt, const float* a, long long sa, int arow0,
                                            int arows, const float* b, long long sb, int brow0, int brows, int D,
                                            int tid, int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int c0 = 0; c0 < D; c0 += CW) {
    const int E = min(CW, D - c0);
    __syncthreads();
    stage_t(At, a + c0, sa, arow0, arows, E, tid);
    stage_t(Bt, b + c0, sb, brow0, brows, E, tid);
    __syncthreads();
    tile_dot_add(At, Bt, E, ty, tx, s);
  }
}

// One block: 64 query rows of one (batch, head), value columns v0 .. v0 + 127.
template <int = 0>
__global__ void __launch_bounds__(THREADS) attention_fwd_wide_kernel(Params p) {
  extern __shared__ float smem[];
  float* At = smem;          // [CW][LD]  q chunk, transposed
  float* Bt = At + CW * LD;  // [CW][LD]  k chunk, transposed
  float* Vs = Bt + CW * LD;  // [BK][CW]  v slice
  float* Wt = Vs + BK * CW;  // [BK][LD]  e, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DV = p.DV, N = p.N, M = p.M, ns = chunks(DV);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y / ns, v0 = (blockIdx.y % ns) * CW, b = blockIdx.z;
  const int E = min(CW, DV - v0);
  const float* q = static_cast<const float*>(p.q[0]) + b * p.sq[0].b + (long long)head * p.sq[0].h;
  const float* k = static_cast<const float*>(p.k[0]) + b * p.sk[0].b + (long long)head * p.sk[0].h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + (long long)head * p.sv.h + v0;

  // ---- pass 1: row max and sum of exponentials
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = -INFINITY, l_run[i] = 0.f;
  for (int k0 = 0; k0 < M; k0 += BK) {
    float s[4][4];
    chunked_dot(At, Bt, q, p.sq[0].n, q0, N, k, p.sk[0].n, k0, M, D, tid, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < M) tmax = fmaxf(tmax, s[i][j]);
      tmax = half_warp_max(tmax);
      const float m_new = fmaxf(m_run[i], tmax);  // finite: every tile has a key
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < M) tsum += __expf(s[i][j] - m_new);
      tsum = half_warp_sum(tsum);
      l_run[i] = l_run[i] * __expf(m_run[i] - m_new) + tsum;
      m_run[i] = m_new;
    }
  }

  // ---- pass 2: o = e V over this block's value columns, divided by l at the end
  float acc[4][8];
  zero(acc);
  for (int k0 = 0; k0 < M; k0 += BK) {
    float s[4][4];
    chunked_dot(At, Bt, q, p.sq[0].n, q0, N, k, p.sk[0].n, k0, M, D, tid, ty, tx, s);
    for (int idx = tid; idx < BK * E; idx += THREADS) {
      const int e = idx % E, c = idx / E;
      const int m = k0 + c;
      Vs[c * CW + e] = m < M ? v[m * p.sv.n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Wt[(tx + 16 * j) * LD + ty * 4 + i] = k0 + tx + 16 * j < M ? __expf(s[i][j] - m_run[i]) : 0.f;
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
      if (col < E) o[row * DV + v0 + col] = acc[i][j] / l_run[i];
    }
    if (tx == 0 && v0 == 0) p.lse1[row] = m_run[i] + logf(l_run[i]);
  }
}

// One block: 64 query rows of one (batch, head), dq columns c0 .. c0 + 127.
template <int = 0>
__global__ void __launch_bounds__(THREADS) attention_bwd_dq_wide_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* At = smem;          // [CW][LD]  q or dO chunk, transposed
  float* Bt = At + CW * LD;  // [CW][LD]  k or v chunk, transposed
  float* Xt = Bt + CW * LD;  // [CW][LD]  k slice, transposed
  float* Sh = Xt + CW * LD;  // [BK][LD]  ds[c][r]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DV = p.DV, N = p.N, M = p.M, ns = chunks(D);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y / ns, c0 = (blockIdx.y % ns) * CW, b = blockIdx.z;
  const int E = min(CW, D - c0);
  const float* q = static_cast<const float*>(p.q[0]) + b * p.sq[0].b + (long long)head * p.sq[0].h;
  const float* k = static_cast<const float*>(p.k[0]) + b * p.sk[0].b + (long long)head * p.sk[0].h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + (long long)head * p.sv.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.so.b + (long long)head * p.so.h;

  const long long row0 = ((long long)b * p.Hv + head) * N;
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    lse[i] = n < N ? p.lse1[row0 + n] : 0.f;
    dl[i] = n < N ? p.delta1[row0 + n] : 0.f;
  }

  float acc[4][8];
  zero(acc);
  for (int k0 = 0; k0 < M; k0 += BK) {
    float s[4][4], gg[4][4];
    chunked_dot(At, Bt, q, p.sq[0].n, q0, N, k, p.sk[0].n, k0, M, D, tid, ty, tx, s);
    chunked_dot(At, Bt, dout, p.so.n, q0, N, v, p.sv.n, k0, M, DV, tid, ty, tx, gg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = k0 + tx + 16 * j < M && q0 + ty * 4 + i < N;
        Sh[(tx + 16 * j) * LD + ty * 4 + i] = live ? __expf(s[i][j] - lse[i]) * (gg[i][j] - dl[i]) : 0.f;
      }
    stage_t(Xt, k + c0, p.sk[0].n, k0, M, E, tid);
    __syncthreads();
    tile_acc<8>(Sh, Xt, min(BK, M - k0), E, ty, tx, acc);
  }
  float* dq = static_cast<float*>(p.dq[0]) + b * p.sdq[0].b + (long long)head * p.sdq[0].h + c0;
  store_rows<float, 8>(dq, p.sdq[0].n, q0, N, E, ty, tx, 1.f, acc);
}

// One block: 64 keys of one (batch, head) and one slice, dk columns c0 .. c0 +
// 127 (slices 0 .. chunks(D) - 1) or dv columns (the slices after them).
template <int = 0>
__global__ void __launch_bounds__(THREADS) attention_bwd_dkv_wide_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* At = smem;          // [CW][LD]  k or v chunk, transposed
  float* Bt = At + CW * LD;  // [CW][LD]  q or dO chunk, transposed
  float* Xt = Bt + CW * LD;  // [CW][LD]  q or dO slice, transposed
  float* Sh = Xt + CW * LD;  // [BQ][LD]  ds^T or P^T, [query][key]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DV = p.DV, N = p.N, M = p.M, nd = chunks(D), ns = nd + chunks(DV);
  const int m0 = blockIdx.x * BK, head = blockIdx.y / ns, sl = blockIdx.y % ns, b = blockIdx.z;
  const bool is_dk = sl < nd;
  const int c0 = (is_dk ? sl : sl - nd) * CW, E = min(CW, (is_dk ? D : DV) - c0);
  const float* q = static_cast<const float*>(p.q[0]) + b * p.sq[0].b + (long long)head * p.sq[0].h;
  const float* k = static_cast<const float*>(p.k[0]) + b * p.sk[0].b + (long long)head * p.sk[0].h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + (long long)head * p.sv.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.so.b + (long long)head * p.so.h;
  const long long row0 = ((long long)b * p.Hv + head) * N;

  float acc[4][8];
  zero(acc);
  for (int q0 = 0; q0 < N; q0 += BQ) {
    // this thread: keys ty*4 + i against query rows tx + 16 j of the tile
    float s[4][4], gg[4][4];
    chunked_dot(At, Bt, k, p.sk[0].n, m0, M, q, p.sq[0].n, q0, N, D, tid, ty, tx, s);
    if (is_dk) chunked_dot(At, Bt, v, p.sv.n, m0, M, dout, p.so.n, q0, N, DV, tid, ty, tx, gg);
    const int rn = min(BQ, N - q0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const float ls = r < rn ? p.lse1[row0 + q0 + r] : 0.f;
      const float dl = r < rn && is_dk ? p.delta1[row0 + q0 + r] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = r < rn ? __expf(s[i][j] - ls) : 0.f;
        Sh[r * LD + ty * 4 + i] = is_dk ? pr * (gg[i][j] - dl) : pr;
      }
    }
    stage_t(Xt, (is_dk ? q : dout) + c0, is_dk ? p.sq[0].n : p.so.n, q0, N, E, tid);
    __syncthreads();
    tile_acc<8>(Sh, Xt, rn, E, ty, tx, acc);
  }
  if (is_dk) {
    float* dk = static_cast<float*>(p.dk[0]) + b * p.sdk[0].b + (long long)head * p.sdk[0].h + c0;
    store_rows<float, 8>(dk, p.sdk[0].n, m0, M, E, ty, tx, 1.f, acc);
  } else {
    float* dv = static_cast<float*>(p.dv) + ((long long)b * p.Hv + head) * M * DV + c0;
    store_rows<float, 8>(dv, DV, m0, M, E, ty, tx, 1.f, acc);
  }
}

template <typename Kernel, typename Args>
inline int launch_wide(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The fp32 forward on `stream`; returns the launch's cudaError_t (0 on success).
// The launchers are templates so that a source compiles only what it launches.
template <int = 0>
inline int fwd_launch(const Params& p, cudaStream_t stream) {
  if (!dims_ok(p.N, p.M, p.D, p.DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t(2 * CW * LD) + size_t(BK * CW) + size_t(BK * LD));
  return launch_wide(attention_fwd_wide_kernel<>, dim3((p.N + BQ - 1) / BQ, p.Hv * chunks(p.DV), p.B), smem, stream,
                     p);
}

// The fp32 dq kernel, then the dk/dv kernel, on `stream`.
template <int = 0>
inline int bwd_launch(const BwdParams& p, cudaStream_t stream) {
  if (!dims_ok(p.N, p.M, p.D, p.DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t(3 * CW * LD) + size_t(BQ * LD));
  const int rc = launch_wide(attention_bwd_dq_wide_kernel<>, dim3((p.N + BQ - 1) / BQ, p.Hv * chunks(p.D), p.B), smem,
                             stream, p);
  if (rc != 0) return rc;
  return launch_wide(attention_bwd_dkv_wide_kernel<>,
                     dim3((p.M + BK - 1) / BK, p.Hv * (chunks(p.D) + chunks(p.DV)), p.B), smem, stream, p);
}

}  // namespace wide

// ---------------------------------------------------------------------------
// bf16, wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WROWS = 64;             // own rows of a block: one m64 tile, shared by both warpgroups
constexpr int WTILE = 128;            // streamed rows of a tile: 64 to each warpgroup's logits (m64n64k16;
                                      // 256 rows, m64n128k16, timed slower in the forward)
constexpr int WTHREADS = 256;         // two warpgroups
constexpr int STAGE_BYTES = 32768;    // one stage of the ring
constexpr int WMAX_STAGES = 4;
constexpr int WSMEM_LIMIT = 232448;   // shared memory a block may have on an H100

enum class Wide { Fwd, Dq, Dkv };

// An operand as the wgmma kernels load it: a (B, H, rows, cols) bf16 view
struct WideOp {
  const bf16* ptr;
  long long sb, sh, sn;
  int rows, cols;
  int route;  // 0: TMA; 16, 8, 4: cp.async of that many bytes; 2: element loads
};

struct WideArgs {
  WideOp x1, x2;  // the block's own rows, A of the logits: fwd q; dq q, dO; dkv k, v
  WideOp y1, y2;  // streamed rows, B of the logits: fwd k; dq k, v; dkv q, dO
  WideOp z1, z2;  // streamed rows, B of the outputs: fwd v; dq k; dkv q (dk), dO (dv)
  bf16* out1;     // fwd o, dq dq, dkv dk: contiguous
  bf16* out2;     // dkv dv
  float* lse;     // written by fwd, read by dq and dkv
  const float* delta;
  int H, n_own, n_str;
  int c1, c2;      // columns of x1 and y1, of x2 and y2 (c2 = 0 in fwd)
  int oc1, oc2;    // columns of out1, out2
  int stages, R;   // ring stages; streamed rows of an output step
  int slices;      // dkv: column slices of dk and dv on the grid's y
};

struct alignas(64) WideMaps {
  CUtensorMap x1, x2, y1, y2, z1, z2;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// One 16-byte chunk (8 columns, of which n are inside the operand) into a
// swizzled tile by cp.async or element loads; zeros past n
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const bf16* src, int n, int route) {
  const uint32_t a = smem_addr(dst);
  const int bytes = 2 * n;
  switch (route) {
    case 16: cp_async_zfill<16>(a, src, bytes); break;
    case 8:
#pragma unroll
      for (int k = 0; k < 2; ++k) cp_async_zfill<8>(a + 8 * k, bytes > 8 * k ? src + 4 * k : src, min(max(bytes - 8 * k, 0), 8));
      break;
    case 4:
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async_zfill<4>(a + 4 * k, bytes > 4 * k ? src + 2 * k : src, min(max(bytes - 4 * k, 0), 4));
      break;
    default:
#pragma unroll
      for (int e = 0; e < 8; ++e) reinterpret_cast<bf16*>(dst)[e] = e < n ? src[e] : __float2bfloat16(0.f);
  }
}

// `ntiles` tiles of `box_rows` rows x 64 columns, at (row0, col0 + 64 j) of
// (batch b, head h) of `op`, into consecutive swizzled tiles at `dst`; zeros
// outside the operand. TMA (thread 0 issues; `bar` counts the bytes, expected
// by the caller) or, on the other routes, every thread.
__device__ __forceinline__ void load_tiles(unsigned char* dst, const WideOp& op, const CUtensorMap* map, uint32_t bar,
                                           int b, int h, int row0, int col0, int ntiles, int box_rows) {
  if (op.route == 0) {
    if (threadIdx.x == 0)
      for (int j = 0; j < ntiles; ++j) tma_load_4d(smem_addr(dst + j * box_rows * 128), map, bar, col0 + 64 * j, row0, h, b);
    return;
  }
  const bf16* g = op.ptr + b * op.sb + h * op.sh;
  for (int i = threadIdx.x; i < ntiles * box_rows * 8; i += WTHREADS) {
    const int ch = i & 7, r = (i >> 3) % box_rows, j = (i >> 3) / box_rows;
    const int row = row0 + r, c = col0 + 64 * j + 8 * ch;
    const int n = row < op.rows ? min(max(op.cols - c, 0), 8) : 0;
    copy_chunk(dst + (j * box_rows + r) * 128 + ((ch ^ (r & 7)) << 4), n > 0 ? g + row * op.sn + c : op.ptr, n,
               op.route);
  }
}

constexpr int WTPS = STAGE_BYTES / (WTILE * 128);  // 64-column tiles of a streamed tile in one stage (2)

// L (64 x 64: this warpgroup's half of the streamed rows) = the block's own
// rows X (tiles of 64 x 64) times the stage's streamed rows, over chunk `idx`
// of the columns (`nt` tiles of the stage); the first chunk overwrites L
__device__ __forceinline__ void wide_logits(float (&L)[32], const unsigned char* X, const unsigned char* stage, int idx,
                                            int nt, int wg) {
  wgmma_fence();
  for (int j = 0; j < nt; ++j) {
    const uint32_t a = smem_addr(X + (WTPS * idx + j) * 8192), bb = smem_addr(stage + (j * WTILE + wg * 64) * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<64, 0>(L, desc_k(a + 32 * kk), desc_k(bb + 32 * kk), idx + j + kk > 0);
  }
  wgmma_commit();
}

// rows r, r + 8 (hh) of a thread's accumulator: H columns of `acc` (divided by
// div[hh]) into columns col0 + ... of a contiguous (rows, cols) bf16 matrix;
// rows and columns past the end are not stored
template <int H>
__device__ __forceinline__ void store_acc(const float (&acc)[H / 2], bf16* out, int rows, int cols, int row0,
                                          int col0, const float (&div)[2]) {
  const int lane = threadIdx.x & 31, r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), t = lane & 3;
  const bool pairs = cols % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + r + 8 * hh;
    if (row >= rows) continue;
    bf16* o = out + (long long)row * cols;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      const float v0 = acc[4 * j + 2 * hh] / div[hh], v1 = acc[4 * j + 2 * hh + 1] / div[hh];
      if (pairs && col + 1 < cols) {
        *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(v0, v1);
      } else {
        if (col < cols) o[col] = __float2bfloat16(v0);
        if (col + 1 < cols) o[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// a pair of fp32 values (columns 2t, 2t + 1 of 8-column block j, row r) rounded
// into a swizzled [64][64] tile
__device__ __forceinline__ void put_pair(unsigned char* tile, int r, int j, int t, float a, float b) {
  *reinterpret_cast<uint32_t*>(tile + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) = pack_bf16(a, b);
}

// One kernel, three roles (KIND). A block owns 64 rows of one (batch, head) and
// streams the other side in tiles of 128 rows; its two warpgroups split each
// tile's logits (warpgroup w: streamed rows 64 w .. 64 w + 63) and the outputs'
// columns (H each). Steps of the ring, per tile: the logits against x1 in
// chunks of 128 columns, those against x2 (dq, dkv), then the output products
// in steps of R streamed rows; the forward first runs pass 1 (the logits
// against x1 only) over every tile.
template <Wide KIND, int H>
__global__ void __launch_bounds__(WTHREADS, 1)
    attention_wide_wgmma_kernel(const WideArgs p, const __grid_constant__ WideMaps maps) {
  constexpr bool FWD = KIND == Wide::Fwd, DKV = KIND == Wide::Dkv, TWO = !FWD;
  constexpr int TILE = WTILE, HALF = TILE / 2, TB = 128 * TILE;  // streamed rows, a warpgroup's; bytes of a rounded tile
  constexpr int TPS = WTPS, CW = 64 * TPS;  // 64-column tiles and columns of a logit step
  extern __shared__ __align__(16) unsigned char wide_raw[];
  unsigned char* sm = wide_raw + (1024 - smem_addr(wide_raw) % 1024) % 1024;
  const int C1P = round_up(p.c1, 64), C2P = TWO ? round_up(p.c2, 64) : 0;
  unsigned char* X1 = sm;                          // [C1P / 64][64][64]
  unsigned char* X2 = X1 + C1P * 128;              // [C2P / 64][64][64]
  unsigned char* T1 = X2 + C2P * 128;              // [TILE / 64][64][64]: round(e) fwd, round(ds) dq, round(ds^T) dkv
  unsigned char* T2 = T1 + TB;                     // dkv: round(P^T)
  unsigned char* ring = T2 + (DKV ? TB : 0);       // [stages][STAGE_BYTES]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + p.stages * STAGE_BYTES);  // [WMAX_STAGES] full, own
  float* red = reinterpret_cast<float*>(bars + WMAX_STAGES + 1);  // fwd: [2][64] row max, [2][64] row sum

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((tid >> 5) & 3) + g;  // this thread's own rows: r0 and r0 + 8 of the block
  const int b = blockIdx.z, h = DKV ? blockIdx.y / p.slices : blockIdx.y, sl = DKV ? blockIdx.y % p.slices : 0;
  const int own0 = blockIdx.x * WROWS;
  const long long bh = (long long)b * p.H + h;
  const int ST = p.stages, T = (p.n_str + TILE - 1) / TILE, nc1 = (C1P + CW - 1) / CW, nc2 = (C2P + CW - 1) / CW;
  const int no = TILE / p.R, S = (FWD ? T * nc1 : 0) + T * (nc1 + nc2 + no);
  // wgmma batches left in flight at a step's end: 2 where the ring has 3 or
  // more stages (a step's bookkeeping then overlaps two batches), else 1
  const int lag = ST >= 3 ? 2 : 1;
  const uint32_t own_bar = smem_addr(bars + WMAX_STAGES);

  // a step: tile, kind (0: logits against x1, 1: against x2, 2: output rows),
  // index within the kind, and whether it is the forward's pass 1
  struct Step {
    int tile, kind, idx;
    bool pass1;
  };
  auto advance = [&](Step& st) {
    if (st.pass1) {
      if (++st.idx == nc1) st.idx = 0, st.pass1 = ++st.tile < T, st.tile = st.pass1 ? st.tile : 0;
      return;
    }
    if (++st.idx < (st.kind == 0 ? nc1 : st.kind == 1 ? nc2 : no)) return;
    st.idx = 0;
    st.kind = st.kind == 0 && !TWO ? 2 : st.kind + 1;
    if (st.kind == 3) st.kind = 0, ++st.tile;
  };
  const bool tma1 = p.y1.route == 0, tma2 = TWO && p.y2.route == 0;
  const bool tmaz = p.z1.route == 0 || (DKV && p.z2.route == 0), copyz = p.z1.route != 0 || (DKV && p.z2.route != 0);
  auto by_tma = [&](const Step& st) { return st.kind == 0 ? tma1 : st.kind == 1 ? tma2 : tmaz; };
  auto by_copies = [&](const Step& st) { return st.kind == 0 ? !tma1 : st.kind == 1 ? !tma2 : copyz; };
  // step s (`st`) into stage s % ST: one cp.async commit group per step (empty
  // for TMA steps and past the last)
  auto issue = [&](int s, const Step& st) {
    if (s < S) {
      unsigned char* dst = ring + (s % ST) * STAGE_BYTES;
      const uint32_t bar = smem_addr(bars + s % ST);
      if (st.kind < 2) {
        const WideOp& op = st.kind == 0 ? p.y1 : p.y2;
        const int nt = min(TPS, ((st.kind == 0 ? C1P : C2P) - CW * st.idx) / 64);
        if (op.route == 0 && tid == 0) mbar_expect_tx(bar, nt * TILE * 128);
        load_tiles(dst, op, st.kind == 0 ? &maps.y1 : &maps.y2, bar, b, h, st.tile * TILE, CW * st.idx, nt, TILE);
      } else {
        const int row0 = st.tile * TILE + st.idx * p.R;
        if constexpr (DKV) {
          const int nt = H / 64, tx = (p.z1.route == 0) + (p.z2.route == 0);
          if (tx > 0 && tid == 0) mbar_expect_tx(bar, tx * nt * p.R * 128);
          load_tiles(dst, p.z1, &maps.z1, bar, b, h, row0, sl * H, nt, p.R);
          load_tiles(dst + nt * p.R * 128, p.z2, &maps.z2, bar, b, h, row0, sl * H, nt, p.R);
        } else {
          if (p.z1.route == 0 && tid == 0) mbar_expect_tx(bar, 2 * H * p.R * 2);
          load_tiles(dst, p.z1, &maps.z1, bar, b, h, row0, 0, 2 * H / 64, p.R);
        }
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    for (int i = 0; i <= WMAX_STAGES; ++i) mbar_init(smem_addr(bars + i), 1);
    fence_mbar_init();
  }
  __syncthreads();
  const bool own_tma = p.x1.route == 0 || (TWO && p.x2.route == 0);
  const bool own_copies = p.x1.route != 0 || (TWO && p.x2.route != 0);
  {
    const int tx = (p.x1.route == 0 ? C1P / 64 : 0) + (TWO && p.x2.route == 0 ? C2P / 64 : 0);
    if (tx > 0 && tid == 0) mbar_expect_tx(own_bar, tx * WROWS * 128);
    load_tiles(X1, p.x1, &maps.x1, own_bar, b, h, own0, 0, C1P / 64, WROWS);
    if (TWO) load_tiles(X2, p.x2, &maps.x2, own_bar, b, h, own0, 0, C2P / 64, WROWS);
  }
  Step cur{0, 0, 0, FWD}, nxt = cur;  // the step consumed and the next step loaded
  for (int s = 0; s < ST - lag; ++s, advance(nxt)) issue(s, nxt);  // the own rows' copies join step 0's group

  float acc[H / 2], ls[32], ld[TWO ? 32 : 1];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
  // own rows r0, r0 + 8: fwd the row max (then m), m log2 e, this thread's share
  // of the row sum; dq lse log2 e and Delta
  float mx[2] = {-INFINITY, -INFINITY}, ms[2] = {0.f, 0.f}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if constexpr (KIND == Wide::Dq) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = own0 + r0 + 8 * hh;
      rs[hh] = n < p.n_own ? p.lse[bh * p.n_own + n] * LOG2E : 0.f;
      dl[hh] = n < p.n_own ? p.delta[bh * p.n_own + n] : 0.f;
    }
  }

  uint32_t phases = 0;  // parity of each stage's barrier (TMA steps only)
  for (int s = 0, slot = 0; s < S; ++s, slot = slot + 1 == ST ? 0 : slot + 1) {
    const Step st = cur;
    advance(cur);
    if (by_copies(st) || (s == 0 && own_copies)) {
      cp_async_wait_n(ST - lag - 1);  // this thread's copies of step s have landed
      fence_proxy_async();      // ... where wgmma reads them
      __syncthreads();          // ... for every thread
    }
    if (s == 0 && own_tma) mbar_wait(own_bar, 0);
    if (by_tma(st)) {
      mbar_wait(smem_addr(bars + slot), (phases >> slot) & 1);
      phases ^= 1u << slot;
    }
    const unsigned char* stage = ring + slot * STAGE_BYTES;
    if (st.kind < 2) {
      const int nt = min(TPS, ((st.kind == 0 ? C1P : C2P) - CW * st.idx) / 64);
      if (st.kind == 0) wide_logits(ls, X1, stage, st.idx, nt, wg);
      else if constexpr (TWO) wide_logits(ld, X2, stage, st.idx, nt, wg);
      const bool last = TWO ? st.kind == 1 && st.idx == nc2 - 1 : st.idx == nc1 - 1;
      if (!last) {
        wgmma_wait_n(lag);
      } else {
        wgmma_wait<0>();
        fence_regs(ls);
        if constexpr (TWO) fence_regs(ld);
        // element (j, hh, e) of L: own row r0 + 8 hh, streamed row 8 j + 2 t + e
        // of this warpgroup's HALF; streamed rows past the end have live <= 8 j + e
        const int live = p.n_str - (st.tile * TILE + HALF * wg) - 2 * t;
        // the rounded tiles' 64-column tile and 8-column chunk of block j
        auto tile_of = [&](unsigned char* T, int j) { return T + ((HALF * wg) / 64 + j / 8) * 8192; };
        if (FWD && st.pass1) {
          // pass 1: the row max over the streamed rows inside the operand
#pragma unroll
          for (int j = 0; j < TILE / 16; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (8 * j + (i & 1) < live) mx[i >> 1] = fmaxf(mx[i >> 1], ls[4 * j + i]);
          if (st.tile == T - 1) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              mx[hh] = quad_max(mx[hh]);
              if (t == 0) red[64 * wg + r0 + 8 * hh] = mx[hh];
            }
          }
        } else {
          __syncthreads();  // both warpgroups are done with T1 and T2 of the previous tile
          if constexpr (FWD) {
            if (st.tile == 0) {  // the row max of both warpgroups (written before the last few barriers)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                mx[hh] = fmaxf(red[r0 + 8 * hh], red[64 + r0 + 8 * hh]);
                ms[hh] = mx[hh] * LOG2E;
              }
            }
#pragma unroll
            for (int j = 0; j < TILE / 16; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float e[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  e[c] = 8 * j + c < live ? ex2(fmaf(ls[4 * j + 2 * hh + c], LOG2E, -ms[hh])) : 0.f;  // exp(s - m)
                  l[hh] += e[c];
                }
                put_pair(tile_of(T1, j), r0 + 8 * hh, j % 8, t, e[0], e[1]);
              }
          } else if constexpr (KIND == Wide::Dq) {
#pragma unroll
            for (int j = 0; j < TILE / 16; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float ds[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int i = 4 * j + 2 * hh + c;
                  const float pr = 8 * j + c < live ? ex2(fmaf(ls[i], LOG2E, -rs[hh])) : 0.f;  // exp(s - lse)
                  ds[c] = pr * (ld[i] - dl[hh]);
                }
                put_pair(tile_of(T1, j), r0 + 8 * hh, j % 8, t, ds[0], ds[1]);
              }
          } else {
            // dkv: own rows are keys, streamed rows queries, with their lse and Delta
            const float* lse = p.lse + bh * p.n_str + st.tile * TILE + HALF * wg + 2 * t;
            const float* delta = p.delta + bh * p.n_str + st.tile * TILE + HALF * wg + 2 * t;
#pragma unroll
            for (int j = 0; j < TILE / 16; ++j) {
              float ls2[2], dl2[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const bool in = 8 * j + c < live;
                ls2[c] = in ? lse[8 * j + c] * LOG2E : 0.f;
                dl2[c] = in ? delta[8 * j + c] : 0.f;
              }
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float pr[2], ds[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int i = 4 * j + 2 * hh + c;
                  pr[c] = 8 * j + c < live ? ex2(fmaf(ls[i], LOG2E, -ls2[c])) : 0.f;  // P^T = exp(s - lse)
                  ds[c] = pr[c] * (ld[i] - dl2[c]);
                }
                put_pair(tile_of(T1, j), r0 + 8 * hh, j % 8, t, ds[0], ds[1]);
                put_pair(tile_of(T2, j), r0 + 8 * hh, j % 8, t, pr[0], pr[1]);
              }
            }
          }
          fence_proxy_async();  // the rounded tiles are read by wgmma after the step's barrier
        }
      }
    } else {
      // outputs: acc (64 x H) += T (64 x R streamed rows) Z (R x H, this warpgroup's columns of the stage)
      const unsigned char* A = DKV && wg == 1 ? T2 : T1;
      const uint32_t zb = smem_addr(stage + (wg * H / 64) * p.R * 128);
      wgmma_fence();
      for (int kk = 0; kk < p.R / 16; ++kk) {
        const int k = st.idx * p.R + 16 * kk;
        wgmma_ss<H, 1>(acc, desc_k(smem_addr(A + (k / 64) * 8192) + (k % 64) * 2), desc_mn(zb + kk * 2048, p.R * 128));
      }
      wgmma_commit();
      wgmma_wait_n(lag);
    }
    __syncthreads();                // every warpgroup is done with step s - lag's stage
    issue(s + ST - lag, nxt);       // ... which takes step s + ST - lag
    advance(nxt);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  if constexpr (FWD) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = quad_sum(l[hh]);
      if (t == 0) red[128 + 64 * wg + r0 + 8 * hh] = l[hh];
    }
    __syncthreads();
    float lt[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) lt[hh] = red[128 + r0 + 8 * hh] + red[192 + r0 + 8 * hh];
    store_acc<H>(acc, p.out1 + bh * p.n_own * p.oc1, p.n_own, p.oc1, own0, wg * H, lt);
    if (wg == 0 && t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = own0 + r0 + 8 * hh;
        if (n < p.n_own) p.lse[bh * p.n_own + n] = mx[hh] + logf(lt[hh]);
      }
    }
  } else {
    const float one[2] = {1.f, 1.f};
    if (DKV && wg == 1) store_acc<H>(acc, p.out2 + bh * p.n_own * p.oc2, p.n_own, p.oc2, own0, sl * H, one);
    else store_acc<H>(acc, p.out1 + bh * p.n_own * p.oc1, p.n_own, p.oc1, own0, DKV ? sl * H : wg * H, one);
  }
}

// ---- the forward at d, dv <= 256 with every operand on TMA: rows owned by one warpgroup

constexpr int RROWS = 128;        // own rows of a block: 64 a warpgroup
constexpr int RKEYS = 64;         // keys of a streamed tile
constexpr int RTHREADS = 384;     // two consumer warpgroups and a producer warpgroup
constexpr int RMAX_STAGES = 6;

// A block of 128 query rows of one (batch, head); warpgroup w owns rows 64 w ..
// 64 w + 63 whole: its logits (m64n64k16 against a tile of 64 keys, q and K
// in shared memory), its row max and sum, round(e) as the A fragments of P V in
// registers (m64nNVk16, V in shared memory) and o (NV = dv rounded up to 64
// columns, NV / 2 fp32 registers a thread; setmaxnreg gives the consumers 240
// registers, the producer warpgroup 24). One thread of warp 8 issues every TMA
// load into a ring of stages (K_t for pass 1; K_t, V_t for pass 2), each
// released by the eight consumer warps through an mbarrier. The warpgroups
// run apart (making them take turns through named barriers was slower). Pass
// 1 issues the logits of two key tiles at a time; pass 2 issues the logits of
// tile t with the P V of tile t - 1 and forms e of tile t while that P V runs
// (issuing the logits of tile t + 1 ahead too needs a second logits buffer,
// which spilled at dv = 256). 128 rows a block read K and V from L2 half as
// often as 64 do.
template <int NV>
__global__ void __launch_bounds__(RTHREADS, 1)
    attention_fwd_rows_kernel(const WideArgs p, const __grid_constant__ WideMaps maps) {
  extern __shared__ __align__(16) unsigned char wide_raw[];
  unsigned char* sm = wide_raw + (1024 - smem_addr(wide_raw) % 1024) % 1024;
  const int C1P = round_up(p.c1, 64), ST = p.stages, T = (p.n_str + RKEYS - 1) / RKEYS;
  const int stage_bytes = 128 * RKEYS * (C1P > NV ? C1P : NV) / 64;
  unsigned char* Q = sm;                     // [C1P / 64][128][64]
  unsigned char* ring = Q + C1P * 256;       // [ST][stage_bytes]: K [C1P / 64][64][64] or V [NV / 64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * stage_bytes);
  uint64_t* empty = full + RMAX_STAGES;
  const uint32_t own = smem_addr(empty + RMAX_STAGES);
  const int tid = threadIdx.x, warp = tid >> 5, b = blockIdx.z, h = blockIdx.y, own0 = blockIdx.x * RROWS;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(smem_addr(full + i), 1), mbar_init(smem_addr(empty + i), 8);
    mbar_init(own, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: step s is K_s for s < T, then K_t (s = T + 2 t) and V_t (s = T + 2 t + 1)
    regs_dealloc<24>();
    if (tid == 256) {
      mbar_expect_tx(own, C1P * 256);
      for (int c = 0; c < C1P / 64; ++c) tma_load_4d(smem_addr(Q + c * 16384), &maps.x1, own, 64 * c, own0, h, b);
      for (int s = 0; s < 3 * T; ++s) {
        const int slot = s % ST;
        if (s >= ST) mbar_wait(smem_addr(empty + slot), (s / ST - 1) & 1);
        const bool v = s >= T && ((s - T) & 1);
        const int key0 = (s < T ? s : (s - T) >> 1) * RKEYS, nt = (v ? NV : C1P) / 64;
        const uint32_t bar = smem_addr(full + slot), dst = smem_addr(ring + slot * stage_bytes);
        mbar_expect_tx(bar, nt * 8192);
        for (int j = 0; j < nt; ++j) tma_load_4d(dst + j * 8192, v ? &maps.z1 : &maps.y1, bar, 64 * j, key0, h, b);
      }
    }
    return;
  }
  regs_alloc<240>();

  const int wg = warp >> 2, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // this thread's rows r0, r0 + 8 of the warpgroup's 64
  const unsigned char* Qw = Q + wg * 8192;
  auto stage = [&](int s) { return ring + (s % ST) * stage_bytes; };
  auto wait_full = [&](int s) { mbar_wait(smem_addr(full + s % ST), (s / ST) & 1); };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + s % ST));
  };
  float o[NV / 2], L[32], L2[32];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
  uint32_t pa[4][4];  // round(e) of a key tile: the A fragments of its four 16-key steps
  auto logits = [&](float (&L)[32], int s) {
    const unsigned char* k = stage(s);
    wgmma_fence();
    for (int c = 0; c < C1P / 64; ++c) {
      const uint32_t a = smem_addr(Qw + c * 16384), bb = smem_addr(k + c * 8192);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<64, 0>(L, desc_k(a + 32 * kk), desc_k(bb + 32 * kk), c + kk > 0);
    }
    wgmma_commit();
  };
  mbar_wait(own, 0);

  // pass 1: the row max, two key tiles a turn (o is not live yet)
  float mx[2] = {-INFINITY, -INFINITY}, ms[2], l[2] = {0.f, 0.f};
  auto row_max = [&](const float (&L)[32], int tile) {
    const int live = p.n_str - tile * RKEYS - 2 * t;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i >> 2) + (i & 1) < live) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], L[i]);
  };
  for (int tile = 0; tile < T; tile += 2) {
    const bool two = tile + 1 < T;
    wait_full(tile);
    if (two) wait_full(tile + 1);
    logits(L, tile);
    if (two) logits(L2, tile + 1);
    wgmma_wait<0>();
    fence_regs(L);
    fence_regs(L2);
    release(tile);
    row_max(L, tile);
    if (two) {
      release(tile + 1);
      row_max(L2, tile + 1);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) mx[hh] = quad_max(mx[hh]), ms[hh] = mx[hh] * LOG2E;

  // pass 2: a turn issues the logits of tile `tile` and the P V of tile - 1,
  // then forms e of the tile while that P V runs
  for (int tile = 0; tile <= T; ++tile) {
    const int sk = T + 2 * tile, sv = sk - 1;  // steps of K_tile and V_{tile - 1}
    if (tile < T) {
      wait_full(sk);
      logits(L, sk);
    }
    if (tile > 0) {
      wait_full(sv);
      const uint32_t vb = smem_addr(stage(sv));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<NV>(o, pa[kk], desc_mn(vb + kk * 2048, 8192));
      wgmma_commit();
    }
    if (tile == T) break;
    if (tile > 0) wgmma_wait<1>();
    else wgmma_wait<0>();
    fence_regs(L);
    release(sk);
    const int live = p.n_str - tile * RKEYS - 2 * t;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = 8 * (i >> 2) + (i & 1) < live ? ex2(fmaf(L[i], LOG2E, -ms[(i >> 1) & 1])) : 0.f;  // exp(s - m)
      l[(i >> 1) & 1] += e;
      L[i] = e;
    }
    if (tile > 0) {  // P V of tile - 1 is done with pa and with its stage
      wgmma_wait<0>();
      release(sv);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(L[8 * kk], L[8 * kk + 1]);
      pa[kk][1] = pack_bf16(L[8 * kk + 2], L[8 * kk + 3]);
      pa[kk][2] = pack_bf16(L[8 * kk + 4], L[8 * kk + 5]);
      pa[kk][3] = pack_bf16(L[8 * kk + 6], L[8 * kk + 7]);
    }
  }
  wgmma_wait<0>();
  fence_regs(o);

  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
  store_acc<NV>(o, p.out1 + bh * p.n_own * p.oc1, p.n_own, p.oc1, own0 + 64 * wg, 0, l);
  if (t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = own0 + 64 * wg + r0 + 8 * hh;
      if (n < p.n_own) p.lse[bh * p.n_own + n] = mx[hh] + logf(l[hh]);
    }
  }
}

// ---- host

// the widest access (16, 8, 4 or 2 bytes) that the base and every stride of a
// dimension longer than 1 keep aligned
inline int wide_align(const Operand& o, int B, int H, int rows) {
  int a = 16;
  auto ok = [&](long long bytes) { return bytes % a == 0; };
  while (a > 2 && !(reinterpret_cast<uintptr_t>(o.ptr) % a == 0 && (B == 1 || ok(2 * o.sb)) &&
                    (H == 1 || ok(2 * o.sh)) && (rows == 1 || ok(2 * o.sn))))
    a /= 2;
  return a;
}

// An operand and its route: TMA where the base and strides are 16-byte
// aligned and the driver encodes the map (boxes of `box_rows` rows), else
// cp.async of the widest aligned size, else element loads
inline WideOp wide_op(const Operand& o, int B, int H, int rows, int cols, CUtensorMap* map, int box_rows) {
  WideOp w{o.ptr, o.sb, o.sh, o.sn, rows, cols, wide_align(o, B, H, rows)};
  if (w.route == 16 && encode_box(map, o.ptr, B, H, rows, cols, o.sb, o.sh, o.sn, box_rows)) w.route = 0;
  return w;
}

// stages of the ring that fit beside the own rows and the rounded tiles, and
// the launch's shared memory
inline void wide_stages(Wide kind, WideArgs& a, size_t& smem) {
  const size_t fixed = 128 * (size_t)(round_up(a.c1, 64) + (kind == Wide::Fwd ? 0 : round_up(a.c2, 64))) +
                       128 * WTILE * (kind == Wide::Dkv ? 2 : 1) + 8 * (WMAX_STAGES + 1) + 4 * 256 + 1024;
  a.stages = (int)std::min<size_t>(WMAX_STAGES, (WSMEM_LIMIT - fixed) / STAGE_BYTES);
  smem = fixed + (size_t)a.stages * STAGE_BYTES;
}

// streamed rows of an output step: the stage holds R rows of 2H columns
inline int wide_rows(int h) { return 2 * h <= 128 ? 128 : 2 * h <= 256 ? 64 : 32; }

template <Wide KIND, int H>
inline int wide_launch(WideArgs a, const WideMaps& m, int B, cudaStream_t stream) {
  a.R = wide_rows(H);
  size_t smem;
  wide_stages(KIND, a, smem);
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  auto kernel = attention_wide_wgmma_kernel<KIND, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((a.n_own + WROWS - 1) / WROWS, a.H * (KIND == Wide::Dkv ? a.slices : 1), B), WTHREADS, smem,
           stream>>>(a, m);
  return (int)cudaGetLastError();
}

// H = half of `cols` rounded up to 128: each warpgroup's output columns
template <Wide KIND>
inline int wide_by_width(int cols, const WideArgs& a, const WideMaps& m, int B, cudaStream_t stream) {
  switch (round_up(cols, 128)) {
    case 128: return wide_launch<KIND, 64>(a, m, B, stream);
    case 256: return wide_launch<KIND, 128>(a, m, B, stream);
    case 384: return wide_launch<KIND, 192>(a, m, B, stream);
    default: return wide_launch<KIND, 256>(a, m, B, stream);
  }
}

template <int NV>
inline int fwd_rows_launch(WideArgs a, const WideMaps& m, int B, cudaStream_t stream) {
  const int c1p = round_up(a.c1, 64), stage_bytes = 128 * RKEYS * std::max(c1p, NV) / 64;
  const size_t fixed = (size_t)c1p * 256 + 16 * (2 * RMAX_STAGES + 1) + 1024;
  a.stages = (int)std::min<size_t>(RMAX_STAGES, (WSMEM_LIMIT - fixed) / stage_bytes);
  if (a.stages < 3) return (int)cudaErrorInvalidValue;  // pass 2 holds K_t and V_t-1
  const size_t smem = fixed + (size_t)a.stages * stage_bytes;
  auto kernel = attention_fwd_rows_kernel<NV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((a.n_own + RROWS - 1) / RROWS, a.H, B), RTHREADS, smem, stream>>>(a, m);
  return (int)cudaGetLastError();
}

// The bf16 forward on `stream`; returns the launch's cudaError_t (0 on success).
// d, dv <= 256 with q, k and v on TMA: attention_fwd_rows_kernel; else the
// split design.
template <int = 0>
inline int fwd_wide_launch(const FwdArgs& f, int B, cudaStream_t stream) {
  if (!wide::dims_ok(f.N, f.M, f.D, f.DV)) return (int)cudaErrorInvalidValue;
  if (f.D <= 256 && f.DV <= 256) {
    WideMaps m{};
    WideArgs a{};
    a.x1 = wide_op(f.q, B, f.H, f.N, f.D, &m.x1, RROWS);
    a.y1 = wide_op(f.k, B, f.H, f.M, f.D, &m.y1, RKEYS);
    a.z1 = wide_op(f.v, B, f.H, f.M, f.DV, &m.z1, RKEYS);
    if (a.x1.route == 0 && a.y1.route == 0 && a.z1.route == 0) {
      a.out1 = f.o;
      a.lse = f.lse;
      a.H = f.H, a.n_own = f.N, a.n_str = f.M, a.c1 = f.D, a.oc1 = f.DV;
      switch (round_up(f.DV, 64)) {
        case 64: return fwd_rows_launch<64>(a, m, B, stream);
        case 128: return fwd_rows_launch<128>(a, m, B, stream);
        case 192: return fwd_rows_launch<192>(a, m, B, stream);
        default: return fwd_rows_launch<256>(a, m, B, stream);
      }
    }
  }
  WideMaps m{};
  WideArgs a{};
  a.x1 = wide_op(f.q, B, f.H, f.N, f.D, &m.x1, WROWS);
  a.y1 = wide_op(f.k, B, f.H, f.M, f.D, &m.y1, WTILE);
  a.z1 = wide_op(f.v, B, f.H, f.M, f.DV, &m.z1, wide_rows(round_up(f.DV, 128) / 2));
  a.out1 = f.o;
  a.lse = f.lse;
  a.H = f.H, a.n_own = f.N, a.n_str = f.M, a.c1 = f.D, a.c2 = 0, a.oc1 = f.DV, a.slices = 1;
  return wide_by_width<Wide::Fwd>(f.DV, a, m, B, stream);
}

// The bf16 dq kernel, then the dk/dv kernel, on `stream`.
template <int = 0>
inline int bwd_wide_launch(const BwdArgs& f, int B, cudaStream_t stream) {
  if (!wide::dims_ok(f.N, f.M, f.D, f.DV)) return (int)cudaErrorInvalidValue;
  WideMaps m{};
  WideArgs a{};
  a.x1 = wide_op(f.q, B, f.H, f.N, f.D, &m.x1, WROWS);
  a.x2 = wide_op(f.dout, B, f.H, f.N, f.DV, &m.x2, WROWS);
  a.y1 = wide_op(f.k, B, f.H, f.M, f.D, &m.y1, WTILE);
  a.y2 = wide_op(f.v, B, f.H, f.M, f.DV, &m.y2, WTILE);
  a.z1 = wide_op(f.k, B, f.H, f.M, f.D, &m.z1, wide_rows(round_up(f.D, 128) / 2));
  a.out1 = f.dq;
  a.lse = const_cast<float*>(f.lse);
  a.delta = f.delta;
  a.H = f.H, a.n_own = f.N, a.n_str = f.M, a.c1 = f.D, a.c2 = f.DV, a.oc1 = f.D, a.slices = 1;
  const int rc = wide_by_width<Wide::Dq>(f.D, a, m, B, stream);
  if (rc != 0) return rc;
  // dk/dv: 256 columns of each a warpgroup; wider ones in column slices of 256
  // on the grid's y, each slice's blocks forming the logits again
  constexpr int HK = 256;
  WideMaps mk{};
  WideArgs k{};
  k.x1 = wide_op(f.k, B, f.H, f.M, f.D, &mk.x1, WROWS);
  k.x2 = wide_op(f.v, B, f.H, f.M, f.DV, &mk.x2, WROWS);
  k.y1 = wide_op(f.q, B, f.H, f.N, f.D, &mk.y1, WTILE);
  k.y2 = wide_op(f.dout, B, f.H, f.N, f.DV, &mk.y2, WTILE);
  k.z1 = wide_op(f.q, B, f.H, f.N, f.D, &mk.z1, wide_rows(HK));
  k.z2 = wide_op(f.dout, B, f.H, f.N, f.DV, &mk.z2, wide_rows(HK));
  k.out1 = f.dk, k.out2 = f.dv;
  k.lse = const_cast<float*>(f.lse);
  k.delta = f.delta;
  k.H = f.H, k.n_own = f.M, k.n_str = f.N, k.c1 = f.D, k.c2 = f.DV, k.oc1 = f.D, k.oc2 = f.DV;
  k.slices = std::max((f.D + HK - 1) / HK, (f.DV + HK - 1) / HK);
  return wide_launch<Wide::Dkv, HK>(k, mk, B, stream);
}

}  // namespace tc
}  // namespace cenet
