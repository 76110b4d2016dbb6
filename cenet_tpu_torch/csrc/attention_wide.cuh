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
// What changes with the width. The narrow designs keep a block's own rows in
// registers (bf16: 16 rows a warp as A fragments, and the fp32 o or dq, dk, dv
// accumulators) or in shared memory as whole rows (fp32). At d = dv = 512 a
// warp's A fragments of q would take 128 registers a thread and its fp32 o 256,
// and the fp32 design's tiles 400 KB of shared memory. So here:
//   - d and dv are cut into chunks of CW = 128 columns. The logits q k^T (and
//     dO v^T) are sums over the chunks, taken in order into one fp32
//     accumulator, each chunk of the streamed side staged in shared memory on
//     its own;
//   - each block writes one 128-column slice of one output (o, dq, dk or dv),
//     the slice on the grid's y beside the head. Every slice's block computes
//     its logits again, in the same order, so they agree to the bit (the row
//     max and LSE too); only the first slice's blocks write the LSE;
//   - dk needs dP = dO v^T over all of dv before ds = P (dP - Delta): its
//     blocks sum dP^T over the dv chunks before they form ds. dv's blocks need
//     P only.
// The cost is the recomputed logits: the forward makes 2 ns N M d of them
// (two passes, ns = dv / 128 slices) beside 2 N M dv of P V; the least work is
// 2 N M (d + dv). This is the simple design; it is bound by operations on an
// H100 SXM (989 TFLOP/s bf16 against 3.35 TB/s) at every site.
//
// Two designs, by dtype, as for the narrow kernels:
//   bf16  the tensor cores (mma.sync.m16n8k16, ldmatrix, cp.async; the helpers
//         of attention_tc.cuh): a block of 4 warps owns 64 rows; the block's own
//         operands (q, and dO for dq; k, and v for dk) stay in shared memory at
//         full width, and a warp reads its A fragments from there 16 columns at
//         a time; the other side streams through two shared buffers in steps of
//         64 rows by one 128-column chunk, one cp.async commit group a step;
//   fp32  CUDA cores in fp32 FMA, the 16 x 16 thread grid and transposed tiles
//         of attention_{fwd,bwd}_common.cuh, both sides staged a chunk at a time.
// Edges as in the narrow kernels: any N, M >= 1; rows past N or M are staged as
// zeros, masked keys get no share of the max and e = P = 0, and rows past the
// end are not stored; d and dv need not be multiples of 16 or 128 (zero columns
// add nothing). Outputs are contiguous.

#pragma once

#include "attention_bwd_common.cuh"
#include "attention_tc.cuh"

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
// bf16, tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int CW = wide::CW;
constexpr int CS = CW / 16;     // 16-deep steps of a chunk
constexpr int PC = pitch(CS);   // pitch of a streamed chunk and of a staged output slice
using WideTiles = Tiles<4, 64>;  // 64 rows a block (16 a warp), chunks of 64 rows streamed

// the pitch of a block's own operand of d columns kept in shared memory: whole
// chunks and 8 more (rows 16 bytes apart mod 128, so ldmatrix is conflict-free)
__host__ __device__ constexpr int wide_pitch(int d) { return wide::chunks(d) * CW + 8; }

// 16-deep steps of chunk c of a dimension d that hold columns below d
__device__ __forceinline__ int chunk_steps(int d, int c) { return min(CS, (d - c * CW + 15) / 16); }

// rows row0 .. row0 + ROWS - 1 and all `cols` columns of one (batch, head)
// slice into a shared tile of pitch `pitch`, a chunk of CW columns at a time
template <int NT, int ROWS>
__device__ __forceinline__ void load_wide(bf16* sm, int pitch, const bf16* g, long long sn, int row0, int rows,
                                          int cols, bool vec) {
  for (int c0 = 0; c0 < cols; c0 += CW)
    load_tile<NT, ROWS, CW / 8>(sm + c0, pitch, g + c0, sn, row0, rows, min(CW, cols - c0), vec);
}

// a streamed step: rows row0 .. row0 + ROWS - 1, columns c0 .. c0 + CW - 1 (of
// `cols`) into a chunk buffer
template <int NT, int ROWS>
__device__ __forceinline__ void load_chunk(bf16* buf, const Operand& o, const bf16* g, int row0, int rows, int c0,
                                           int cols) {
  load_tile<NT, ROWS, CW / 8>(buf, PC, g + c0, o.sn, row0, rows, min(CW, cols - c0), o.vec);
}

// acc (16 x 8 NB) += A (rows r0 .. r0 + 15, columns a0 .. a0 + 16 ks - 1 of a
// shared tile of pitch pa) B, with B a chunk buffer stored [n][k]
template <int NB>
__device__ __forceinline__ void mma_nk_chunk(float (&acc)[NB][4], const bf16* A, int pa, int r0, int a0,
                                             const bf16* Bc, int ks) {
  for (int kk = 0; kk < ks; ++kk) {
    uint32_t a[1][4];
    load_a<1>(a, A + a0 + kk * 16, pa, r0);
    mma_nk<1, NB>(acc, a, Bc + kk * 16, PC);
  }
}

// Rows row0 .. of a staged slice (pitch PC) into `cols` columns of a
// contiguous matrix with rows of `ld`; rows past `rows` are not stored
template <int NT, int ROWS>
__device__ __forceinline__ void store_slice(const bf16* sm, bf16* g, long long ld, int row0, int rows, int cols,
                                            bool vec) {
  constexpr int CH = CW / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, row = row0 + r;
    if (row >= rows || c >= cols) continue;
    bf16* dst = g + row * ld + c;
    const bf16* src = sm + r * PC + c;
    if (vec && c + 8 <= cols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < cols; ++e) dst[e] = src[e];
    }
  }
}

// One block: 64 query rows of one (batch, head), value columns v0 .. v0 + 127.
// Steps: pass 1, for each key tile, the d chunks of K (logits, then the row
// max); pass 2, for each key tile, the d chunks of K again and the tile's V
// slice (e, l and e V).
template <class C>
__global__ void __launch_bounds__(C::THREADS) attention_fwd_wide_tc_kernel(const FwdArgs p) {
  constexpr int BM = C::BM, BK = C::BS, NT = C::THREADS, NB = BK / 8;
  static_assert(BM <= STAGES * BK, "o is staged in the chunk buffers");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int PQ = wide_pitch(p.D);
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BM][PQ]
  bf16* Cs = Qs + BM * PQ;                       // [STAGES][BK][PC]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nd = wide::chunks(p.D), ns = wide::chunks(p.DV);
  const int b = blockIdx.z, h = blockIdx.y / ns, v0 = (blockIdx.y % ns) * CW, q0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + BK - 1) / BK, S1 = T * nd, S = S1 + T * (nd + 1);
  const bf16* kg = p.k.ptr + b * p.k.sb + h * p.k.sh;
  const bf16* vg = p.v.ptr + b * p.v.sb + h * p.v.sh;

  // step s: (key tile, chunk); chunk nd of a pass-2 tile is its V slice
  auto where = [&](int s, int& k0, int& c) {
    const int r = s < S1 ? s : s - S1, per = s < S1 ? nd : nd + 1;
    k0 = (r / per) * BK;
    c = r % per;
  };
  auto issue = [&](int s) {  // one commit group per step, empty past the last
    if (s < S) {
      int k0, c;
      where(s, k0, c);
      bf16* buf = Cs + (s % STAGES) * BK * PC;
      if (c < nd) load_chunk<NT, BK>(buf, p.k, kg, k0, M, c * CW, p.D);
      else load_chunk<NT, BK>(buf, p.v, vg, k0, M, v0, p.DV);
    }
    cp_async_commit();
  };
  load_wide<NT, BM>(Qs, PQ, p.q.ptr + b * p.q.sb + h * p.q.sh, p.q.sn, q0, N, p.D, p.q.vec);
  issue(0);

  // rows g and g + 8 of the warp: the row max, it times log2 e, and this lane's share of the sum of e
  float mx[2] = {-INFINITY, -INFINITY}, ms[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
  float acc[2 * CS][4] = {};
  float sc[NB][4] = {};
  for (int s = 0; s < S; ++s) {
    cp_async_wait<0>();  // step s's chunk has landed
    __syncthreads();     // ... for every thread, and step s - 1's buffer is free
    issue(s + 1);
    int k0, c;
    where(s, k0, c);
    const bf16* buf = Cs + (s % STAGES) * BK * PC;
    const int live = M - k0 - 2 * t;  // element (nb, j) is a key below M iff nb * 8 + (j & 1) < live
    const bool full = k0 + BK <= M;
    if (c < nd) {
      if (c == 0) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[nb][j] = 0.f;
      }
      mma_nk_chunk<NB>(sc, Qs, PQ, w0, c * CW, buf, chunk_steps(p.D, c));
      if (s < S1 && c == nd - 1) {
        auto row_max = [&](auto masked) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (!decltype(masked)::value || nb * 8 + (j & 1) < live) mx[j >> 1] = fmaxf(mx[j >> 1], sc[nb][j]);
        };
        if (full) row_max(std::false_type{}); else row_max(std::true_type{});
        if (s == S1 - 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]), ms[i] = mx[i] * LOG2E;
        }
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
      mma_kn<NB / 2, 2 * CS>(acc, pa, buf, PC);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // o / l through the chunk buffers (free now), and the fp32 LSE from the first slice's blocks
  const long long bh = (long long)b * p.H + h;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  acc_to_smem<2 * CS>(Cs, PC, w0, acc, l);
  if (t == 0 && v0 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + g + 8 * i;
      if (n < N) p.lse[bh * N + n] = mx[i] + logf(l[i]);
    }
  }
  __syncthreads();
  store_slice<NT, BM>(Cs, p.o + bh * N * p.DV + v0, p.DV, q0, N, min(CW, p.DV - v0), p.vec_o);
}

// One block: 64 query rows of one (batch, head), dq columns c0 .. c0 + 127.
// Steps for each key tile: the d chunks of K (S = Q K^T), the dv chunks of V
// (dP = dO V^T), then the tile's K slice (dq += round(ds) K).
template <class C>
__global__ void __launch_bounds__(C::THREADS) attention_bwd_dq_wide_tc_kernel(const BwdArgs p) {
  constexpr int BM = C::BM, BK = C::BS, NT = C::THREADS, NB = BK / 8;
  static_assert(BM <= STAGES * BK, "dq is staged in the chunk buffers");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int PQ = wide_pitch(p.D), PO = wide_pitch(p.DV);
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BM][PQ]
  bf16* Os = Qs + BM * PQ;                       // [BM][PO]   dO
  bf16* Cs = Os + BM * PO;                       // [STAGES][BK][PC]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nd = wide::chunks(p.D), nv = wide::chunks(p.DV), per = nd + nv + 1;
  const int b = blockIdx.z, h = blockIdx.y / nd, c0 = (blockIdx.y % nd) * CW, q0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (M + BK - 1) / BK, S = T * per;
  const long long bh = (long long)b * p.H + h;
  const bf16* kg = p.k.ptr + b * p.k.sb + h * p.k.sh;
  const bf16* vg = p.v.ptr + b * p.v.sb + h * p.v.sh;

  auto issue = [&](int s) {  // one commit group per step, empty past the last
    if (s < S) {
      const int k0 = (s / per) * BK, c = s % per;
      bf16* buf = Cs + (s % STAGES) * BK * PC;
      if (c < nd) load_chunk<NT, BK>(buf, p.k, kg, k0, M, c * CW, p.D);
      else if (c < nd + nv) load_chunk<NT, BK>(buf, p.v, vg, k0, M, (c - nd) * CW, p.DV);
      else load_chunk<NT, BK>(buf, p.k, kg, k0, M, c0, p.D);
    }
    cp_async_commit();
  };
  load_wide<NT, BM>(Qs, PQ, p.q.ptr + b * p.q.sb + h * p.q.sh, p.q.sn, q0, N, p.D, p.q.vec);
  load_wide<NT, BM>(Os, PO, p.dout.ptr + b * p.dout.sb + h * p.dout.sh, p.dout.sn, q0, N, p.DV, p.dout.vec);
  issue(0);

  float lse[2], delta[2];  // rows g and g + 8 of the warp: lse log2 e, Delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + w0 + g + 8 * i;
    lse[i] = n < N ? p.lse[bh * N + n] * LOG2E : 0.f;
    delta[i] = n < N ? p.delta[bh * N + n] : 0.f;
  }

  float dq[2 * CS][4] = {};
  float sc[NB][4] = {}, dp[NB][4] = {};
  for (int s = 0; s < S; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    issue(s + 1);
    const int k0 = (s / per) * BK, c = s % per;
    const bf16* buf = Cs + (s % STAGES) * BK * PC;
    if (c == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nb][j] = dp[nb][j] = 0.f;
    }
    if (c < nd) {
      mma_nk_chunk<NB>(sc, Qs, PQ, w0, c * CW, buf, chunk_steps(p.D, c));
    } else if (c < nd + nv) {
      mma_nk_chunk<NB>(dp, Os, PO, w0, (c - nd) * CW, buf, chunk_steps(p.DV, c - nd));
    } else {
      uint32_t dsa[NB / 2][4];
      const int live = M - k0 - 2 * t;  // keys past M (ragged last tile only) get P = 0
      auto grads = [&](auto masked) {
        float ds[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float pr = ex2(fmaf(sc[nb][j], LOG2E, -lse[j >> 1]));  // exp(s - lse)
            if (decltype(masked)::value && nb * 8 + (j & 1) >= live) pr = 0.f;
            ds[nb][j] = pr * (dp[nb][j] - delta[j >> 1]);
          }
        acc_to_a<NB / 2>(dsa, ds);
      };
      if (k0 + BK <= M) grads(std::false_type{}); else grads(std::true_type{});
      mma_kn<NB / 2, 2 * CS>(dq, dsa, buf, PC);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const float one[2] = {1.f, 1.f};
  acc_to_smem<2 * CS>(Cs, PC, w0, dq, one);
  __syncthreads();
  store_slice<NT, BM>(Cs, p.dq + bh * N * p.D + c0, p.D, q0, N, min(CW, p.D - c0), p.vec_dq);
}

// One block: 64 keys of one (batch, head) and one slice: dk columns c0 .. c0 +
// 127 (slices 0 .. nd - 1) or dv columns (the nv slices after them). Steps for
// each query tile: the d chunks of Q (S^T = K Q^T); for dk the dv chunks of dO
// (dP^T = V dO^T); then the tile's Q slice (dk += round(ds^T) Q) or dO slice
// (dv += round(P^T) dO).
template <class C>
__global__ void __launch_bounds__(C::THREADS) attention_bwd_dkv_wide_tc_kernel(const BwdArgs p) {
  constexpr int BM = C::BM, BN = C::BS, NT = C::THREADS, NB = BN / 8;
  static_assert(BM <= STAGES * BN, "dk and dv are staged in the chunk buffers");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int PQ = wide_pitch(p.D), PO = wide_pitch(p.DV);
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);  // [BM][PQ]
  bf16* Vs = Ks + BM * PQ;                       // [BM][PO]   (dk blocks only)
  bf16* Cs = Vs + BM * PO;                       // [STAGES][BN][PC]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int nd = wide::chunks(p.D), nv = wide::chunks(p.DV);
  const int b = blockIdx.z, h = blockIdx.y / (nd + nv), sl = blockIdx.y % (nd + nv);
  const bool is_dk = sl < nd;
  const int c0 = (is_dk ? sl : sl - nd) * CW, per = nd + (is_dk ? nv : 0) + 1;
  const int k0 = blockIdx.x * BM, w0 = warp * 16;
  const int N = p.N, M = p.M, T = (N + BN - 1) / BN, S = T * per;
  const long long bh = (long long)b * p.H + h;
  const bf16* qg = p.q.ptr + b * p.q.sb + h * p.q.sh;
  const bf16* og = p.dout.ptr + b * p.dout.sb + h * p.dout.sh;
  const float* lse = p.lse + bh * N;
  const float* delta = p.delta + bh * N;

  auto issue = [&](int s) {  // one commit group per step, empty past the last
    if (s < S) {
      const int n0 = (s / per) * BN, c = s % per;
      bf16* buf = Cs + (s % STAGES) * BN * PC;
      if (c < nd) load_chunk<NT, BN>(buf, p.q, qg, n0, N, c * CW, p.D);
      else if (c < per - 1) load_chunk<NT, BN>(buf, p.dout, og, n0, N, (c - nd) * CW, p.DV);
      else if (is_dk) load_chunk<NT, BN>(buf, p.q, qg, n0, N, c0, p.D);
      else load_chunk<NT, BN>(buf, p.dout, og, n0, N, c0, p.DV);
    }
    cp_async_commit();
  };
  load_wide<NT, BM>(Ks, PQ, p.k.ptr + b * p.k.sb + h * p.k.sh, p.k.sn, k0, M, p.D, p.k.vec);
  if (is_dk) load_wide<NT, BM>(Vs, PO, p.v.ptr + b * p.v.sb + h * p.v.sh, p.v.sn, k0, M, p.DV, p.v.vec);
  issue(0);

  float acc[2 * CS][4] = {};
  float st[NB][4] = {}, dpt[NB][4] = {};
  for (int s = 0; s < S; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    issue(s + 1);
    const int n0 = (s / per) * BN, c = s % per;
    const bf16* buf = Cs + (s % STAGES) * BN * PC;
    if (c == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[nb][j] = dpt[nb][j] = 0.f;
    }
    if (c < nd) {
      mma_nk_chunk<NB>(st, Ks, PQ, w0, c * CW, buf, chunk_steps(p.D, c));
    } else if (c < per - 1) {
      mma_nk_chunk<NB>(dpt, Vs, PO, w0, (c - nd) * CW, buf, chunk_steps(p.DV, c - nd));
    } else {
      uint32_t a[NB / 2][4];
      const int live = N - n0 - 2 * t;  // query rows past N (ragged last tile only) get P = 0
      auto grads = [&](auto masked) {
        float x[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int col = nb * 8 + 2 * t + i;  // this lane's query row of elements j = i, i + 2
            const bool in = n0 + col < N;
            const float ls = in ? lse[n0 + col] * LOG2E : 0.f;
            const float dl = in && is_dk ? delta[n0 + col] : 0.f;
#pragma unroll
            for (int j = i; j < 4; j += 2) {
              float pr = ex2(fmaf(st[nb][j], LOG2E, -ls));  // exp(s - lse)
              if (decltype(masked)::value && nb * 8 + i >= live) pr = 0.f;
              x[nb][j] = is_dk ? pr * (dpt[nb][j] - dl) : pr;  // ds^T or P^T
            }
          }
        acc_to_a<NB / 2>(a, x);
      };
      if (n0 + BN <= N) grads(std::false_type{}); else grads(std::true_type{});
      mma_kn<NB / 2, 2 * CS>(acc, a, buf, PC);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const float one[2] = {1.f, 1.f};
  acc_to_smem<2 * CS>(Cs, PC, w0, acc, one);
  __syncthreads();
  if (is_dk) store_slice<NT, BM>(Cs, p.dk + bh * M * p.D + c0, p.D, k0, M, min(CW, p.D - c0), p.vec_dk);
  else store_slice<NT, BM>(Cs, p.dv + bh * M * p.DV + c0, p.DV, k0, M, min(CW, p.DV - c0), p.vec_dv);
}

template <class C>
inline size_t wide_smem(int own_d, int own_dv) {
  return 2 * (C::BM * (wide_pitch(own_d) + (own_dv > 0 ? wide_pitch(own_dv) : 0)) + STAGES * C::BS * PC);
}

// The bf16 forward on `stream`; returns the launch's cudaError_t (0 on success).
template <int = 0>
inline int fwd_wide_launch(const FwdArgs& a, int B, cudaStream_t stream) {
  if (!wide::dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  using C = WideTiles;
  return launch_one<C>(attention_fwd_wide_tc_kernel<C>, a.N, a.H * wide::chunks(a.DV), B, wide_smem<C>(a.D, 0),
                       stream, a);
}

// The bf16 dq kernel, then the dk/dv kernel, on `stream`.
template <int = 0>
inline int bwd_wide_launch(const BwdArgs& a, int B, cudaStream_t stream) {
  if (!wide::dims_ok(a.N, a.M, a.D, a.DV)) return (int)cudaErrorInvalidValue;
  using C = WideTiles;
  const size_t smem = wide_smem<C>(a.D, a.DV);
  const int rc = launch_one<C>(attention_bwd_dq_wide_tc_kernel<C>, a.N, a.H * wide::chunks(a.D), B, smem, stream, a);
  if (rc != 0) return rc;
  return launch_one<C>(attention_bwd_dkv_wide_tc_kernel<C>, a.M, a.H * (wide::chunks(a.D) + wide::chunks(a.DV)), B,
                       smem, stream, a);
}

}  // namespace tc
}  // namespace cenet
