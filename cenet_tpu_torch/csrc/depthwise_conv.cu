// Depthwise 3x3 convolution, stride 1, padding = dilation (shape-preserving):
// the forward, and the weight gradient dw summed over batch and space.
//
// Replaces tools/negative_results/depthwise.py::_pallas_depthwise_fwd (body
// _fwd_kernel) and _pallas_depthwise_dw (body _dw_kernel). The backward's dx is
// the forward on the upstream gradient with the spatially flipped kernel, as
// _dp_bwd does, so it needs no kernel of its own.
//
// Bound: bytes. Nine multiply-adds per output element against one element
// read and one written (forward), or one element of x and one of g read per
// nine sums (dw): the only gain is to move each byte once at full width. The
// TPU kernel keeps a whole padded (H, W, C) map in VMEM. The kernels take
// element strides on every dim of x, g and the output, so the model's NCHW
// tensors arrive as permute(0, 2, 3, 1) views without a copy. Both dtypes,
// dilations 1-5 (a template argument), all index arithmetic in 32 bits with
// divisions by multiply-high (the wrapper checks that every offset fits).
//
// Forward, two layouts:
//   * channels-last (unit channel stride, 16-byte aligned channel vectors,
//     e.g. the PVT DWConvs): threads along C with 16-byte vectors (8 bf16 or 4
//     fp32 channels), each sliding a 3-row window along W over 8 outputs with
//     its channels' taps in registers (dw3x3_cl_kernel);
//   * any other strides (NCHW views): a block stages a strip of rows of one
//     plane, or several whole small planes, with its halo in shared memory by
//     16-byte (else 4-byte, else element) loads along W, and each thread
//     computes 16 bytes' worth of adjacent outputs from registers and stores
//     them with one 16-byte store where aligned (dw3x3_plane_kernel).
//
// dw, one rule by layout (dw_plan; the wrapper counts which one each call takes):
//   * x and g both with a unit channel stride: dw3x3_dw_cl_kernel. A thread
//     owns one vector of 4 channels (8 bytes in bf16, 16 in fp32; element
//     loads where C, a stride or an address does not allow them) and walks
//     tasks of 8 positions of a row at stride DIL, sliding a window of 3 rows
//     x 3 columns of x vectors by one column (3 loads) per position beside one
//     load of g, with its 9 x 4 fp32 sums in registers;
//   * any other strides (NCHW views, and x and g in two layouts):
//     dw3x3_dw_plane_kernel. A block stages a strip of rows of x with its
//     halo, or several whole small planes, and the matching rows of g in
//     shared memory with the forward's loads (16-byte where W has unit stride,
//     else element loads); each thread sums the 9 taps over runs of 16 bytes'
//     worth of positions from 16-byte shared loads. No site of the train step
//     hands over two layouts (chip_smoke.py records them).
// On the TPU the sequential grid carries the sum over the batch in the output
// block (_dw_kernel's "+="); blocks on the card run in no order. So each block
// sums the products of one slice of the positions ("part") for its channels
// in a fixed order (its threads' running sums, then a fixed tree over the
// threads) and writes that partial; the last block of each channel group to
// finish (a ticket counter after __threadfence) adds the group's partials in
// part order into dw and re-arms the counter. dw_plan sizes the parts to the
// work (the wrapper asks it how many, to size the partials). No atomics on
// the sums: repeat runs are bit-identical.
//
// Numerics as the Pallas bodies: x (or g) in its dtype, the taps in fp32, the
// sum in fp32 over the taps in (dy, dx) order (taps outside the map add
// zero), one rounding to the output's dtype; dw in fp32. Every output element
// is written by one thread: repeat runs are bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

struct Strides {
  long long b, h, w, c;
};

// ---------------------------------------------------------------------------
// The forward: tiled, vectorised, 32-bit indices
// ---------------------------------------------------------------------------

// Element offsets; the wrapper checks that every offset of x and out fits in
// 31 bits.
struct IStrides {
  int b, h, w, c;
};

// n / d for n, d < 2^31 by multiply-high and shift (Granlund and Montgomery),
// with the magic numbers made on the host: no division instruction.
struct FastDiv {
  unsigned m, s;
};
inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  return {(unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}
__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return (int)((__umulhi((unsigned)n, f.m) + (unsigned)n) >> f.s);
}

// 16 bytes: VEC = 8 bf16 or 4 fp32 elements
template <typename T>
struct VecOf {
  static constexpr int N = 16 / sizeof(T);
};
// element e of T, as fp32, from the raw word v (uint4 or uint2)
template <typename T, typename W>
__device__ __forceinline__ float elem(const W& v, int e) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  if constexpr (sizeof(T) == 2) {
    const uint32_t word = w[e >> 1];
    return __uint_as_float((e & 1 ? word >> 16 : word & 0xffffu) << 16);
  } else {
    return __uint_as_float(w[e]);
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* a) {
  uint4 v;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
      (&v.x)[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) (&v.x)[e] = __float_as_uint(a[e]);
  }
  return v;
}
__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// one load or store instruction of N bytes
template <int N> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };

// VEC elements of a row from column col0 on (zeros outside columns 0 .. wd - 1),
// the row at row[0] with element stride sw: one 16-byte load where they lie
// inside the row at unit stride and aligned, 4-byte loads where 4-byte
// aligned (bf16), else element loads
template <typename T>
__device__ __forceinline__ uint4 load_row_vec(const T* row, int col0, int wd, int sw) {
  constexpr int VEC = VecOf<T>::N;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (col0 + VEC <= 0 || col0 >= wd) return val;
  const T* src = row + col0 * sw;
  const bool inside = sw == 1 && col0 >= 0 && col0 + VEC <= wd;
  if (inside && aligned16(src)) {
    val = *reinterpret_cast<const uint4*>(src);
  } else if (sizeof(T) == 2 && inside && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) (&val.x)[e] = reinterpret_cast<const uint32_t*>(src)[e];
  } else {
    T* ev = reinterpret_cast<T*>(&val);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (col0 + e >= 0 && col0 + e < wd) ev[e] = src[e * sw];
  }
  return val;
}

constexpr int FWD_THREADS = 256;
constexpr int MAX_PLANES = 64;  // planes a block of the plane kernel takes at most

// NCHW views and any other strides. A block takes np (b, c) planes and the
// output rows r0 .. r0 + rows - 1 of each (small maps: whole planes, several
// to a block; large maps: a strip of rows of one plane). It stages the strip's
// input rows with their DIL-row halo in shared memory, in x's dtype, each row
// at a left offset L (a whole number of 16-byte vectors >= DIL) between zero
// pads: 16-byte loads where a vector of a row lies inside it and is aligned,
// 4-byte loads where it is 4-byte aligned (bf16), else element loads. Each
// thread then computes V adjacent outputs of a row from registers: three rows'
// windows of 16-byte shared loads, the plane's nine fp32 taps, the sums in
// (dy, dx) order, one rounding, and a 16-byte store where aligned.
template <typename T, int DIL, int V>
__global__ void __launch_bounds__(FWD_THREADS) dw3x3_plane_kernel(const T* __restrict__ x,
                                                                 const float* __restrict__ w, T* __restrict__ out,
                                                                 int nplanes, int c, int h, int wd, int np, int rows,
                                                                 int rpr, int pitch, FastDiv div_c, FastDiv div_nv,
                                                                 FastDiv div_sr, FastDiv div_rpr, FastDiv div_rows,
                                                                 IStrides sx, IStrides so) {
  constexpr int VEC = VecOf<T>::N, L = VEC * ((DIL + VEC - 1) / VEC), NWV = (2 * L + V) / VEC;
  static_assert(V % VEC == 0, "whole vectors of outputs");
  extern __shared__ __align__(16) unsigned char plane_smem[];
  T* buf = reinterpret_cast<T*>(plane_smem);  // [np][rows + 2 DIL][pitch]
  __shared__ int xbase[MAX_PLANES], obase[MAX_PLANES];
  __shared__ float taps[MAX_PLANES][9];
  const int tid = threadIdx.x, pl0 = blockIdx.x * np, r0 = blockIdx.y * rows, sr_n = rows + 2 * DIL;
  for (int p = tid; p < np; p += FWD_THREADS) {
    const int pl = pl0 + p;
    if (pl < nplanes) {
      const int bb = fdiv(pl, div_c), cc = pl - bb * c;
      xbase[p] = bb * sx.b + cc * sx.c;
      obase[p] = bb * so.b + cc * so.c;
#pragma unroll
      for (int t = 0; t < 9; ++t) taps[p][t] = w[t * c + cc];
    } else {
      xbase[p] = -1;
    }
  }
  __syncthreads();
  const int nv = pitch / VEC;
  for (int i = tid; i < np * sr_n * nv; i += FWD_THREADS) {
    const int q = fdiv(i, div_nv), v = i - q * nv, p = fdiv(q, div_sr), sr = q - p * sr_n;
    const int yy = r0 - DIL + sr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (xbase[p] >= 0 && yy >= 0 && yy < h) val = load_row_vec(x + xbase[p] + yy * sx.h, v * VEC - L, wd, sx.w);
    *reinterpret_cast<uint4*>(buf + (p * sr_n + sr) * pitch + v * VEC) = val;
  }
  __syncthreads();
  for (int i = tid; i < np * rows * rpr; i += FWD_THREADS) {
    const int q = fdiv(i, div_rpr), run = i - q * rpr, p = fdiv(q, div_rows), r = q - p * rows;
    const int y = r0 + r, x0 = run * V;
    if (xbase[p] < 0 || y >= h) continue;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      // the row's window: buffer columns x0 .. x0 + 2L + V - 1 (map columns x0 - L ..)
      const uint4* row = reinterpret_cast<const uint4*>(buf + (p * sr_n + r + dy * DIL) * pitch + x0);
      uint4 win[NWV];
#pragma unroll
      for (int k = 0; k < NWV; ++k) win[k] = row[k];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float tap = taps[p][dy * 3 + dx];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int col = L + e + (dx - 1) * DIL;
          acc[e] = fmaf(elem<T>(win[col / VEC], col % VEC), tap, acc[e]);
        }
      }
    }
    T* dst = out + obase[p] + y * so.h + x0 * so.w;
    if (so.w == 1 && x0 + V <= wd && aligned16(dst)) {
#pragma unroll
      for (int k = 0; k < V / VEC; ++k) reinterpret_cast<uint4*>(dst)[k] = pack<T>(acc + k * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (x0 + e < wd) dst[e * so.w] = from_f<T>(acc[e]);
    }
  }
}

// Channels-last (unit channel stride, 16-byte aligned channel vectors). A
// thread takes one vector of VEC channels (8 bf16, 4 fp32) and XT adjacent
// outputs of one row: consecutive threads take consecutive channel vectors,
// so a warp's loads and stores are contiguous. It keeps the taps of its
// channels in registers and slides a window of 3 rows x (2 DIL + 1) columns of
// input vectors along W, loading one new column (three vectors) per output.
template <typename T, int DIL, int XT>
__global__ void __launch_bounds__(FWD_THREADS) dw3x3_cl_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                                              T* __restrict__ out, int total, int c, int h, int wd,
                                                              int cvecs, int col_tiles, FastDiv div_cv,
                                                              FastDiv div_ct, FastDiv div_h, IStrides sx,
                                                              IStrides so) {
  constexpr int VEC = VecOf<T>::N, WC = 2 * DIL + 1;
  const int i = blockIdx.x * FWD_THREADS + threadIdx.x;
  if (i >= total) return;
  int q = fdiv(i, div_cv);
  const int cv = i - q * cvecs;
  const int q2 = fdiv(q, div_ct), tx = q - q2 * col_tiles, b = fdiv(q2, div_h), y = q2 - b * h;
  const int ch0 = cv * VEC, x0 = tx * XT;
  float tp[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(w + t * c + ch0)[k];
      tp[t][4 * k] = v.x, tp[t][4 * k + 1] = v.y, tp[t][4 * k + 2] = v.z, tp[t][4 * k + 3] = v.w;
    }
  const T* xb = x + b * sx.b + ch0;
  auto load = [&](int dy, int col) {
    const int yy = y + (dy - 1) * DIL;
    return yy >= 0 && yy < h && col >= 0 && col < wd
               ? *reinterpret_cast<const uint4*>(xb + yy * sx.h + col * sx.w)
               : make_uint4(0u, 0u, 0u, 0u);
  };
  // win[dy][k] holds column x - DIL + k of row y + (dy - 1) DIL for the output x
  uint4 win[3][WC];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int k = 1; k < WC; ++k) win[dy][k] = load(dy, x0 - DIL + k - 1);
  T* ob = out + b * so.b + y * so.h + ch0;
#pragma unroll
  for (int j = 0; j < XT; ++j) {
    const int xo = x0 + j;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int k = 0; k < WC - 1; ++k) win[dy][k] = win[dy][k + 1];
      win[dy][WC - 1] = load(dy, xo + DIL);
    }
    if (xo >= wd) break;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(elem<T>(win[dy][dx * DIL], e), tp[dy * 3 + dx][e], acc[e]);
    *reinterpret_cast<uint4*>(ob + xo * so.w) = pack<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// dw: tiled, vectorised, 32-bit indices, the ordered sum in the same launch
// ---------------------------------------------------------------------------

constexpr int DW_THREADS = 256;
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int MAX_CVB = 8;  // channel vectors a channels-last block takes at most

// A block's sum s of tap t for channel ch: straight into dw when the
// positions are one part, else into the part's partial
__device__ __forceinline__ void put_sum(float s, int t, int ch, int c, int part, int parts, float* partial,
                                        float* dw) {
  if (parts == 1) dw[t * c + ch] = s;
  else partial[((long long)part * 9 + t) * c + ch] = s;
}

// After every thread of the block has put its sums: with more than one part,
// the last block of channel group blockIdx.x to arrive adds the group's
// partials (channels c0 .. c0 + nch - 1) in part order into dw and re-arms the
// group's ticket for the next launch
__device__ void finish_group(const float* partial, float* dw, unsigned* ticket, int parts, int c, int c0, int nch) {
  __shared__ bool last;
  __threadfence();  // this thread's partials visible to the block that sums them
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 9 * nch; i += DW_THREADS) {
    const int t = i / nch, ch = c0 + i - t * nch;
    const float* src = partial + (long long)t * c + ch;
    float s = 0.f;
#pragma unroll 4
    for (int k = 0; k < parts; ++k) s += __ldcg(src + (long long)k * 9 * c);  // L2: written by other SMs
    dw[t * c + ch] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// Channels-last x and g (unit channel stride). A block takes channel group
// blockIdx.x (cvb = 2^log_cvb vectors of CPT channels, cvb <= MAX_CVB) and part
// blockIdx.y, the tasks blockIdx.y * per .. + per - 1; thread (lane, cvl),
// tid = lane * cvb + cvl, takes every (DW_THREADS / cvb)-th of them for its
// vector cvl. A task is XT positions of one row at stride DIL, x = r + DIL *
// (j * XT + k) for k < XT, task = ((b * H + y) * DIL + r) * tiles + j, so a
// thread's window is 3 rows x 3 columns of x vectors, sliding by one column (3
// loads) per position, beside one load of g. VEC: CPT * sizeof(T)-byte loads
// (else element loads, zeros past channel c - 1). The fixed tree: shuffles
// over the lanes of a warp, then the warps in order through shared memory.
template <typename T, int DIL, int CPT, int XT, bool VEC>
__global__ void __launch_bounds__(DW_THREADS, 2)
    dw3x3_dw_cl_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
                       float* __restrict__ dw, unsigned* __restrict__ tickets, int c, int h, int wd, int log_cvb,
                       int tiles, int ntasks, int per, int parts, FastDiv div_tiles, FastDiv div_h, IStrides sx,
                       IStrides sg) {
  using W = typename Word<CPT * sizeof(T)>::type;
  constexpr int LOG_CPT = CPT == 8 ? 3 : CPT == 4 ? 2 : CPT == 2 ? 1 : 0;
  static_assert((1 << LOG_CPT) == CPT, "CPT a power of two up to 8");
  __shared__ float red[DW_WARPS][9][MAX_CVB * CPT];
  const int tid = threadIdx.x, cvb = 1 << log_cvb, cvl = tid & (cvb - 1), lane = tid >> log_cvb;
  const int lanes = DW_THREADS >> log_cvb, c0 = blockIdx.x * cvb * CPT, ch0 = c0 + cvl * CPT;
  const int nvalid = min(CPT, c - ch0);
  auto ld = [&](const T* p) {
    W v;
    if constexpr (VEC) {
      v = *reinterpret_cast<const W*>(p);
    } else {
      T* ev = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int e = 0; e < CPT; ++e) ev[e] = e < nvalid ? p[e] : from_f<T>(0.f);
    }
    return v;
  };
  float acc[9][CPT];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[t][e] = 0.f;
  const int end = min(ntasks, (blockIdx.y + 1) * per);
  for (int task = blockIdx.y * per + lane; nvalid > 0 && task < end; task += lanes) {
    const int q = fdiv(task, div_tiles), j = task - q * tiles, row = q / DIL, r = q - row * DIL;
    const int b = fdiv(row, div_h), y = row - b * h, x0 = r + DIL * j * XT;
    const T* xr[3];
    bool rv[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = y + (dy - 1) * DIL;
      rv[dy] = yy >= 0 && yy < h;
      xr[dy] = x + b * sx.b + yy * sx.h + ch0;
    }
    const T* gr = g + b * sg.b + y * sg.h + ch0;
    auto xload = [&](int dy, int col) { return rv[dy] && col >= 0 && col < wd ? ld(xr[dy] + col * sx.w) : W{}; };
    W win[3][3];  // win[dy][k]: column xc + (k - 1) DIL of row y + (dy - 1) DIL for the position xc
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      win[dy][0] = xload(dy, x0 - DIL);
      win[dy][1] = xload(dy, x0);
    }
#pragma unroll
    for (int k = 0; k < XT; ++k) {
      const int xc = x0 + k * DIL;
      if (xc >= wd) break;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) win[dy][2] = xload(dy, xc + DIL);
      const W gv = ld(gr + xc * sg.w);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int e = 0; e < CPT; ++e)
            acc[dy * 3 + dx][e] = fmaf(elem<T>(win[dy][dx], e), elem<T>(gv, e), acc[dy * 3 + dx][e]);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[dy][0] = win[dy][1];
        win[dy][1] = win[dy][2];
      }
    }
  }
  // lanes of one warp differ in tid by multiples of cvb: xor over cvb .. 16
  for (int o = cvb; o < 32; o <<= 1)
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], o);
  if ((tid & 31) < cvb) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < CPT; ++e) red[tid >> 5][t][cvl * CPT + e] = acc[t][e];
  }
  __syncthreads();
  const int nch = min(cvb * CPT, c - c0), log_gc = log_cvb + LOG_CPT;
  for (int i = tid; i < 9 << log_gc; i += DW_THREADS) {
    const int t = i >> log_gc, k = i - (t << log_gc);
    if (k >= nch) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < DW_WARPS; ++w) s += red[w][t][k];
    put_sum(s, t, c0 + k, c, blockIdx.y, parts, partial, dw);
  }
  if (parts > 1) finish_group(partial, dw, tickets + blockIdx.x, parts, c, c0, nch);
}

// Any other strides (NCHW views). A block takes cg = 2^log_cg planes, the
// channels c0 = blockIdx.x * cg .. c0 + cg - 1 of one batch item, and the rows
// r0 .. r0 + rows - 1 of each: part blockIdx.y = b * nstrips + strip. It
// stages those rows of x with their DIL-row halo, each row at a left offset L
// (a whole number of 16-byte vectors >= DIL) between zero pads, and the rows
// of g (zeros past the map), in shared memory with the forward's loads. The
// DW_THREADS / cg threads of a plane take runs of V adjacent positions: per
// run one 16-byte window of each x row and of g from shared memory and 9 fp32
// sums; then a fixed tree over the plane's threads (shuffles, then its warps
// in order through shared memory).
template <typename T, int DIL, int V>
__global__ void __launch_bounds__(DW_THREADS)
    dw3x3_dw_plane_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
                          float* __restrict__ dw, unsigned* __restrict__ tickets, int c, int h, int wd, int log_cg,
                          int rows, int rpr, int pitch, int nstrips, int parts, FastDiv div_nv, FastDiv div_sr,
                          FastDiv div_gnv, FastDiv div_rows, FastDiv div_rpr, FastDiv div_strips, IStrides sx,
                          IStrides sg) {
  constexpr int VEC = VecOf<T>::N, L = VEC * ((DIL + VEC - 1) / VEC), NWV = (2 * L + V) / VEC, GV = V / VEC;
  static_assert(V % VEC == 0, "whole vectors of positions");
  extern __shared__ __align__(16) unsigned char plane_smem[];
  __shared__ float red[DW_WARPS][9];
  const int tid = threadIdx.x, cg = 1 << log_cg, c0 = blockIdx.x * cg, part = blockIdx.y;
  const int b = fdiv(part, div_strips), r0 = (part - b * nstrips) * rows, sr_n = rows + 2 * DIL, gpitch = rpr * V;
  T* xbuf = reinterpret_cast<T*>(plane_smem);  // [cg][rows + 2 DIL][pitch]
  T* gbuf = xbuf + cg * sr_n * pitch;          // [cg][rows][gpitch]
  const int nv = pitch / VEC, gnv = gpitch / VEC;
  for (int i = tid; i < cg * sr_n * nv; i += DW_THREADS) {
    const int q = fdiv(i, div_nv), v = i - q * nv, p = fdiv(q, div_sr), sr = q - p * sr_n;
    const int cc = c0 + p, yy = r0 - DIL + sr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (cc < c && yy >= 0 && yy < h) val = load_row_vec(x + b * sx.b + cc * sx.c + yy * sx.h, v * VEC - L, wd, sx.w);
    *reinterpret_cast<uint4*>(xbuf + (p * sr_n + sr) * pitch + v * VEC) = val;
  }
  for (int i = tid; i < cg * rows * gnv; i += DW_THREADS) {
    const int q = fdiv(i, div_gnv), v = i - q * gnv, p = fdiv(q, div_rows), r = q - p * rows;
    const int cc = c0 + p, yy = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (cc < c && yy < h) val = load_row_vec(g + b * sg.b + cc * sg.c + yy * sg.h, v * VEC, wd, sg.w);
    *reinterpret_cast<uint4*>(gbuf + (p * rows + r) * gpitch + v * VEC) = val;
  }
  __syncthreads();
  const int log_tpp = 8 - log_cg, tpp = 1 << log_tpp, p = tid >> log_tpp, lane = tid & (tpp - 1);
  static_assert(DW_THREADS == 1 << 8, "log_tpp");
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  for (int i = lane; i < rows * rpr; i += tpp) {  // positions past the map meet zeros of g
    const int r = fdiv(i, div_rpr), x0 = (i - r * rpr) * V;
    const uint4* grow = reinterpret_cast<const uint4*>(gbuf + (p * rows + r) * gpitch + x0);
    uint4 gv[GV];
#pragma unroll
    for (int k = 0; k < GV; ++k) gv[k] = grow[k];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      // the row's window: buffer columns x0 .. x0 + 2L + V - 1 (map columns x0 - L ..)
      const uint4* row = reinterpret_cast<const uint4*>(xbuf + (p * sr_n + r + dy * DIL) * pitch + x0);
      uint4 win[NWV];
#pragma unroll
      for (int k = 0; k < NWV; ++k) win[k] = row[k];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int col = L + e + (dx - 1) * DIL;
          acc[dy * 3 + dx] = fmaf(elem<T>(win[col / VEC], col % VEC), elem<T>(gv[e / VEC], e % VEC), acc[dy * 3 + dx]);
        }
    }
  }
  // a plane's threads are tid p * tpp .. + tpp - 1: xor inside the warp, then its warps in order
  for (int o = min(tpp, 32) >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
  if (tpp > 32) {
    if ((tid & 31) == 0) {
#pragma unroll
      for (int t = 0; t < 9; ++t) red[tid >> 5][t] = acc[t];
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        float s = 0.f;
        for (int w = 0; w < tpp >> 5; ++w) s += red[(tid >> 5) + w][t];
        acc[t] = s;
      }
    }
  }
  if (lane == 0 && c0 + p < c) {
#pragma unroll
    for (int t = 0; t < 9; ++t) put_sum(acc[t], t, c0 + p, c, part, parts, partial, dw);
  }
  if (parts > 1) finish_group(partial, dw, tickets + blockIdx.x, parts, c, c0, min(cg, c - c0));
}

// The tilings launched: the plane kernel V = one 16-byte vector of outputs a
// thread (two were 1.1-2.1x slower at the NCHW sites) and about TARGET_RUNS
// runs of V outputs a block; the channels-last kernel XT = 8 outputs along W
// a thread (time_tilings k11)
constexpr int TARGET_RUNS = 512;
template <typename T>
struct FwdTiles {
  static constexpr int V = VecOf<T>::N, XT = 8;
};
// dw's (time_tilings k11dw): CPT = 4 channels a channels-last thread (8 bytes
// in bf16, 16 in fp32: with 8 bf16 channels, 72 sums, the kernel spilled at
// the 128 registers of two blocks an SM), XT positions a task, at most
// BLOCKS_PER_SM blocks an SM for the channels-last kernel (one wave: a few
// blocks more ran as a second wave at half speed), about RUNS runs of one
// 16-byte vector of positions a plane block
template <typename T>
struct DwTiles {
  static constexpr int CPT = 4, XT = 8, BLOCKS_PER_SM = 2, RUNS = 512;
};
constexpr int SMEM_MAX = 40 * 1024;  // of the 48 KB a launch takes without opting in, beside the static arrays
constexpr int MAX_CG = 32;           // planes a block of the dw plane kernel takes at most

inline IStrides istrides(Strides s) { return {(int)s.b, (int)s.h, (int)s.w, (int)s.c}; }

template <typename T, int DIL, int V>
cudaError_t launch_plane(const T* x, const float* w, T* out, int b, int h, int wd, int c, Strides sx, Strides so,
                         int target_runs, cudaStream_t stream) {
  constexpr int VEC = VecOf<T>::N, L = VEC * ((DIL + VEC - 1) / VEC);
  const int rpr = (wd + V - 1) / V, pitch = 2 * L + rpr * V, nplanes = b * c;
  int rows = h, np = 1;
  if (rpr * h <= target_runs) np = std::min(MAX_PLANES, std::max(1, target_runs / (rpr * h)));
  else rows = std::max(1, target_runs / rpr);
  while (np > 1 && np * (rows + 2 * DIL) * pitch * (int)sizeof(T) > SMEM_MAX) --np;
  while (rows > 1 && (rows + 2 * DIL) * pitch * (int)sizeof(T) > SMEM_MAX) rows = (rows + 1) / 2;
  const int smem = np * (rows + 2 * DIL) * pitch * (int)sizeof(T);
  // one row and its halo must fit: W up to about 900 (fp32) or 1800 (bf16) at DIL = 5
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  dim3 grid((nplanes + np - 1) / np, (h + rows - 1) / rows);
  dw3x3_plane_kernel<T, DIL, V><<<grid, FWD_THREADS, smem, stream>>>(
      x, w, out, nplanes, c, h, wd, np, rows, rpr, pitch, fast_div(c), fast_div(pitch / VEC),
      fast_div(rows + 2 * DIL), fast_div(rpr), fast_div(rows), istrides(sx), istrides(so));
  return cudaGetLastError();
}

template <typename T, int DIL, int XT>
cudaError_t launch_cl(const T* x, const float* w, T* out, int b, int h, int wd, int c, Strides sx, Strides so,
                      cudaStream_t stream) {
  const int cvecs = c / VecOf<T>::N, col_tiles = (wd + XT - 1) / XT;
  const long long total = (long long)b * h * col_tiles * cvecs;
  if (total >= (1ll << 31)) return cudaErrorInvalidValue;
  dw3x3_cl_kernel<T, DIL, XT><<<(unsigned)((total + FWD_THREADS - 1) / FWD_THREADS), FWD_THREADS, 0, stream>>>(
      x, w, out, (int)total, c, h, wd, cvecs, col_tiles, fast_div(cvecs), fast_div(col_tiles), fast_div(h),
      istrides(sx), istrides(so));
  return cudaGetLastError();
}

// channels-last with 16-byte channel vectors on x, out and the taps
template <typename T>
bool channels_last(const void* x, const float* w, const void* out, int c, Strides sx, Strides so) {
  constexpr int VEC = VecOf<T>::N;
  auto vec = [](Strides s) { return s.c == 1 && s.b % VEC == 0 && s.h % VEC == 0 && s.w % VEC == 0; };
  return vec(sx) && vec(so) && c % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <typename T, int DIL, int V = FwdTiles<T>::V, int XT = FwdTiles<T>::XT>
cudaError_t launch_fwd_dil(const void* x, const float* w, void* out, int b, int h, int wd, int c, Strides sx,
                           Strides so, int target_runs, cudaStream_t stream) {
  auto xt = static_cast<const T*>(x);
  auto ot = static_cast<T*>(out);
  if (channels_last<T>(x, w, out, c, sx, so)) return launch_cl<T, DIL, XT>(xt, w, ot, b, h, wd, c, sx, so, stream);
  return launch_plane<T, DIL, V>(xt, w, ot, b, h, wd, c, sx, so, target_runs, stream);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* w, void* out, int b, int h, int wd, int c, int dil, Strides sx,
                       Strides so, cudaStream_t stream) {
  if ((long long)b * h * wd * c == 0) return cudaSuccess;
  switch (dil) {
    case 1: return launch_fwd_dil<T, 1>(x, w, out, b, h, wd, c, sx, so, TARGET_RUNS, stream);
    case 2: return launch_fwd_dil<T, 2>(x, w, out, b, h, wd, c, sx, so, TARGET_RUNS, stream);
    case 3: return launch_fwd_dil<T, 3>(x, w, out, b, h, wd, c, sx, so, TARGET_RUNS, stream);
    case 4: return launch_fwd_dil<T, 4>(x, w, out, b, h, wd, c, sx, so, TARGET_RUNS, stream);
    case 5: return launch_fwd_dil<T, 5>(x, w, out, b, h, wd, c, sx, so, TARGET_RUNS, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_dil(int dil, F&& f) {
  switch (dil) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    default: return cudaErrorInvalidValue;
  }
}

// The layout rule's routes (the wrapper names them in this order)
enum DwRoute { DW_CHANNELS_LAST = 0, DW_PLANES = 1 };

// How the dw kernels cut their work: groups blocks along C times parts slices
// of the positions, each block giving one partial of every (tap, channel) of
// its group. Channels-last: a block takes 2^log_block vectors of CPT channels
// and the tasks part * per .. + per - 1. Planes: a block takes 2^log_block
// channels of one batch item and per rows of them, part = b * strips + strip.
struct DwPlan {
  int route, groups, parts, log_block, per;
};

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }
inline int log2_floor(int n) { return 31 - __builtin_clz((unsigned)n); }
inline int pow2_at_least(int n) { return n <= 1 ? 1 : 1 << (32 - __builtin_clz((unsigned)(n - 1))); }

// The rule: channels-last when x and g both have a unit channel stride (or C =
// 1), at most BLOCKS_PER_SM blocks an SM and no more parts than the positions
// give work to every lane; else planes, blocks of about RUNS runs, as many
// planes a block as fit. So the small sites take one small wave. A route of -1:
// no cut fits (a plane row with its halo wider than a block's shared memory,
// or 2^31 tasks).
template <typename T, class Tiles = DwTiles<T>>
DwPlan dw_plan(int b, int h, int wd, int c, int dil, long long sxc, long long sgc) {
  if ((sxc == 1 && sgc == 1) || c == 1) {
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int cvecs = ceil_div(c, Tiles::CPT), cvb = std::min(MAX_CVB, pow2_at_least(cvecs));
    const int groups = ceil_div(cvecs, cvb);
    const long long ntasks = (long long)b * h * dil * ceil_div(ceil_div(wd, dil), Tiles::XT);
    if (ntasks >= (1ll << 31)) return {-1, 0, 0, 0, 0};
    const int parts = std::max(1, std::min(Tiles::BLOCKS_PER_SM * sms / groups, ceil_div(ntasks, DW_THREADS / cvb)));
    const int per = ceil_div(ntasks, parts);
    return {DW_CHANNELS_LAST, groups, ceil_div(ntasks, per), log2_floor(cvb), per};
  }
  constexpr int VEC = VecOf<T>::N;
  const int lead = VEC * ceil_div(dil, VEC), rpr = ceil_div(wd, VEC), pitch = 2 * lead + rpr * VEC;
  auto smem = [&](int cg, int rows) { return (long long)cg * ((rows + 2 * dil) * pitch + rows * rpr * VEC) * sizeof(T); };
  int cg = 1, rows = h;
  if ((long long)h * rpr >= Tiles::RUNS) rows = std::min(h, std::max(1, Tiles::RUNS / rpr));
  else cg = std::min({MAX_CG, pow2_at_least(c), 1 << log2_floor(Tiles::RUNS / (h * rpr))});
  while (cg > 1 && smem(cg, rows) > SMEM_MAX) cg /= 2;
  while (rows > 1 && smem(cg, rows) > SMEM_MAX) rows = (rows + 1) / 2;
  if (smem(cg, rows) > SMEM_MAX) return {-1, 0, 0, 0, 0};
  return {DW_PLANES, ceil_div(c, cg), b * ceil_div(h, rows), log2_floor(cg), rows};
}

template <typename T, int DIL, int CPT, int XT>
cudaError_t launch_dw_cl(const T* x, const T* g, float* partial, float* dw, unsigned* tickets, int b, int h, int wd,
                         int c, IStrides sx, IStrides sg, DwPlan p, cudaStream_t stream) {
  const int tiles = ((wd + DIL - 1) / DIL + XT - 1) / XT, ntasks = b * h * DIL * tiles;
  auto vec_ok = [](const void* q, IStrides s) {
    return reinterpret_cast<uintptr_t>(q) % (CPT * sizeof(T)) == 0 && s.b % CPT == 0 && s.h % CPT == 0 &&
           s.w % CPT == 0;
  };
  dim3 grid(p.groups, p.parts);
  auto kernel = c % CPT == 0 && vec_ok(x, sx) && vec_ok(g, sg) ? dw3x3_dw_cl_kernel<T, DIL, CPT, XT, true>
                                                              : dw3x3_dw_cl_kernel<T, DIL, CPT, XT, false>;
  kernel<<<grid, DW_THREADS, 0, stream>>>(x, g, partial, dw, tickets, c, h, wd, p.log_block, tiles, ntasks, p.per,
                                          p.parts, fast_div(tiles), fast_div(h), sx, sg);
  return cudaGetLastError();
}

template <typename T, int DIL>
cudaError_t launch_dw_plane(const T* x, const T* g, float* partial, float* dw, unsigned* tickets, int b, int h,
                            int wd, int c, IStrides sx, IStrides sg, DwPlan p, cudaStream_t stream) {
  constexpr int V = VecOf<T>::N, L = V * ((DIL + V - 1) / V);
  const int rows = p.per, rpr = (wd + V - 1) / V, pitch = 2 * L + rpr * V, cg = 1 << p.log_block;
  const int smem = cg * ((rows + 2 * DIL) * pitch + rows * rpr * V) * (int)sizeof(T);
  dim3 grid(p.groups, p.parts);
  dw3x3_dw_plane_kernel<T, DIL, V><<<grid, DW_THREADS, smem, stream>>>(
      x, g, partial, dw, tickets, c, h, wd, p.log_block, rows, rpr, pitch, p.parts / b, p.parts,
      fast_div(pitch / V), fast_div(rows + 2 * DIL), fast_div(rpr), fast_div(rows), fast_div(rpr),
      fast_div(p.parts / b), sx, sg);
  return cudaGetLastError();
}

// dw on dw_plan's cut; partial holds the plan's parts (unused with one part),
// tickets its groups
template <typename T, class Tiles = DwTiles<T>>
cudaError_t launch_dw(const void* x, const void* g, float* partial, float* dw, unsigned* tickets, int b, int h, int wd,
                      int c, int dil, Strides sx, Strides sg, cudaStream_t stream) {
  if (c == 0) return cudaSuccess;
  if ((long long)b * h * wd == 0) return cudaMemsetAsync(dw, 0, 9 * sizeof(float) * c, stream);
  const DwPlan p = dw_plan<T, Tiles>(b, h, wd, c, dil, sx.c, sg.c);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const IStrides ix = istrides(sx), ig = istrides(sg);
  if (p.route == DW_CHANNELS_LAST) {
    return with_dil(dil, [&](auto d) {
      return launch_dw_cl<T, decltype(d)::value, Tiles::CPT, Tiles::XT>(xt, gt, partial, dw, tickets, b, h, wd, c, ix,
                                                                        ig, p, stream);
    });
  }
  if (p.route == DW_PLANES) {
    return with_dil(dil, [&](auto d) {
      return launch_dw_plane<T, decltype(d)::value>(xt, gt, partial, dw, tickets, b, h, wd, c, ix, ig, p, stream);
    });
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, H, W, C) and out by element strides (sx*, so*); w (3, 3, C) fp32 contiguous.
extern "C" int cenet_depthwise_fwd(int is_bf16, const void* x, const void* w, void* out, int b, int h, int wd, int c,
                                   int dil, long long sxb, long long sxh, long long sxw, long long sxc, long long sob,
                                   long long soh, long long sow, long long soc, void* stream) {
  Strides sx{sxb, sxh, sxw, sxc}, so{sob, soh, sow, soc};
  auto st = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  return is_bf16 ? (int)launch_fwd<__nv_bfloat16>(x, wf, out, b, h, wd, c, dil, sx, so, st)
                 : (int)launch_fwd<float>(x, wf, out, b, h, wd, c, dil, sx, so, st);
}

// dw_plan's route, groups and parts for x, g (B, H, W, C) with channel strides
// sxc, sgc, written to out[0..2]: the wrapper sizes partial and tickets by them.
// Returns cudaErrorInvalidValue where no cut fits.
extern "C" int cenet_depthwise_dw_plan(int is_bf16, int b, int h, int wd, int c, int dil, long long sxc,
                                       long long sgc, int* out) {
  const DwPlan p = is_bf16 ? dw_plan<__nv_bfloat16>(b, h, wd, c, dil, sxc, sgc)
                           : dw_plan<float>(b, h, wd, c, dil, sxc, sgc);
  out[0] = p.route;
  out[1] = p.groups;
  out[2] = p.parts;
  return p.route < 0 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// x, g (B, H, W, C) by element strides; partial (parts, 9, C) fp32 (unused
// with one part) and tickets (groups zeroed counters, left zeroed) as
// cenet_depthwise_dw_plan gives parts and groups; dw (3, 3, C) fp32 contiguous.
extern "C" int cenet_depthwise_dw(int is_bf16, const void* x, const void* g, void* partial, void* dw, void* tickets,
                                  int b, int h, int wd, int c, int dil, long long sxb, long long sxh, long long sxw,
                                  long long sxc, long long sgb, long long sgh, long long sgw, long long sgc,
                                  void* stream) {
  Strides sx{sxb, sxh, sxw, sxc}, sg{sgb, sgh, sgw, sgc};
  auto st = static_cast<cudaStream_t>(stream);
  auto pf = static_cast<float*>(partial);
  auto df = static_cast<float*>(dw);
  auto tk = static_cast<unsigned*>(tickets);
  return is_bf16 ? (int)launch_dw<__nv_bfloat16>(x, g, pf, df, tk, b, h, wd, c, dil, sx, sg, st)
                 : (int)launch_dw<float>(x, g, pf, df, tk, b, h, wd, c, dil, sx, sg, st);
}
