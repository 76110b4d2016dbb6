// Depthwise 3x3 convolution, stride 1, padding = dilation (shape-preserving):
// the forward, and the weight gradient dw summed over batch and space.
//
// Replaces tools/negative_results/depthwise.py::_pallas_depthwise_fwd (body
// _fwd_kernel) and _pallas_depthwise_dw (body _dw_kernel). The backward's dx is
// the forward on the upstream gradient with the spatially flipped kernel, as
// _dp_bwd does, so it needs no kernel of its own.
//
// Bound: bytes. Nine multiply-adds per output element against one element
// read and one written: the only gain is to move each byte once at full
// width. The TPU kernel keeps a whole padded (H, W, C) map in VMEM. Both
// kernels take element strides on every dim of x, g and the output, so the
// model's NCHW tensors arrive as permute(0, 2, 3, 1) views without a copy.
//
// Forward, one design for both dtypes in two layouts, dilations 1-5 (a
// template argument), all index arithmetic in 32 bits with divisions by
// multiply-high (the wrapper checks that every offset fits):
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
// dw sums over the batch and the map. On the TPU the sequential grid carries
// that sum in the output block (_dw_kernel's "+="); blocks on the card run in
// no order, so here it is two passes: each block sums the products of one
// slice of positions for its channels into a partial (a fixed tree inside
// the block), and a second kernel adds the partials of each (tap, channel) in
// order. No atomics: repeat runs are bit-identical.
//
// Numerics as the Pallas bodies: x (or g) in its dtype, the taps in fp32, the
// sum in fp32 over the taps in (dy, dx) order (taps outside the map add
// zero), one rounding to the output's dtype; dw in fp32. Every output element
// is written by one thread: repeat runs are bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

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
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t word = (&v.x)[e >> 1];
    return __uint_as_float((e & 1 ? word >> 16 : word & 0xffffu) << 16);
  } else {
    return __uint_as_float((&v.x)[e]);
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
    const int yy = r0 - DIL + sr, col0 = v * VEC - L;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (xbase[p] >= 0 && yy >= 0 && yy < h && col0 + VEC > 0 && col0 < wd) {
      const T* src = x + xbase[p] + yy * sx.h + col0 * sx.w;
      const bool inside = sx.w == 1 && col0 >= 0 && col0 + VEC <= wd;
      if (inside && aligned16(src)) {
        val = *reinterpret_cast<const uint4*>(src);
      } else if (sizeof(T) == 2 && inside && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) (&val.x)[e] = reinterpret_cast<const uint32_t*>(src)[e];
      } else {
        T* ev = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (col0 + e >= 0 && col0 + e < wd) ev[e] = src[e * sx.w];
      }
    }
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

constexpr int DW_THREADS = 256;

// Pass 1: block (channel group, part). CPB channels per block, DW_THREADS / CPB
// lanes per channel walking the part's positions; a fixed tree over the lanes.
template <typename T, int CPB>
__global__ void depthwise_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                            float* __restrict__ partial, int h, int wd, int c, int dil, Strides sx,
                                            Strides sg, long long npos, long long per) {
  constexpr int LANES = DW_THREADS / CPB;
  __shared__ float red[9][DW_THREADS];
  const int tid = threadIdx.x;
  const int cl = tid % CPB, lane = tid / CPB;
  const int ch = blockIdx.x * CPB + cl;
  const long long start = (long long)blockIdx.y * per;
  const long long end = min(npos, start + per);
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  if (ch < c) {
    for (long long pos = start + lane; pos < end; pos += LANES) {
      const int col = (int)(pos % wd);
      const long long r = pos / wd;
      const int row = (int)(r % h);
      const long long b = r / h;
      const float gv = to_f(g[b * sg.b + row * sg.h + col * sg.w + ch * sg.c]);
      const T* xb = x + b * sx.b + ch * sx.c;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = row + (dy - 1) * dil;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = col + (dx - 1) * dil;
          if (yy >= 0 && yy < h && xx >= 0 && xx < wd) acc[dy * 3 + dx] += to_f(xb[yy * sx.h + xx * sx.w]) * gv;
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) red[t][tid] = acc[t];
  __syncthreads();
  for (int s = LANES / 2; s > 0; s >>= 1) {
    if (lane < s) {
#pragma unroll
      for (int t = 0; t < 9; ++t) red[t][tid] += red[t][tid + s * CPB];
    }
    __syncthreads();
  }
  if (lane == 0 && ch < c) {
#pragma unroll
    for (int t = 0; t < 9; ++t) partial[((long long)blockIdx.y * 9 + t) * c + ch] = red[t][tid];
  }
}

// Pass 2: dw[t, ch] = sum over parts, in order.
__global__ void depthwise_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int n, int parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(long long)p * n + i];
  dw[i] = s;
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

inline IStrides istrides(Strides s) { return {(int)s.b, (int)s.h, (int)s.w, (int)s.c}; }

template <typename T, int DIL, int V>
cudaError_t launch_plane(const T* x, const float* w, T* out, int b, int h, int wd, int c, Strides sx, Strides so,
                         int target_runs, cudaStream_t stream) {
  constexpr int VEC = VecOf<T>::N, L = VEC * ((DIL + VEC - 1) / VEC);
  const int rpr = (wd + V - 1) / V, pitch = 2 * L + rpr * V, nplanes = b * c;
  int rows = h, np = 1;
  if (rpr * h <= target_runs) np = std::min(MAX_PLANES, std::max(1, target_runs / (rpr * h)));
  else rows = std::max(1, target_runs / rpr);
  constexpr int SMEM_MAX = 40 * 1024;  // of the 48 KB a launch takes without opting in, beside the static arrays
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

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, float* partial, float* dw, int b, int h, int wd, int c, int dil,
                      Strides sx, Strides sg, int parts, cudaStream_t stream) {
  const long long npos = (long long)b * h * wd;
  const long long per = (npos + parts - 1) / parts;
  if (sx.c == 1) {
    dim3 grid((c + 31) / 32, parts);
    depthwise_dw_partial_kernel<T, 32><<<grid, DW_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), partial, h, wd, c, dil, sx, sg, npos, per);
  } else {
    dim3 grid(c, parts);
    depthwise_dw_partial_kernel<T, 1><<<grid, DW_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), partial, h, wd, c, dil, sx, sg, npos, per);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * c;
  depthwise_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, dw, n, parts);
  return cudaGetLastError();
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

// x, g (B, H, W, C) by element strides; partial (parts, 9, C) fp32 scratch;
// dw (3, 3, C) fp32 contiguous.
extern "C" int cenet_depthwise_dw(int is_bf16, const void* x, const void* g, void* partial, void* dw, int b, int h,
                                  int wd, int c, int dil, long long sxb, long long sxh, long long sxw, long long sxc,
                                  long long sgb, long long sgh, long long sgw, long long sgc, int parts, void* stream) {
  Strides sx{sxb, sxh, sxw, sxc}, sg{sgb, sgh, sgw, sgc};
  auto st = static_cast<cudaStream_t>(stream);
  auto pf = static_cast<float*>(partial);
  auto df = static_cast<float*>(dw);
  return is_bf16 ? (int)launch_dw<__nv_bfloat16>(x, g, pf, df, b, h, wd, c, dil, sx, sg, parts, st)
                 : (int)launch_dw<float>(x, g, pf, df, b, h, wd, c, dil, sx, sg, parts, st);
}
