// Stride-1 KxK convolution with SAME padding (K odd, 3-7) for small channel
// counts: the forward, and the backward's dx and dw.
//
// Replaces tools/negative_results/smallc_conv.py::_pallas_conv_fwd (body
// _fwd_kernel) and _pallas_conv_bwd (body _bwd_kernel, dx and dw together).
//
// Bound: operations. 2*K*K*Cin*Cout FLOPs per output pixel against
// (Cin + Cout) elements moved; at the OutHead sites (K = 5, 32 -> 32 at 224^2;
// K = 3, 64 -> 32 and 64 -> 64 at 112^2) that is 200-575 FLOPs per byte, above
// the card's line. The TPU kernel packs taps along the contraction so that
// 32-lane data fills 128-lane MXU passes; that is MXU lane economics and
// does not carry over.
//
// Forward, two designs chosen by dtype (both hand-written; neither stands in
// for the other on failure):
//   bf16  an implicit GEMM on the tensor cores (conv_fwd_tc_kernel,
//         mma.sync.m16n8k16, bf16 operands, fp32 sums): M = the output pixels
//         of a 16 x 16 tile (8 warps, each 2 rows of 16 pixels), N = NT = 32
//         or 64 output channels, the contraction over (tap, Cin). The block
//         stages its bf16 halo patch pixel-major, each pixel's Cin channels
//         contiguous at a padded pitch, so an A fragment's rows are 16-byte
//         ldmatrix rows at any tap shift (at Cin = 8 one 16-deep step takes
//         two taps: its two column halves come from two pixel rows). The
//         weights (K, K, Cin, Cout) are read as rows r = tap * Cin + ci and
//         streamed in chunks of 64 rows through three shared buffers by
//         cp.async, as B fragments (ldmatrix.trans); the padding rows of the
//         last chunk are zeros and their A rows a zero row. Staging the patch
//         transposes NCHW views on the way in: threads run along W of each
//         channel plane (coalesced) and store channel pairs into pixel rows;
//         channels-last maps with 16-byte aligned pixels go by 16-byte cp.async.
//   fp32  a direct convolution on CUDA cores (conv_fwd_kernel), the first
//         version: a block takes a 16x16 tile of output pixels and 32 output
//         channels; it stages the input patch with its halo (zero outside the
//         map) and the weights of CI input channels at a time in shared
//         memory, and each thread keeps the 32 fp32 sums of one pixel in
//         registers. The tensor cores take fp32 only as TF32, which would
//         break the fp32 kernel's 1e-4 agreement with its twin.
//
// Backward, dx = the forward on the upstream gradient g with the flipped,
// in/out-swapped weights W' (valid because padding = K/2), and dw:
//   bf16  dx by conv_fwd_tc_kernel on g with W' where Cout (its contraction's
//         channels) is 8, 16, 32 or 64, else by the CUDA-core dx blocks (a
//         shape rule); dw by conv_dw_tc_kernel, an implicit GEMM on the tensor
//         cores: dW[(tap, ci), co] = sum over the batch's pixels of
//         x_shift(tap)[p, ci] * g[p, co], M = K*K*Cin rows, N = Cout, the
//         contraction over pixels. Both kernels read x and g channels-last:
//         NCHW views are first copied so by to_channels_last_kernel (a dw
//         kernel that transposed NCHW views inside its blocks with 2-byte
//         loads took 0.92-0.94 ms at rb.0.conv2 at batch 8; on channels-last
//         inputs with a cp.async pipeline it takes 0.17, time_tilings
//         k12bwd). A dw block takes a slice of the m
//         blocks and a slice of the pixel tiles (8 x 16); while it computes
//         one tile, the next tile's x halo patch (pixel-major at the forward's
//         channel pitch) and g tile [pixel][co] arrive by 16-byte cp.async
//         into the other of two shared stages. A (rows (tap, ci) by 16 pixels)
//         comes from the patch and B (16 pixels by co) from the g tile, both by
//         ldmatrix.trans; each tile's mma sums go into the block's fp32
//         running sums by plain adds. Launches: the copies, dx, dw, the sum.
//   fp32  one launch with two kinds of CUDA-core blocks: dx blocks (the fp32
//         forward's tile code on g with W') and dw blocks (a block owns 8
//         input x 32 output channels, each thread one (ci, co) pair with its
//         K*K sums, walking a slice of 8x16 pixel tiles of the batch).
// The TPU kernel carries dw in a grid-constant output block; blocks on the
// card run in no order, so each dw block writes its partial sums and a second
// small kernel adds the partials of every weight in order: no atomics, repeat
// runs are bit-identical.
//
// Numerics as the Pallas bodies: x (g) in its dtype, the weights rounded to
// x's dtype by the wrapper (the JAX wrapper packs them in x's dtype; stored
// as bf16 for the tensor-core forward and dx, as fp32 elsewhere), products and sums
// in fp32, one rounding of each output to x's dtype; dw in fp32. x, g and the
// outputs are read and written through element strides on every dim (NHWC
// shapes), so NCHW tensors arrive as permuted views without a copy. Every
// output element is written by one block: repeat runs are bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

struct Strides {
  long long b, h, w, c;
};

constexpr int THREADS = 256;
constexpr int TILE = 16;     // conv tile: TILE x TILE output pixels
constexpr int CO_T = 32;     // output channels per block
constexpr int DW_CI = 8;     // dw block: input channels
constexpr int DW_TH = 8;     // dw tile: DW_TH x DW_TW pixels
constexpr int DW_TW = 16;
constexpr int GS_LD = CO_T + 1;  // padded row of the staged g tile

template <int K>
struct Cfg {
  static constexpr int CI = K <= 5 ? 8 : 4;  // input channels staged per step
  static constexpr int P = TILE + K - 1;
  static constexpr int FWD_SMEM = CI * P * P + K * K * CI * CO_T;
  static constexpr int PH = DW_TH + K - 1, PW = DW_TW + K - 1;
  static constexpr int DW_SMEM = DW_CI * PH * PW + DW_TH * DW_TW * GS_LD;
  static constexpr int SMEM = FWD_SMEM > DW_SMEM ? FWD_SMEM : DW_SMEM;
};

// out[b, y0:y0+16, x0:x0+16, co0:co0+32] = conv(x, w) on one tile. w: fp32
// (K, K, cin, cout) contiguous. cin % Cfg<K>::CI == 0.
template <typename T, int K>
__device__ void conv_tile(float* smem, const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                          long long b, int y0, int x0, int co0, int h, int wd, int cin, int cout, Strides sx,
                          Strides so) {
  constexpr int CI = Cfg<K>::CI, P = Cfg<K>::P, PAD = K / 2;
  float* xs = smem;               // [CI][P][P]
  float* ws = smem + CI * P * P;  // [K*K][CI][CO_T], 16-byte aligned (CI*P*P is a multiple of 4)
  const int t = threadIdx.x, py = t / TILE, px = t % TILE;
  float acc[CO_T];
#pragma unroll
  for (int i = 0; i < CO_T; ++i) acc[i] = 0.f;
  const T* xb = x + b * sx.b;
  for (int ci0 = 0; ci0 < cin; ci0 += CI) {
    __syncthreads();
    for (int i = t; i < CI * P * P; i += THREADS) {
      int ci, yy, xx;
      if (sx.c == 1) {
        ci = i % CI; const int r = i / CI; xx = r % P; yy = r / P;
      } else {
        xx = i % P; const int r = i / P; yy = r % P; ci = r / P;
      }
      const int gy = y0 + yy - PAD, gx = x0 + xx - PAD;
      xs[(ci * P + yy) * P + xx] =
          (gy >= 0 && gy < h && gx >= 0 && gx < wd) ? to_f(xb[gy * sx.h + gx * sx.w + (ci0 + ci) * sx.c]) : 0.f;
    }
    for (int i = t; i < K * K * CI * CO_T; i += THREADS) {
      const int co = i % CO_T, ci = (i / CO_T) % CI, tap = i / (CO_T * CI);
      ws[i] = co0 + co < cout ? w[((long long)tap * cin + ci0 + ci) * cout + co0 + co] : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < CI; ++ci) {
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float xv = xs[(ci * P + py + ky) * P + px + kx];
          const float4* wr = reinterpret_cast<const float4*>(ws + ((ky * K + kx) * CI + ci) * CO_T);
#pragma unroll
          for (int q = 0; q < CO_T / 4; ++q) {
            const float4 wv = wr[q];
            acc[4 * q] += xv * wv.x;
            acc[4 * q + 1] += xv * wv.y;
            acc[4 * q + 2] += xv * wv.z;
            acc[4 * q + 3] += xv * wv.w;
          }
        }
      }
    }
  }
  const int y = y0 + py, xq = x0 + px;
  if (y < h && xq < wd) {
    T* ob = out + b * so.b + (long long)y * so.h + (long long)xq * so.w;
#pragma unroll
    for (int co = 0; co < CO_T; ++co)
      if (co0 + co < cout) ob[(co0 + co) * so.c] = from_f<T>(acc[co]);
  }
}

// Partial dw of input channels ci0..ci0+8 and output channels co0..co0+32 over
// the 8x16 pixel tiles [tile_begin, tile_end) of the batch, written to
// partial[part] as (K, K, cin, cout).
template <typename T, int K>
__device__ void dw_part(float* smem, const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
                        int part, int ci0, int co0, long long tile_begin, long long tile_end, int tiles_y,
                        int tiles_x, int h, int wd, int cin, int cout, Strides sx, Strides sg) {
  constexpr int PH = Cfg<K>::PH, PW = Cfg<K>::PW, PAD = K / 2;
  float* xs = smem;                      // [DW_CI][PH][PW]
  float* gs = smem + DW_CI * PH * PW;    // [DW_TH * DW_TW][GS_LD]
  const int t = threadIdx.x, cil = t / CO_T, col = t % CO_T;
  float acc[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) acc[i] = 0.f;
  for (long long tile = tile_begin; tile < tile_end; ++tile) {
    const int tx = (int)(tile % tiles_x);
    const long long r = tile / tiles_x;
    const int ty = (int)(r % tiles_y);
    const long long b = r / tiles_y;
    const int y0 = ty * DW_TH, x0 = tx * DW_TW;
    __syncthreads();
    for (int i = t; i < DW_CI * PH * PW; i += THREADS) {
      int ci, yy, xx;
      if (sx.c == 1) {
        ci = i % DW_CI; const int rr = i / DW_CI; xx = rr % PW; yy = rr / PW;
      } else {
        xx = i % PW; const int rr = i / PW; yy = rr % PH; ci = rr / PH;
      }
      const int gy = y0 + yy - PAD, gx = x0 + xx - PAD;
      xs[(ci * PH + yy) * PW + xx] = (gy >= 0 && gy < h && gx >= 0 && gx < wd)
                                         ? to_f(x[b * sx.b + gy * sx.h + gx * sx.w + (ci0 + ci) * sx.c])
                                         : 0.f;
    }
    for (int i = t; i < DW_TH * DW_TW * CO_T; i += THREADS) {
      int co, pix;
      if (sg.c == 1) {
        co = i % CO_T; pix = i / CO_T;
      } else {
        pix = i % (DW_TH * DW_TW); co = i / (DW_TH * DW_TW);
      }
      const int y = y0 + pix / DW_TW, xq = x0 + pix % DW_TW;
      gs[pix * GS_LD + co] = (y < h && xq < wd && co0 + co < cout)
                                 ? to_f(g[b * sg.b + y * sg.h + xq * sg.w + (co0 + co) * sg.c])
                                 : 0.f;
    }
    __syncthreads();
    for (int pix = 0; pix < DW_TH * DW_TW; ++pix) {
      const float gv = gs[pix * GS_LD + col];
      const int py = pix / DW_TW, px = pix % DW_TW;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) acc[ky * K + kx] += xs[(cil * PH + py + ky) * PW + px + kx] * gv;
      }
    }
  }
  if (co0 + col < cout) {
    const long long n = (long long)K * K * cin * cout;
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap)
      partial[part * n + ((long long)tap * cin + ci0 + cil) * cout + co0 + col] = acc[tap];
  }
}

// The fp32 forward (bf16 runs conv_fwd_tc_kernel)
template <int K>
__global__ void __launch_bounds__(THREADS) conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                                           float* __restrict__ out, int h, int wd, int cin, int cout,
                                                           int tiles_x, Strides sx, Strides so) {
  __shared__ __align__(16) float smem[Cfg<K>::FWD_SMEM];
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  conv_tile<float, K>(smem, x, w, out, blockIdx.z, ty * TILE, tx * TILE, blockIdx.y * CO_T, h, wd, cin, cout, sx, so);
}

// Blocks [0, n_dx) compute dx tiles, the rest dw partials.
template <typename T, int K>
__global__ void __launch_bounds__(THREADS) conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                                           const float* __restrict__ wf, T* __restrict__ dx,
                                                           float* __restrict__ partial, int h, int wd, int cin,
                                                           int cout, int nb, Strides sx, Strides sg, Strides sdx,
                                                           int n_dx, long long per) {
  __shared__ __align__(16) float smem[Cfg<K>::SMEM];
  if ((int)blockIdx.x < n_dx) {
    int i = blockIdx.x;
    const int tiles_x = (wd + TILE - 1) / TILE, tiles_y = (h + TILE - 1) / TILE, co_tiles = (cin + CO_T - 1) / CO_T;
    const int tx = i % tiles_x; i /= tiles_x;
    const int ty = i % tiles_y; i /= tiles_y;
    const int ct = i % co_tiles;
    const int b = i / co_tiles;
    // dx = conv(g, wf): cout channels in, cin out
    conv_tile<T, K>(smem, g, wf, dx, b, ty * TILE, tx * TILE, ct * CO_T, h, wd, cout, cin, sg, sdx);
  } else {
    int i = blockIdx.x - n_dx;
    const int co_tiles = (cout + CO_T - 1) / CO_T, ci_chunks = cin / DW_CI;
    const int ct = i % co_tiles; i /= co_tiles;
    const int cc = i % ci_chunks;
    const int part = i / ci_chunks;
    const int tiles_x = (wd + DW_TW - 1) / DW_TW, tiles_y = (h + DW_TH - 1) / DW_TH;
    const long long total = (long long)nb * tiles_y * tiles_x;
    const long long begin = part * per, end = begin + per < total ? begin + per : total;
    dw_part<T, K>(smem, x, g, partial, part, cc * DW_CI, ct * CO_T, begin, end, tiles_y, tiles_x, h, wd, cin, cout,
                  sx, sg);
  }
}

__global__ void sum_parts_kernel(const float* __restrict__ partial, float* __restrict__ out, long long n, int parts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[p * n + i];
  out[i] = s;
}

template <int K>
cudaError_t fwd(const void* x, const float* w, void* out, int b, int h, int wd, int cin, int cout, Strides sx,
                Strides so, cudaStream_t stream) {
  const int tiles_x = (wd + TILE - 1) / TILE, tiles_y = (h + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, (cout + CO_T - 1) / CO_T, b);
  conv_fwd_kernel<K><<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x), w, static_cast<float*>(out), h, wd,
                                                   cin, cout, tiles_x, sx, so);
  return cudaGetLastError();
}

// The CUDA-core backward: the dx blocks, then (parts > 0) the dw blocks of
// `parts` slices of the pixel tiles
template <typename T, int K>
cudaError_t bwd(const void* x, const void* g, const float* wf, void* dx, float* partial, int b, int h, int wd,
                int cin, int cout, Strides sx, Strides sg, Strides sdx, int parts, cudaStream_t stream) {
  const int n_dx = ((wd + TILE - 1) / TILE) * ((h + TILE - 1) / TILE) * ((cin + CO_T - 1) / CO_T) * b;
  const long long tiles = (long long)b * ((h + DW_TH - 1) / DW_TH) * ((wd + DW_TW - 1) / DW_TW);
  const long long per = parts > 0 ? (tiles + parts - 1) / parts : 0;
  const int n_dw = parts * ((cout + CO_T - 1) / CO_T) * (cin / DW_CI);
  conv_bwd_kernel<T, K><<<n_dx + n_dw, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), wf, static_cast<T*>(dx), partial, h, wd, cin, cout, b, sx,
      sg, sdx, n_dx, per);
  return cudaGetLastError();
}

// dw = the sum of the parts' partials, in order
cudaError_t sum_parts(const float* partial, float* dw, long long n, int parts, cudaStream_t stream) {
  sum_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, dw, n, parts);
  return cudaGetLastError();
}

cudaError_t fwd_k(int k, const void* x, const float* w, void* out, int b, int h, int wd, int cin, int cout, Strides sx,
                  Strides so, cudaStream_t st) {
  switch (k) {
    case 3: return fwd<3>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    case 5: return fwd<5>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    case 7: return fwd<7>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_k(int k, const void* x, const void* g, const float* wf, void* dx, float* partial, int b, int h,
                  int wd, int cin, int cout, Strides sx, Strides sg, Strides sdx, int parts, cudaStream_t st) {
  switch (k) {
    case 3: return bwd<T, 3>(x, g, wf, dx, partial, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
    case 5: return bwd<T, 5>(x, g, wf, dx, partial, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
    case 7: return bwd<T, 7>(x, g, wf, dx, partial, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores
// ---------------------------------------------------------------------------

namespace tc = cenet::tc;
using bf16 = __nv_bfloat16;

// A block's tiling: NW warps of MB 16-pixel rows (m blocks) each, so an output
// tile of TH = NW * MB rows of TW = 16 pixels; the weights streamed in chunks
// of KC contraction rows through STAGES shared buffers.
template <int NW_, int MB_, int KC_, int STAGES_>
struct ConvTiles {
  static constexpr int NW = NW_, MB = MB_, KC = KC_, STAGES = STAGES_;
  static constexpr int TW = 16, TH = NW * MB, THREADS = 32 * NW;
  static_assert(KC % 16 == 0 && STAGES >= 2, "whole 16-deep steps; one chunk in flight while one is used");
};

template <int K, int CIN, int NT, class C>
struct TcCfg {
  // a pixel's channels at a padded pitch, so that 8 consecutive pixels (the
  // rows of one ldmatrix tile) fall on distinct banks
  static constexpr int CP = CIN == 8 ? 24 : CIN + 8;
  static constexpr int PH = C::TH + K - 1, PW = C::TW + K - 1;
  static constexpr int NTP = NT + 8;        // a weight row's pitch (ldmatrix.trans rows on distinct banks)
  static constexpr int ROWS = K * K * CIN;  // the contraction: row tap * CIN + ci
  static constexpr int CHUNKS = (ROWS + C::KC - 1) / C::KC;
  static constexpr int PATCH = PH * PW * CP + 8;  // and one zero row
  static constexpr int SMEM = 2 * (PATCH + C::STAGES * C::KC * NTP);
  static_assert(CIN % 8 == 0 && NT % 16 == 0, "8-channel ldmatrix rows, n blocks in pairs");
};

// out[b, y0 .. y0+TH-1, x0 .. x0+15, n0 .. n0+NT-1] = conv(x, w) on one tile.
// x bf16 by element strides; w bf16 (K, K, CIN, cout) contiguous, 16-byte
// aligned, cout % 8 == 0. vec_x: channels-last with 16-byte aligned pixels;
// vec_o: channels-last with 4-byte aligned channel pairs.
template <int K, int CIN, int NT, class C>
__global__ void __launch_bounds__(C::THREADS) conv_fwd_tc_kernel(const bf16* __restrict__ x,
                                                                 const bf16* __restrict__ w, bf16* __restrict__ out,
                                                                 int h, int wd, int cout, int tiles_x, Strides sx,
                                                                 Strides so, int vec_x, int vec_o) {
  using Cf = TcCfg<K, CIN, NT, C>;
  constexpr int CP = Cf::CP, PH = Cf::PH, PW = Cf::PW, NTP = Cf::NTP, PAD = K / 2, NB = NT / 8;
  constexpr int MB = C::MB, KC = C::KC, S = C::STAGES, NTH = C::THREADS;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  bf16* Ps = reinterpret_cast<bf16*>(conv_smem);  // [PH][PW][CP], then the zero row
  bf16* Ws = Ps + Cf::PATCH;                      // [S][KC][NTP]
  bf16* zero_row = Ps + PH * PW * CP;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int y0 = (blockIdx.x / tiles_x) * C::TH, x0 = (blockIdx.x % tiles_x) * C::TW, n0 = blockIdx.y * NT;
  const bf16* xb = x + blockIdx.z * sx.b;

  // weight chunk s (rows s * KC ..) into buffer s % S by cp.async; zeros past
  // the last row and past cout
  auto stage = [&](int s) {
    constexpr int CH = NT / 8;
    bf16* buf = Ws + (s % S) * KC * NTP;
    for (int i = threadIdx.x; i < KC * CH; i += NTH) {
      const int r = i / CH, c = (i % CH) * 8, row = s * KC + r;
      bf16* dst = buf + r * NTP + c;
      if (row < Cf::ROWS && n0 + c < cout) tc::cp_async16(dst, w + (long long)row * cout + n0 + c);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // one commit group per chunk, empty past the last
  auto issue = [&](int s) {
    if (s < Cf::CHUNKS) stage(s);
    tc::cp_async_commit();
  };

  // chunk 0's copies first, so that they fly while the patch is staged; the
  // patch's own copies (channels-last) join chunk 0's group
  stage(0);
  if (vec_x) {
    constexpr int CH = CIN / 8;
    for (int i = threadIdx.x; i < PH * PW * CH; i += NTH) {
      const int c = (i % CH) * 8, pix = i / CH, gy = y0 + pix / PW - PAD, gx = x0 + pix % PW - PAD;
      bf16* dst = Ps + pix * CP + c;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) tc::cp_async16(dst, xb + gy * sx.h + gx * sx.w + c);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {  // any strides (NCHW views: consecutive threads along W of a channel plane)
#pragma unroll 4
    for (int i = threadIdx.x; i < PH * PW * (CIN / 2); i += NTH) {
      const int xx = i % PW, r = i / PW, yy = r % PH, c = 2 * (r / PH);
      const int gy = y0 + yy - PAD, gx = x0 + xx - PAD;
      uint32_t v = 0u;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        const bf16* src = xb + gy * sx.h + gx * sx.w + c * sx.c;
        v = (uint32_t)__bfloat16_as_ushort(src[0]) | ((uint32_t)__bfloat16_as_ushort(src[sx.c]) << 16);
      }
      *reinterpret_cast<uint32_t*>(Ps + (yy * PW + xx) * CP + c) = v;
    }
  }
  if (threadIdx.x < 2) reinterpret_cast<uint2*>(zero_row)[threadIdx.x] = make_uint2(0u, 0u);
  tc::cp_async_commit();
#pragma unroll
  for (int s = 1; s < S - 1; ++s) issue(s);

  float acc[MB][NB][4] = {};
  const int pix = lane & 15, half = lane >> 4;  // this lane's A row (pixel) and column half
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * NTP + (lane >> 4) * 8;
  const bf16* a_base = Ps + (warp * MB * PW + pix) * CP;
  for (int s = 0; s < Cf::CHUNKS; ++s) {
    tc::cp_async_wait<S - 2>();  // chunk s (and at s = 0 the patch) has landed
    __syncthreads();             // ... for every thread, and chunk s - 1's buffer is free
    issue(s + S - 1);
    const bf16* wb = Ws + (s % S) * KC * NTP + b_off;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // this lane's 8 contraction rows: tap r / CIN, channels r % CIN .. + 7
      const int r = s * KC + kk * 16 + half * 8, tap = r / CIN;
      const bool real = tap < K * K;
      const bf16* a_row = real ? a_base + ((tap / K) * PW + tap % K) * CP + r % CIN : zero_row;
      const int a_step = real ? PW * CP : 0;  // the next m block: one output row down
      uint32_t bf[NB / 2][4];
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) tc::ldsm_x4_trans(bf[n2], wb + kk * 16 * NTP + n2 * 16);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        uint32_t a[4];
        tc::ldsm_x4(a, a_row + mb * a_step);
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          tc::mma_bf16(acc[mb][2 * n2], a, bf[n2][0], bf[n2][1]);
          tc::mma_bf16(acc[mb][2 * n2 + 1], a, bf[n2][2], bf[n2][3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  // rows g, g + 8 of each m block are pixels x0 + g, x0 + g + 8 of output row
  // y0 + warp * MB + mb; columns n0 + 8 nb + 2t, + 1 are output channels
  bf16* ob = out + blockIdx.z * so.b;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int y = y0 + warp * MB + mb;
    if (y >= h) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int co = n0 + nb * 8 + 2 * t;
      if (co >= cout) continue;  // cout % 8 == 0: co + 1 < cout too
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int xq = x0 + g + 8 * i;
        if (xq >= wd) continue;
        bf16* o = ob + y * so.h + xq * so.w + co * so.c;
        const float v0 = acc[mb][nb][2 * i], v1 = acc[mb][nb][2 * i + 1];
        if (vec_o) {
          *reinterpret_cast<uint32_t*>(o) = tc::pack_bf16(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          o[so.c] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// The tiling launched: 8 warps of 2 pixel rows ran 4-14% faster than 4 warps
// of 4 at the OutHead shapes; the chunk size (64 or 128 rows) and the chunks
// in flight (2 or 3) moved little (PERF.md; timed with
// cenet_tpu_torch/tools/time_tilings.py)
using ConvFwdTiles = ConvTiles<8, 2, 64, 3>;

inline int vec_in(const void* x, Strides sx) {
  return sx.c == 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && sx.b % 8 == 0 && sx.h % 8 == 0 && sx.w % 8 == 0;
}
inline int vec_out(const void* out, Strides so) {
  return so.c == 1 && reinterpret_cast<uintptr_t>(out) % 4 == 0 && so.b % 2 == 0 && so.h % 2 == 0 && so.w % 2 == 0;
}

template <int K, int CIN, int NT, class C = ConvFwdTiles>
cudaError_t fwd_tc(const void* x, const void* w, void* out, int b, int h, int wd, int cout, Strides sx, Strides so,
                   cudaStream_t stream) {
  using Cf = TcCfg<K, CIN, NT, C>;
  if (cout % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorInvalidValue;
  auto kernel = conv_fwd_tc_kernel<K, CIN, NT, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + C::TW - 1) / C::TW, tiles_y = (h + C::TH - 1) / C::TH;
  dim3 grid(tiles_x * tiles_y, (cout + NT - 1) / NT, b);
  kernel<<<grid, C::THREADS, Cf::SMEM, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                                 static_cast<bf16*>(out), h, wd, cout, tiles_x, sx, so, vec_in(x, sx),
                                                 vec_out(out, so));
  return cudaGetLastError();
}

// NT = 32 output channels a block up to cout = 32, else 64
template <int K, int CIN>
cudaError_t fwd_tc_n(const void* x, const void* w, void* out, int b, int h, int wd, int cout, Strides sx, Strides so,
                     cudaStream_t st) {
  return cout <= 32 ? fwd_tc<K, CIN, 32>(x, w, out, b, h, wd, cout, sx, so, st)
                    : fwd_tc<K, CIN, 64>(x, w, out, b, h, wd, cout, sx, so, st);
}

template <int K>
cudaError_t fwd_tc_c(const void* x, const void* w, void* out, int b, int h, int wd, int cin, int cout, Strides sx,
                     Strides so, cudaStream_t st) {
  switch (cin) {
    case 8: return fwd_tc_n<K, 8>(x, w, out, b, h, wd, cout, sx, so, st);
    case 16: return fwd_tc_n<K, 16>(x, w, out, b, h, wd, cout, sx, so, st);
    case 32: return fwd_tc_n<K, 32>(x, w, out, b, h, wd, cout, sx, so, st);
    case 64: return fwd_tc_n<K, 64>(x, w, out, b, h, wd, cout, sx, so, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t fwd_tc_k(int k, const void* x, const void* w, void* out, int b, int h, int wd, int cin, int cout,
                     Strides sx, Strides so, cudaStream_t st) {
  switch (k) {
    case 3: return fwd_tc_c<3>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    case 5: return fwd_tc_c<5>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    case 7: return fwd_tc_c<7>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bf16 weight gradient on the tensor cores
// ---------------------------------------------------------------------------

// A dw block's tiling: NW warps of MBW m blocks (16 rows (tap, ci) of dW)
// each; pixel tiles of TH rows of 16 pixels.
template <int NW_, int MBW_, int TH_>
struct DwTiles {
  static constexpr int NW = NW_, MBW = MBW_, TH = TH_, TW = 16, THREADS = 32 * NW, MBLOCKS = NW * MBW;
};

template <int K, int CIN, int NT, class D>
struct DwCfg {
  static constexpr int CP = CIN == 8 ? 24 : CIN + 8;  // the forward's patch pitch
  static constexpr int PH = D::TH + K - 1, PW = D::TW + K - 1;
  static constexpr int NTP = NT + 8;  // a g tile row's pitch (ldmatrix.trans rows on distinct banks)
  static constexpr int M = K * K * CIN;
  static constexpr int MBT = (M + 15) / 16;  // m blocks of dW
  static constexpr int STAGE = PH * PW * CP + D::TH * D::TW * NTP;  // one tile's patch and g tile
  static constexpr int SMEM = 2 * 2 * STAGE;                        // two stages, bf16
};

// partial[part][(tap, ci), n0 .. n0+NT-1] = Σ over the pixels p of the tiles
// [part * per, (part + 1) * per) of x_shift(tap)[p, ci] · g[p, co]: an implicit
// GEMM with M = K * K * CIN rows (tap, ci), N = cout and the contraction over
// the batch's pixels. x and g are channels-last with 16-byte aligned pixels
// (the entry point transposes other layouts first). The block takes the m
// blocks [blockIdx.y * mb_per_slice, ...) and walks its pixel tiles through
// two shared stages: while it computes one tile, the next tile's x halo patch
// (pixel-major at the forward's channel pitch) and g tile [pixel][co] arrive
// by 16-byte cp.async. Each warp, for each 16-pixel row of the tile, reads the
// row's B fragments (16 pixels x co) from the g tile and, for each of its m
// blocks, the A fragment (16 rows (tap, ci) x the same 16 pixels, shifted by
// the tap) from the patch, both by ldmatrix.trans. A tile's products are
// summed by mma in fresh accumulators, which are then added to the block's
// running sums by fp32 adds: the tensor cores' own accumulation is not
// rounded to nearest, and chains of a few hundred of its steps drift, while a
// tile's chain is TH steps.
template <int K, int CIN, int NT, class D>
__global__ void __launch_bounds__(D::THREADS) conv_dw_tc_kernel(const bf16* __restrict__ x,
                                                                const bf16* __restrict__ g,
                                                                float* __restrict__ partial, int h, int wd, int cout,
                                                                int tiles_y, int tiles_x, int total_tiles, int per,
                                                                int mb_per_slice, Strides sx, Strides sg) {
  using Cf = DwCfg<K, CIN, NT, D>;
  constexpr int CP = Cf::CP, PH = Cf::PH, PW = Cf::PW, NTP = Cf::NTP, PAD = K / 2, NB = NT / 8;
  constexpr int MBW = D::MBW, NW = D::NW, TH = D::TH, NTH = D::THREADS;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* const stages = reinterpret_cast<bf16*>(dw_smem);  // 2 x ([PH][PW][CP] patch, [TH * 16][NTP] g tile)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, t = lane & 3;
  const int part = blockIdx.x, n0 = blockIdx.z * NT;
  const int mb_begin = blockIdx.y * mb_per_slice;
  const int mb_end = min(mb_begin + mb_per_slice, Cf::MBT);

  // tile `tile`'s patch and g tile into stage s by cp.async (zeros outside the
  // map and past cout), one commit group
  auto issue = [&](int tile, int s) {
    bf16* Ps = stages + s * Cf::STAGE;
    bf16* Gs = Ps + PH * PW * CP;
    const int tx = tile % tiles_x, r = tile / tiles_x, ty = r % tiles_y, b = r / tiles_y;
    const int y0 = ty * TH, x0 = tx * 16;
    const bf16* xb = x + b * sx.b;
    constexpr int XC = CIN / 8;
    for (int i = threadIdx.x; i < PH * PW * XC; i += NTH) {
      const int c = (i % XC) * 8, pix = i / XC, gy = y0 - PAD + pix / PW, gx = x0 - PAD + pix % PW;
      bf16* dst = Ps + pix * CP + c;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) tc::cp_async16(dst, xb + gy * sx.h + gx * sx.w + c);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    const bf16* gb = g + b * sg.b;
    constexpr int GC = NT / 8;
    for (int i = threadIdx.x; i < TH * 16 * GC; i += NTH) {
      const int c = (i % GC) * 8, pix = i / GC, y = y0 + pix / 16, xq = x0 + pix % 16;
      bf16* dst = Gs + pix * NTP + c;
      if (y < h && xq < wd && n0 + c < cout) tc::cp_async16(dst, gb + y * sg.h + xq * sg.w + n0 + c);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    tc::cp_async_commit();
  };

  // ldmatrix.trans tiles of an A fragment: rows (tap, ci) 0-7 | 8-15 by pixels
  // 0-7 | 8-15; this lane's row address in the patch for each of its m blocks
  // (rows past M read row 0: their sums are never stored)
  int a_off[MBW];
  bool live[MBW];
#pragma unroll
  for (int j = 0; j < MBW; ++j) {
    const int mb = mb_begin + warp + j * NW;
    live[j] = mb < mb_end;
    int m = mb * 16 + ((lane >> 3) & 1) * 8;
    if (m >= Cf::M) m = 0;
    const int tap = m / CIN, ci = m % CIN, pix = (lane & 7) + (lane >> 4) * 8;
    a_off[j] = ((tap / K) * PW + tap % K + pix) * CP + ci;
  }
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * NTP + (lane >> 4) * 8;

  float sum[MBW][NB][4] = {};
  const int t_begin = part * per, t_end = min(t_begin + per, total_tiles);
  if (t_begin < t_end) issue(t_begin, 0);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int s = (tile - t_begin) & 1;
    tc::cp_async_wait<0>();  // this tile has landed (this thread's copies) ...
    __syncthreads();         // ... for every thread, and every warp is done with the other stage
    if (tile + 1 < t_end) issue(tile + 1, s ^ 1);
    const bf16* Ps = stages + s * Cf::STAGE;
    const bf16* Gs = Ps + PH * PW * CP;
    const int rows = min(TH, h - ((tile / tiles_x) % tiles_y) * TH);  // rows past the map hold g = 0
    float acc[MBW][NB][4] = {};
    for (int py = 0; py < rows; ++py) {
      uint32_t bfr[NB / 2][4];
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) tc::ldsm_x4_trans(bfr[n2], Gs + py * 16 * NTP + b_off + n2 * 16);
      const bf16* prow = Ps + py * PW * CP;
#pragma unroll
      for (int j = 0; j < MBW; ++j) {
        if (!live[j]) continue;
        uint32_t a[4];
        tc::ldsm_x4_trans(a, prow + a_off[j]);
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          tc::mma_bf16(acc[j][2 * n2], a, bfr[n2][0], bfr[n2][1]);
          tc::mma_bf16(acc[j][2 * n2 + 1], a, bfr[n2][2], bfr[n2][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MBW; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[j][nb][i] += acc[j][nb][i];
  }
  tc::cp_async_wait<0>();

  // rows gq, gq + 8 of each m block are dW rows (tap, ci); columns n0 + 8 nb +
  // 2t, + 1 output channels. Every row and column of the part is written.
  float* pb = partial + (long long)part * Cf::M * cout;
#pragma unroll
  for (int j = 0; j < MBW; ++j) {
    if (!live[j]) continue;
    const int mb = mb_begin + warp + j * NW;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int co = n0 + nb * 8 + 2 * t;
      if (co >= cout) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = mb * 16 + gq + 8 * i;
        if (m < Cf::M) *reinterpret_cast<float2*>(pb + m * cout + co) = make_float2(sum[j][nb][2 * i], sum[j][nb][2 * i + 1]);
      }
    }
  }
}

// out (B, H, W, C) contiguous = in (B, H, W, C) by element strides, bf16: 32
// pixels x 32 channels a block through a shared tile, so that the loads run
// along W of a channel plane (NCHW views) and the stores along C.
__global__ void __launch_bounds__(256) to_channels_last_kernel(const bf16* __restrict__ in, bf16* __restrict__ out,
                                                               int hw, int wd, int c, Strides s) {
  __shared__ unsigned short tile[32][33];
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const bf16* ib = in + b * s.b;
  for (int j = ty; j < 32; j += 8) {
    const int p = p0 + tx, cc = c0 + j;
    if (p < hw && cc < c) {
      const int y = p / wd, xq = p - y * wd;
      tile[j][tx] = __bfloat16_as_ushort(ib[y * s.h + xq * s.w + cc * s.c]);
    }
  }
  __syncthreads();
  bf16* ob = out + (long long)b * hw * c;
  for (int j = ty; j < 32; j += 8) {
    const int p = p0 + j, cc = c0 + tx;
    if (p < hw && cc < c) ob[(long long)p * c + cc] = __ushort_as_bfloat16(tile[tx][j]);
  }
}

// t, or its channels-last copy in `scratch` (written here) where t is not
// channels-last with 16-byte aligned pixels; s becomes the copy's strides
inline cudaError_t channels_last(const void*& t, Strides& s, void* scratch, int b, int h, int wd, int c,
                                 cudaStream_t stream) {
  if (vec_in(t, s)) return cudaSuccess;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  dim3 grid((h * wd + 31) / 32, (c + 31) / 32, b);
  to_channels_last_kernel<<<grid, 256, 0, stream>>>(static_cast<const bf16*>(t), static_cast<bf16*>(scratch), h * wd,
                                                     wd, c, s);
  t = scratch;
  s = Strides{(long long)h * wd * c, (long long)wd * c, c, 1};
  return cudaGetLastError();
}

// The tilings launched: 8 warps, pixel tiles of 8 x 16; 2 m blocks a warp at
// 32 output channels a block, 1 at 64; partials for about two blocks an SM
// (ops/smallc_conv.py::bwd_parts). 4 and 2 m blocks (fewer slices of dW's
// rows to stage each tile for) or 16-row tiles were 7-20% slower at
// rb.0.conv2 and up.1 (time_tilings k12bwd).
template <int NT>
using ConvDwTiles = DwTiles<8, NT == 32 ? 2 : 1, 8>;

// x, g channels-last with 16-byte aligned pixels
template <int K, int CIN, int NT, class D = ConvDwTiles<NT>>
cudaError_t dw_tc(const void* x, const void* g, float* partial, int b, int h, int wd, int cout, Strides sx,
                  Strides sg, int parts, cudaStream_t stream) {
  using Cf = DwCfg<K, CIN, NT, D>;
  if (cout % 8 != 0 || parts < 1 || !vec_in(x, sx) || !vec_in(g, sg)) return cudaErrorInvalidValue;
  auto kernel = conv_dw_tc_kernel<K, CIN, NT, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + D::TW - 1) / D::TW, tiles_y = (h + D::TH - 1) / D::TH, total = b * tiles_y * tiles_x;
  const int per = (total + parts - 1) / parts;
  // the m blocks cut into equal slices of at most MBLOCKS
  const int slices = (Cf::MBT + D::MBLOCKS - 1) / D::MBLOCKS, mb_per_slice = (Cf::MBT + slices - 1) / slices;
  dim3 grid(parts, slices, (cout + NT - 1) / NT);
  kernel<<<grid, D::THREADS, Cf::SMEM, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial,
                                                 h, wd, cout, tiles_y, tiles_x, total, per, mb_per_slice, sx, sg);
  return cudaGetLastError();
}

template <int K, int CIN>
cudaError_t dw_tc_n(const void* x, const void* g, float* partial, int b, int h, int wd, int cout, Strides sx,
                    Strides sg, int parts, cudaStream_t st) {
  return cout <= 32 ? dw_tc<K, CIN, 32>(x, g, partial, b, h, wd, cout, sx, sg, parts, st)
                    : dw_tc<K, CIN, 64>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
}

template <int K>
cudaError_t dw_tc_c(const void* x, const void* g, float* partial, int b, int h, int wd, int cin, int cout,
                    Strides sx, Strides sg, int parts, cudaStream_t st) {
  switch (cin) {
    case 8: return dw_tc_n<K, 8>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
    case 16: return dw_tc_n<K, 16>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
    case 32: return dw_tc_n<K, 32>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
    case 64: return dw_tc_n<K, 64>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dw_tc_k(int k, const void* x, const void* g, float* partial, int b, int h, int wd, int cin, int cout,
                    Strides sx, Strides sg, int parts, cudaStream_t st) {
  switch (k) {
    case 3: return dw_tc_c<3>(x, g, partial, b, h, wd, cin, cout, sx, sg, parts, st);
    case 5: return dw_tc_c<5>(x, g, partial, b, h, wd, cin, cout, sx, sg, parts, st);
    case 7: return dw_tc_c<7>(x, g, partial, b, h, wd, cin, cout, sx, sg, parts, st);
    default: return cudaErrorInvalidValue;
  }
}

// The channel counts of the tensor-core forward's contraction (its CIN)
inline bool tc_channels(int c) { return c == 8 || c == 16 || c == 32 || c == 64; }

}  // namespace

// x (B, H, W, Cin) and out (B, H, W, Cout) by element strides; w (K, K, Cin,
// Cout) contiguous, already rounded to x's dtype: bf16 (16-byte aligned) for a
// bf16 x, fp32 for an fp32 x.
extern "C" int cenet_smallc_conv_fwd(int is_bf16, const void* x, const void* w, void* out, int b, int h, int wd,
                                     int cin, int cout, int k, long long sxb, long long sxh, long long sxw,
                                     long long sxc, long long sob, long long soh, long long sow, long long soc,
                                     void* stream) {
  Strides sx{sxb, sxh, sxw, sxc}, so{sob, soh, sow, soc};
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)fwd_tc_k(k, x, w, out, b, h, wd, cin, cout, sx, so, st)
                 : (int)fwd_k(k, x, static_cast<const float*>(w), out, b, h, wd, cin, cout, sx, so, st);
}

// x (B, H, W, Cin), g (B, H, W, Cout), dx (B, H, W, Cin) by element strides;
// wf (K, K, Cout, Cin) contiguous: the weights flipped in space, in and out
// swapped, rounded to x's dtype; partial (parts, K, K, Cin, Cout) fp32
// scratch; dw (K, K, Cin, Cout) fp32. Launches by dtype and shape:
//   bf16  x and g are first copied channels-last into x_cl, g_cl (B, H, W, C)
//         bf16 scratch where they are not channels-last with 16-byte aligned
//         pixels (null where they are). dx on the tensor cores
//         (conv_fwd_tc_kernel on g with wf, stored as bf16, 16-byte aligned)
//         where Cout is one of its channel counts {8, 16, 32, 64}; for any
//         other Cout of the domain (Cout % 8 == 0, up to 256) the CUDA-core dx
//         blocks with wf stored as fp32: a shape rule, not a fallback. dw on
//         the tensor cores (conv_dw_tc_kernel);
//   fp32  dx and dw on CUDA cores in one launch (conv_bwd_kernel), wf fp32;
// then the ordered sum of the dw partials.
extern "C" int cenet_smallc_conv_bwd(int is_bf16, const void* x, const void* g, const void* wf, void* dx,
                                     void* partial, void* dw, void* x_cl, void* g_cl, int b, int h, int wd, int cin,
                                     int cout, int k, long long sxb, long long sxh, long long sxw, long long sxc,
                                     long long sgb, long long sgh, long long sgw, long long sgc, long long sdb,
                                     long long sdh, long long sdw, long long sdc, int parts, void* stream) {
  Strides sx{sxb, sxh, sxw, sxc}, sg{sgb, sgh, sgw, sgc}, sdx{sdb, sdh, sdw, sdc};
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partial);
  auto wff = static_cast<const float*>(wf);
  cudaError_t err;
  if (is_bf16) {
    err = channels_last(x, sx, x_cl, b, h, wd, cin, st);
    if (err == cudaSuccess) err = channels_last(g, sg, g_cl, b, h, wd, cout, st);
    if (err != cudaSuccess) return (int)err;
    err = tc_channels(cout) ? fwd_tc_k(k, g, wf, dx, b, h, wd, cout, cin, sg, sdx, st)
                            : bwd_k<__nv_bfloat16>(k, x, g, wff, dx, p, b, h, wd, cin, cout, sx, sg, sdx, 0, st);
    if (err == cudaSuccess) err = dw_tc_k(k, x, g, p, b, h, wd, cin, cout, sx, sg, parts, st);
  } else {
    err = bwd_k<float>(k, x, g, wff, dx, p, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)sum_parts(p, static_cast<float*>(dw), (long long)k * k * cin * cout, parts, st);
}
