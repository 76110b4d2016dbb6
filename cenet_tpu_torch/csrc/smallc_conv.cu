// Stride-1 KxK convolution with SAME padding (K odd, 3-7) for small channel
// counts: the forward, and the backward's dx and dw in one fused launch.
//
// Replaces tools/negative_results/smallc_conv.py::_pallas_conv_fwd (body
// _fwd_kernel) and _pallas_conv_bwd (body _bwd_kernel, dx and dw together).
//
// Bound: operations. 2*K*K*Cin*Cout FLOPs per output pixel against
// (Cin + Cout) elements moved; at the OutHead sites (K = 5, 32 -> 32 at 224^2;
// K = 3, 64 -> 32 and 64 -> 64 at 112^2) that is 200-575 FLOPs per byte, above
// the card's line. The TPU kernel packs taps along the contraction so that
// 32-lane data fills 128-lane MXU passes; that is MXU lane economics and
// does not carry over. This is a direct convolution on CUDA cores, the simple
// first version: a block takes a 16x16 tile of output pixels and 32 output
// channels; it stages the input patch with its halo (zero outside the map)
// and the weights of CI input channels at a time in shared memory, and each
// thread keeps the 32 fp32 sums of one pixel in registers. The weights are
// read as float4 broadcasts, so each shared-memory read feeds four (weights)
// or K*K*32/CI (input) multiply-adds.
//
// Backward, one launch with two kinds of blocks:
//   * dx blocks: the same tile code on the upstream gradient g with the
//     flipped, in/out-swapped weights (valid because padding = K/2);
//   * dw blocks: a block owns 8 input x 32 output channels, each thread one
//     (ci, co) pair with its K*K sums, and walks a slice of 8x16 pixel tiles
//     of the batch, staging the x patch and the g tile in shared memory.
// The TPU kernel carries dw in a grid-constant output block; blocks on the
// card run in no order, so each dw block writes its partial sums and a second
// small kernel adds the partials of every weight in order: no atomics, repeat
// runs are bit-identical.
//
// Numerics as the Pallas bodies: x (g) in its dtype, the weights rounded to
// x's dtype by the wrapper (the JAX wrapper packs them in x's dtype), products
// and sums in fp32, one rounding of each output to x's dtype; dw in fp32.
// x, g and the outputs are read and written through element strides on every
// dim (NHWC shapes), so NCHW tensors arrive as permuted views without a copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

template <typename T, int K>
__global__ void __launch_bounds__(THREADS) conv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                                           T* __restrict__ out, int h, int wd, int cin, int cout,
                                                           int tiles_x, Strides sx, Strides so) {
  __shared__ __align__(16) float smem[Cfg<K>::FWD_SMEM];
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  conv_tile<T, K>(smem, x, w, out, blockIdx.z, ty * TILE, tx * TILE, blockIdx.y * CO_T, h, wd, cin, cout, sx, so);
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

template <typename T, int K>
cudaError_t fwd(const void* x, const float* w, void* out, int b, int h, int wd, int cin, int cout, Strides sx,
                Strides so, cudaStream_t stream) {
  const int tiles_x = (wd + TILE - 1) / TILE, tiles_y = (h + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, (cout + CO_T - 1) / CO_T, b);
  conv_fwd_kernel<T, K><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), w, static_cast<T*>(out), h, wd, cin,
                                                      cout, tiles_x, sx, so);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t bwd(const void* x, const void* g, const float* wf, void* dx, float* partial, float* dw, int b, int h,
                int wd, int cin, int cout, Strides sx, Strides sg, Strides sdx, int parts, cudaStream_t stream) {
  const int n_dx = ((wd + TILE - 1) / TILE) * ((h + TILE - 1) / TILE) * ((cin + CO_T - 1) / CO_T) * b;
  const long long tiles = (long long)b * ((h + DW_TH - 1) / DW_TH) * ((wd + DW_TW - 1) / DW_TW);
  const long long per = (tiles + parts - 1) / parts;
  const int n_dw = parts * ((cout + CO_T - 1) / CO_T) * (cin / DW_CI);
  conv_bwd_kernel<T, K><<<n_dx + n_dw, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), wf, static_cast<T*>(dx), partial, h, wd, cin, cout, b, sx,
      sg, sdx, n_dx, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)K * K * cin * cout;
  sum_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, dw, n, parts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_k(int k, const void* x, const float* w, void* out, int b, int h, int wd, int cin, int cout, Strides sx,
                  Strides so, cudaStream_t st) {
  switch (k) {
    case 3: return fwd<T, 3>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    case 5: return fwd<T, 5>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    case 7: return fwd<T, 7>(x, w, out, b, h, wd, cin, cout, sx, so, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_k(int k, const void* x, const void* g, const float* wf, void* dx, float* partial, float* dw, int b,
                  int h, int wd, int cin, int cout, Strides sx, Strides sg, Strides sdx, int parts, cudaStream_t st) {
  switch (k) {
    case 3: return bwd<T, 3>(x, g, wf, dx, partial, dw, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
    case 5: return bwd<T, 5>(x, g, wf, dx, partial, dw, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
    case 7: return bwd<T, 7>(x, g, wf, dx, partial, dw, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, H, W, Cin) and out (B, H, W, Cout) by element strides; w fp32
// (K, K, Cin, Cout) contiguous, already rounded to x's dtype.
extern "C" int cenet_smallc_conv_fwd(int is_bf16, const void* x, const void* w, void* out, int b, int h, int wd,
                                     int cin, int cout, int k, long long sxb, long long sxh, long long sxw,
                                     long long sxc, long long sob, long long soh, long long sow, long long soc,
                                     void* stream) {
  Strides sx{sxb, sxh, sxw, sxc}, so{sob, soh, sow, soc};
  auto st = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  return is_bf16 ? (int)fwd_k<__nv_bfloat16>(k, x, wf, out, b, h, wd, cin, cout, sx, so, st)
                 : (int)fwd_k<float>(k, x, wf, out, b, h, wd, cin, cout, sx, so, st);
}

// x (B, H, W, Cin), g (B, H, W, Cout), dx (B, H, W, Cin) by element strides;
// wf fp32 (K, K, Cout, Cin) contiguous: the weights flipped in space, in and
// out swapped, rounded to x's dtype; partial (parts, K, K, Cin, Cout) fp32
// scratch; dw (K, K, Cin, Cout) fp32.
extern "C" int cenet_smallc_conv_bwd(int is_bf16, const void* x, const void* g, const void* wf, void* dx,
                                     void* partial, void* dw, int b, int h, int wd, int cin, int cout, int k,
                                     long long sxb, long long sxh, long long sxw, long long sxc, long long sgb,
                                     long long sgh, long long sgw, long long sgc, long long sdb, long long sdh,
                                     long long sdw, long long sdc, int parts, void* stream) {
  Strides sx{sxb, sxh, sxw, sxc}, sg{sgb, sgh, sgw, sgc}, sdx{sdb, sdh, sdw, sdc};
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(wf);
  auto p = static_cast<float*>(partial);
  auto d = static_cast<float*>(dw);
  return is_bf16 ? (int)bwd_k<__nv_bfloat16>(k, x, g, w, dx, p, d, b, h, wd, cin, cout, sx, sg, sdx, parts, st)
                 : (int)bwd_k<float>(k, x, g, w, dx, p, d, b, h, wd, cin, cout, sx, sg, sdx, parts, st);
}
