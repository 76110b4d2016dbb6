// Depthwise 3x3 convolution, stride 1, padding = dilation (shape-preserving):
// the forward, and the weight gradient dw summed over batch and space.
//
// Replaces tools/negative_results/depthwise.py::_pallas_depthwise_fwd (body
// _fwd_kernel) and _pallas_depthwise_dw (body _dw_kernel). The backward's dx is
// the forward on the upstream gradient with the spatially flipped kernel, as
// _dp_bwd does, so it needs no kernel of its own.
//
// Bound: bytes. Nine multiply-adds per output element against one element
// read and one written; the nine taps re-read neighbours that the cache holds.
// The TPU kernel keeps a whole padded (H, W, C) map in VMEM; here a thread
// computes one output element and reads its taps straight from device memory,
// masking the halo, so nothing is padded or copied. Both kernels take element
// strides on every dim of x, g and the output, so the model's NCHW tensors
// arrive as permute(0, 2, 3, 1) views without a copy. The thread order follows
// the memory: with a unit channel stride (channels-last) consecutive threads
// take consecutive channels, otherwise consecutive columns, so a warp's loads
// and stores are contiguous in both layouts.
//
// dw sums over the batch and the map. On the TPU the sequential grid carries
// that sum in the output block (_dw_kernel's "+="); blocks on the card run in
// no order, so here it is two passes: each block sums the products of one
// slice of positions for its channels into a partial (a fixed tree inside
// the block), and a second kernel adds the partials of each (tap, channel) in
// order. No atomics: repeat runs are bit-identical.
//
// Numerics as the Pallas bodies: x (or g) in its dtype, the taps in fp32, the
// sum in fp32 over the taps in (dy, dx) order, one rounding to the output's
// dtype; dw in fp32.

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

template <typename T, bool CFAST>
__global__ void depthwise_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                                     int bsz, int h, int wd, int c, int dil, Strides sx, Strides so, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int ch, col, row;
  long long b, r;
  if (CFAST) {
    ch = (int)(i % c); r = i / c;
    col = (int)(r % wd); r /= wd;
    row = (int)(r % h); b = r / h;
  } else {
    col = (int)(i % wd); r = i / wd;
    row = (int)(r % h); r /= h;
    ch = (int)(r % c); b = r / c;
  }
  const T* xb = x + b * sx.b + ch * sx.c;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = row + (dy - 1) * dil;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = col + (dx - 1) * dil;
      if (yy >= 0 && yy < h && xx >= 0 && xx < wd) acc += to_f(xb[yy * sx.h + xx * sx.w]) * w[(dy * 3 + dx) * c + ch];
    }
  }
  out[b * so.b + row * so.h + col * so.w + ch * so.c] = from_f<T>(acc);
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

template <typename T>
cudaError_t launch_fwd(const void* x, const float* w, void* out, int b, int h, int wd, int c, int dil, Strides sx,
                       Strides so, cudaStream_t stream) {
  const long long total = (long long)b * h * wd * c;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (sx.c == 1)
    depthwise_fwd_kernel<T, true><<<blocks, threads, 0, stream>>>(static_cast<const T*>(x), w, static_cast<T*>(out),
                                                                   b, h, wd, c, dil, sx, so, total);
  else
    depthwise_fwd_kernel<T, false><<<blocks, threads, 0, stream>>>(static_cast<const T*>(x), w, static_cast<T*>(out),
                                                                    b, h, wd, c, dil, sx, so, total);
  return cudaGetLastError();
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
