// RMSNorm forward over the last dim, y = x * rsqrt(mean(x^2) + eps) (* w).
//
// Replaces cenet_tpu/ops/rms_norm.py::_rms_fwd_impl, both of its Pallas bodies:
// _rms_kernel (no weight) and _rms_weight_kernel (w given); one kernel here,
// with an optional weight pointer (null: no weight).
//
// Bound: bytes. Each element is read once and written once with three
// floating-point operations, far below the card's operations-per-byte line.
// The model's rows are short (D = 16, 32, 40 at the DSEB sites), so a block per
// row, the TPU's (1024 rows, D) tile turned around, would leave most threads
// idle. Instead a group of G threads (a power of two, G <= 32, inside one warp)
// takes one row: each thread loads chunks of 16 bytes (8 bf16 or 4 fp32
// values), the group sums the squares with warp shuffles, and each thread
// scales and stores its own chunks again. A warp covers 32 / G rows, so the
// loads of a warp are contiguous. Rows whose length is not a multiple of the
// chunk, or whose start is not 16-byte aligned, take scalar loads.
//
// Numerics as the Pallas bodies: statistics in fp32 (x cast to fp32, the
// mean as the sum over D divided by D), the product in fp32, one rounding to
// x's dtype at the store. The reciprocal square root is 1 / sqrtf (each
// correctly rounded), not the card's approximate rsqrtf (about 2 ulp).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// one 16-byte chunk of a row as VEC values of T
template <typename T>
struct Chunk {
  static constexpr int VEC = 16 / sizeof(T);
  union { uint4 raw; T v[16 / sizeof(T)]; };
};

template <typename T, int G, bool VECTOR>
__global__ void rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                                long long rows, int d, float eps) {
  constexpr int VEC = Chunk<T>::VEC;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = tid / G;
  const int lane = (int)(tid % G);
  const bool live = row < rows;  // every thread of the warp reaches the shuffles
  const T* xr = x + (live ? row : 0) * d;
  T* yr = y + (live ? row : 0) * d;
  const int chunks = (d + VEC - 1) / VEC;

  float ss = 0.f;
  if (live) {
    for (int c = lane; c < chunks; c += G) {
      if (VECTOR) {
        Chunk<T> ch;
        ch.raw = *reinterpret_cast<const uint4*>(xr + c * VEC);
#pragma unroll
        for (int i = 0; i < VEC; ++i) { float f = to_f(ch.v[i]); ss += f * f; }
      } else {
        for (int i = c * VEC; i < min(d, c * VEC + VEC); ++i) { float f = to_f(xr[i]); ss += f * f; }
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off, G);
  if (!live) return;
  const float inv = 1.f / sqrtf(ss / (float)d + eps);

  for (int c = lane; c < chunks; c += G) {
    if (VECTOR) {
      Chunk<T> ch, out;
      ch.raw = *reinterpret_cast<const uint4*>(xr + c * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float f = to_f(ch.v[i]) * inv;
        if (w) f *= w[c * VEC + i];
        out.v[i] = from_f<T>(f);
      }
      *reinterpret_cast<uint4*>(yr + c * VEC) = out.raw;
    } else {
      for (int i = c * VEC; i < min(d, c * VEC + VEC); ++i) {
        float f = to_f(xr[i]) * inv;
        if (w) f *= w[i];
        yr[i] = from_f<T>(f);
      }
    }
  }
}

template <typename T, int G>
cudaError_t launch_g(const void* x, const float* w, void* y, long long rows, int d, float eps, bool vector,
                     cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (rows * G + threads - 1) / threads;
  if (vector)
    rms_norm_kernel<T, G, true><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, d, eps);
  else
    rms_norm_kernel<T, G, false><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* y, long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int VEC = Chunk<T>::VEC;
  const bool vector = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int chunks = (d + VEC - 1) / VEC;
  // threads per row: the chunks of a row, rounded up to a power of two, at most a warp
  if (chunks <= 1) return launch_g<T, 1>(x, w, y, rows, d, eps, vector, stream);
  if (chunks <= 2) return launch_g<T, 2>(x, w, y, rows, d, eps, vector, stream);
  if (chunks <= 4) return launch_g<T, 4>(x, w, y, rows, d, eps, vector, stream);
  if (chunks <= 8) return launch_g<T, 8>(x, w, y, rows, d, eps, vector, stream);
  if (chunks <= 16) return launch_g<T, 16>(x, w, y, rows, d, eps, vector, stream);
  return launch_g<T, 32>(x, w, y, rows, d, eps, vector, stream);
}

}  // namespace

// x, y: (rows, d) contiguous, float32 or bfloat16 alike; w: (d,) float32 or null.
extern "C" int cenet_rms_norm(int is_bf16, const void* x, const void* w, void* y, long long rows, int d, float eps,
                              void* stream) {
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  return is_bf16 ? (int)launch<__nv_bfloat16>(x, wf, y, rows, d, eps, s) : (int)launch<float>(x, wf, y, rows, d, eps, s);
}
