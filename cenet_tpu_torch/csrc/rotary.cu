// Half-split (GPT-NeoX) rotary embedding: out = [x0*c - x1*s, x1*c + x0*s]
// with x0 = x[..., :D/2], x1 = x[..., D/2:], c = cos[n, j], s = sin[n, j].
//
// Replaces cenet_tpu/ops/rotary.py::apply_rotary_emb_pallas (body
// _rotary_kernel): x (B, H, N, D) with the rotary dim equal to D, cos/sin
// (N, D/2) in x's dtype. Forward only, as the Pallas kernel.
//
// Bound: bytes (six floating-point operations per pair of elements). One
// thread takes one pair (n, j) of one (b, h) row: it reads x0 and x1, the
// table entries cos[n, j] and sin[n, j] once (the tables are N x D/2, read
// per (n, j) and shared by every (b, h) through the cache, never broadcast to
// x's size as the TPU kernel's pre-broadcast blocks are), and writes two
// outputs. Consecutive threads take consecutive j, so reads and writes of a
// warp fall on contiguous addresses. x is read through its (b, h, n) strides
// (unit stride on D); the output is contiguous.
//
// Numerics as the Pallas body, which computes in x's dtype: the tables are
// rounded to x's dtype first (as the JAX wrapper casts them), and each product
// and each sum is rounded to x's dtype (in fp32 through __fmul_rn/__fadd_rn,
// so that no multiply-add is fused). The result equals x's-dtype arithmetic
// to the bit, in fp32 and in bf16 (a product of two bf16 values is exact in
// fp32 before its rounding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// v rounded to T and back to fp32
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <typename T>
__global__ void rotary_kernel(const T* __restrict__ x, const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                              T* __restrict__ out, int h, int n, int half, long long sb, long long sh, long long sn,
                              long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int j = (int)(i % half);
  long long r = i / half;  // row index over (b, h, n)
  const int t = (int)(r % n);
  r /= n;
  const int hh = (int)(r % h);
  const long long b = r / h;
  const T* xr = x + b * sb + hh * sh + t * sn;
  T* orow = out + ((b * h + hh) * n + t) * (2LL * half);
  const float x0 = to_f(xr[j]), x1 = to_f(xr[j + half]);
  const float c = to_f(cos_t[(long long)t * half + j]), s = to_f(sin_t[(long long)t * half + j]);
  orow[j] = from_f<T>(__fsub_rn(rnd<T>(__fmul_rn(x0, c)), rnd<T>(__fmul_rn(x1, s))));
  orow[j + half] = from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(x1, c)), rnd<T>(__fmul_rn(x0, s))));
}

template <typename T>
cudaError_t launch(const void* x, const void* c, const void* s, void* out, int b, int h, int n, int d, long long sb,
                   long long sh, long long sn, cudaStream_t stream) {
  const int half = d / 2;
  const long long total = (long long)b * h * n * half;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  rotary_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), static_cast<const T*>(s), static_cast<T*>(out), h, n, half,
      sb, sh, sn, total);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, N, D) with element strides sb, sh, sn and unit stride on D; cos, sin
// (N, D/2) contiguous in x's dtype; out (B, H, N, D) contiguous.
extern "C" int cenet_rotary(int is_bf16, const void* x, const void* c, const void* s, void* out, int b, int h, int n,
                            int d, long long sb, long long sh, long long sn, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)launch<__nv_bfloat16>(x, c, s, out, b, h, n, d, sb, sh, sn, st)
                 : (int)launch<float>(x, c, s, out, b, h, n, d, sb, sh, sn, st);
}
