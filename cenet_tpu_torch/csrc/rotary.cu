// Half-split (GPT-NeoX) rotary embedding: out = [x0*c - x1*s, x1*c + x0*s]
// with x0 = x[..., :D/2], x1 = x[..., D/2:], c = cos[n, j], s = sin[n, j].
//
// Replaces cenet_tpu/ops/rotary.py::apply_rotary_emb_pallas (body
// _rotary_kernel): x (B, H, N, D) with the rotary dim equal to D, cos/sin
// (N, D/2). Forward only, as the Pallas kernel.
//
// Bound: bytes (six floating-point operations per pair of elements). One
// thread takes one row (b, h, n) and CH adjacent pairs j .. j + CH - 1 of it:
// one vector load of x0's CH elements and one of x1's, the tables' CH entries
// of row n (read once per (n, j) and shared by every (b, h) through the cache,
// never broadcast to x's size as the TPU kernel's pre-broadcast blocks are),
// and one vector store of each half of the output. CH is the widest of 16, 8,
// 4 or 2 bytes of x (else one element) that divides D/2, x's (b, h, n) strides
// and the alignment of x and the tables: at D = 8 in bf16 a thread loads x0 and
// x1 as 8 bytes each, so a warp's 32 rows are 512 contiguous bytes. Row
// indices over (b, h, n) are 32-bit, divided by multiply-high; the wrapper
// checks that every offset fits. x is read through its (b, h, n) strides (unit
// stride on D); the output is contiguous.
//
// Numerics as the Pallas body, which computes in x's dtype: each table entry
// is rounded to x's dtype first, here in the kernel (__float2bfloat16 rounds
// to nearest even, as the JAX wrapper's astype and Tensor.to do), so the
// tables are read as the fp32 make_rotary_tables gives them, or in x's dtype;
// each product and each sum is rounded to x's dtype (in fp32 through
// __fmul_rn/__fadd_rn, so that no multiply-add is fused). The result equals
// x's-dtype arithmetic to the bit, in fp32 and in bf16 (a product of two bf16
// values is exact in fp32 before its rounding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// v rounded to T and back to fp32
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// n / d for n, d < 2^31 by multiply-high and shift, magic numbers from the host
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

// one load or store instruction of N bytes
template <int N> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<2> { using type = unsigned short; };

// CH elements of E from p (aligned to their size, or to 16 bytes beyond it)
// into out, in as few loads as 16 bytes each allow
template <typename E, int CH>
__device__ __forceinline__ void load(const E* __restrict__ p, E (&out)[CH]) {
  constexpr int BYTES = CH * (int)sizeof(E) < 16 ? CH * (int)sizeof(E) : 16, PER = BYTES / (int)sizeof(E);
  using W = typename Word<BYTES>::type;
#pragma unroll
  for (int k = 0; k < CH / PER; ++k) reinterpret_cast<W*>(out)[k] = reinterpret_cast<const W*>(p)[k];
}
template <typename E, int CH>
__device__ __forceinline__ void store(E* __restrict__ p, const E (&in)[CH]) {
  constexpr int BYTES = CH * (int)sizeof(E) < 16 ? CH * (int)sizeof(E) : 16, PER = BYTES / (int)sizeof(E);
  using W = typename Word<BYTES>::type;
#pragma unroll
  for (int k = 0; k < CH / PER; ++k) reinterpret_cast<W*>(p)[k] = reinterpret_cast<const W*>(in)[k];
}

// T: x's dtype; TT: the tables' (fp32, or T); CH pairs a thread
template <typename T, typename TT, int CH>
__global__ void __launch_bounds__(256) rotary_vec_kernel(const T* __restrict__ x, const TT* __restrict__ cos_t,
                                                         const TT* __restrict__ sin_t, T* __restrict__ out, int h,
                                                         int n, int half, int cpr, int total, FastDiv div_cpr,
                                                         FastDiv div_n, FastDiv div_h, int sb, int sh, int sn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = fdiv(i, div_cpr), j = (i - row * cpr) * CH;  // row over (b, h, n)
  const int bh = fdiv(row, div_n), t = row - bh * n, b = fdiv(bh, div_h), hh = bh - b * h;
  const T* xr = x + b * sb + hh * sh + t * sn + j;
  __align__(16) T x0[CH];  // (16-byte aligned: read and written as words)
  __align__(16) T x1[CH];
  __align__(16) T o0[CH];
  __align__(16) T o1[CH];
  __align__(16) TT ct[CH];
  __align__(16) TT st[CH];
  load(xr, x0);
  load(xr + half, x1);
  load(cos_t + t * half + j, ct);
  load(sin_t + t * half + j, st);
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    const float a = to_f(x0[e]), q = to_f(x1[e]), c = rnd<T>(to_f(ct[e])), s = rnd<T>(to_f(st[e]));
    o0[e] = from_f<T>(__fsub_rn(rnd<T>(__fmul_rn(a, c)), rnd<T>(__fmul_rn(q, s))));
    o1[e] = from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(q, c)), rnd<T>(__fmul_rn(a, s))));
  }
  T* orow = out + row * (2 * half) + j;
  store(orow, o0);
  store(orow + half, o1);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, typename TT, int CH>
cudaError_t launch_ch(const void* x, const void* c, const void* s, void* out, int b, int h, int n, int half, int sb,
                      int sh, int sn, cudaStream_t stream) {
  const int cpr = half / CH, total = b * h * n * cpr;
  rotary_vec_kernel<T, TT, CH><<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TT*>(c), static_cast<const TT*>(s), static_cast<T*>(out), h, n,
      half, cpr, total, fast_div(cpr), fast_div(n), fast_div(h), sb, sh, sn);
  return cudaGetLastError();
}

// The chunk rule: the widest CH (16 bytes of x down to one element) that
// divides D/2 and x's strides, with x and both tables aligned to a chunk
template <typename T, typename TT>
cudaError_t launch(const void* x, const void* c, const void* s, void* out, int b, int h, int n, int d, int sb, int sh,
                   int sn, cudaStream_t stream) {
  const int half = d / 2;
  if ((long long)b * h * n * half == 0) return cudaSuccess;
  auto fits = [&](int ch) {
    return half % ch == 0 && sb % ch == 0 && sh % ch == 0 && sn % ch == 0 && aligned(x, ch * (int)sizeof(T)) &&
           aligned(out, ch * (int)sizeof(T)) && aligned(c, ch * (int)sizeof(TT) < 16 ? ch * (int)sizeof(TT) : 16) &&
           aligned(s, ch * (int)sizeof(TT) < 16 ? ch * (int)sizeof(TT) : 16);
  };
  constexpr int VEC = 16 / sizeof(T);
  if (fits(VEC)) return launch_ch<T, TT, VEC>(x, c, s, out, b, h, n, half, sb, sh, sn, stream);
  if (fits(VEC / 2)) return launch_ch<T, TT, VEC / 2>(x, c, s, out, b, h, n, half, sb, sh, sn, stream);
  if (fits(VEC / 4)) return launch_ch<T, TT, VEC / 4>(x, c, s, out, b, h, n, half, sb, sh, sn, stream);
  if constexpr (VEC >= 8) {
    if (fits(VEC / 8)) return launch_ch<T, TT, VEC / 8>(x, c, s, out, b, h, n, half, sb, sh, sn, stream);
  }
  return cudaErrorInvalidValue;  // unreachable: one element always fits
}

}  // namespace

// x (B, H, N, D) with element strides sb, sh, sn and unit stride on D; cos, sin
// (N, D/2) contiguous, fp32 (tables_bf16 = 0) or bf16 with a bf16 x; out
// (B, H, N, D) contiguous. Every element offset below 2^31 (the wrapper checks).
extern "C" int cenet_rotary(int is_bf16, int tables_bf16, const void* x, const void* c, const void* s, void* out,
                            int b, int h, int n, int d, int sb, int sh, int sn, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (!is_bf16) {
    return tables_bf16 ? (int)cudaErrorInvalidValue
                       : (int)launch<float, float>(x, c, s, out, b, h, n, d, sb, sh, sn, st);
  }
  return tables_bf16 ? (int)launch<bf16, bf16>(x, c, s, out, b, h, n, d, sb, sh, sn, st)
                     : (int)launch<bf16, float>(x, c, s, out, b, h, n, d, sb, sh, sn, st);
}
