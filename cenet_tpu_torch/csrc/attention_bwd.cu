// Attention backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_pallas_attention_bwd_impl
// (bodies _attn_dq_kernel and _attn_dkv_kernel), the backward of pallas_attention:
//   P = exp(q k^T - lse), ds = P (dO v^T - Delta), Delta = rowsum(dO o) (given),
//   dq = round(ds) k,  dk = round(ds)^T q,  dv = round(P)^T dO,
// q pre-scaled, lse the forward's fp32 row log-sum-exp. Two kernels, dq and
// dk/dv, as the Pallas version splits them; the design is in
// attention_bwd_common.cuh.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the dec1 Nonlocal
// site of a training batch (B=8, H=1, N=M=3136, d=dv=64) the least backward
// work is 2 N M (3d + 2dv) = 5.0e10 FLOP -> 0.05 ms, against about 0.02 GB of
// q, k, v, dO, dq, dk, dv and LSE -> 0.006 ms, so operations bound it. This
// first version runs on CUDA cores (fp32 FMA) and recomputes the logits in
// both kernels; wgmma and TMA are later work.

#include "attention_bwd_common.cuh"

extern "C" int cenet_attention_bwd(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout, const float* lse,
    float* delta, void* dq, void* dk, void* dv, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  cenet::BwdParams p{q, k, v, dout, nullptr, lse, nullptr, delta, nullptr, dq, dk, dv, B, H, N, M, D, DV,
                     {sqb, sqh, sqn}, {skb, skh, skn}, {svb, svh, svn}, {sob, soh, son}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? cenet::bwd_launch<__nv_bfloat16, 1>(p, s) : cenet::bwd_launch<float, 1>(p, s);
}
