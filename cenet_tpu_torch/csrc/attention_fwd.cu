// Attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_pallas_attention_fwd_impl
// (body _attn_fwd_kernel), reached through pallas_attention:
//   o = softmax(q k^T) v,  q/k (B, H, N|M, d), v (B, H, M, dv), q pre-scaled,
// with the whole-row fp32 softmax and deferred normalisation of the Pallas
// kernel. Returns o in q's dtype and the fp32 row log-sum-exp. The design is
// in attention_fwd_common.cuh.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the dec1 Nonlocal
// site of a 32-slice chunk (B=32, H=1, N=M=3136, d=dv=64) it does 8.1e10 FLOP
// -> 0.08 ms and moves about 0.05 GB -> 0.015 ms, so operations bound it. This
// first version runs on CUDA cores (fp32 FMA); wgmma and TMA are later work.

#include "attention_fwd_common.cuh"

extern "C" int cenet_attention_fwd(
    int is_bf16, const void* q, const void* k, const void* v,
    void* o, float* lse, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, void* stream) {
  cenet::Params p{{q, nullptr}, {k, nullptr}, v, nullptr, o, lse, nullptr, B, H, N, M, D, DV,
                  {{sqb, sqh, sqn}, {}}, {{skb, skh, skn}, {}}, {svb, svh, svn}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? cenet::launch<__nv_bfloat16, 1>(p, s) : cenet::launch<float, 1>(p, s);
}
