// Attention backward in one kernel, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_pallas_attention_bwd_fused_impl
// (body _attn_bwd_fused_kernel), which computes the same gradients as
// _pallas_attention_bwd_impl (attention_bwd.cu) and which no router of the
// JAX package calls:
//   P = exp(q k^T - lse), ds = P (dO v^T - Delta), Delta = rowsum(dO o) (given),
//   dq = round(ds) k,  dk = round(ds)^T q,  dv = round(P)^T dO.
// One launch: a block per (batch, head, 64 key rows) walks the query tiles,
// writes its dk/dv rows, and adds each query tile's dq over its keys into a
// zeroed fp32 (B, H, N, d) buffer with atomicAdd (the Pallas kernel's fp32 dq
// accumulator revisited across its sequential key grid); the caller casts it.
// Repeat runs differ in the last bits of dq (the order of the atomic
// additions); dk and dv repeat exactly. The design is in
// attention_bwd_common.cuh (bwd_fused_launch).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): K4's, at the dec1
// Nonlocal site of a training batch (B=8, H=1, N=M=3136, d=dv=64) 5.0e10 FLOP
// -> 0.05 ms against about 0.02 GB -> 0.006 ms, so operations bound it. CUDA
// cores; the logits are computed once per (key tile, query tile), where K4
// computes them twice, at the price of 64 d fp32 atomic additions per block
// and query tile.

#include "attention_bwd_common.cuh"

extern "C" int cenet_attention_bwd_fused(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout, const float* lse,
    float* delta, float* dq, void* dk, void* dv, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  // dq an fp32 buffer zeroed by the caller; dk, dv contiguous in q's dtype
  const cenet::Strides sdq{(long long)H * N * D, (long long)N * D, D}, sdk{(long long)H * M * D, (long long)M * D, D};
  cenet::BwdParams p{{q, nullptr}, {k, nullptr}, v, dout, nullptr, lse, nullptr, delta, nullptr,
                     {dq, nullptr}, {dk, nullptr}, dv, B, H, N, M, D, DV,
                     {{sqb, sqh, sqn}, {}}, {{skb, skh, skn}, {}}, {svb, svh, svn}, {sob, soh, son},
                     {sdq, {}}, {sdk, {}}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? cenet::bwd_fused_launch<__nv_bfloat16, 1>(p, s) : cenet::bwd_fused_launch<float, 1>(p, s);
}
