// Attention backward in one kernel, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_pallas_attention_bwd_fused_impl
// (body _attn_bwd_fused_kernel), which computes the same gradients as
// _pallas_attention_bwd_impl (attention_bwd.cu) and which no router of the
// JAX package calls:
//   P = exp(q k^T - lse), ds = P (dO v^T - Delta), Delta = rowsum(dO o) (given),
//   dq = round(ds) k,  dk = round(ds)^T q,  dv = round(P)^T dO.
// One launch: a block per (batch, head, key rows) walks the query tiles,
// writes its dk/dv rows, and adds each query tile's dq over its keys into a
// zeroed fp32 (B, H, N, d) buffer with atomic additions (the Pallas kernel's
// fp32 dq accumulator revisited across its sequential key grid); the caller
// casts it. Each (key tile, query tile) pair's logits are computed once,
// where K4 computes them twice. Repeat runs differ in the last bits of dq (the
// order of the atomic additions); dk and dv repeat exactly.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): K4's, at the dec1
// Nonlocal site of a training batch (B=8, H=1, N=M=3136, d=dv=64) 5.0e10 FLOP
// -> 0.05 ms against about 0.02 GB -> 0.006 ms, so operations bound it.
//
// Two designs, chosen by dtype (both hand-written; neither stands in for the
// other on failure):
//   bf16  the tensor cores: mma.sync on bf16 tiles with fp32 sums
//         (attention_tc.cuh, attention_bwd_fused_tc_kernel: K4's dk/dv tiles,
//         round(ds) through a shared tile into ds K, dq partials added with
//         16-byte vector reductions);
//   fp32  CUDA cores in fp32 FMA (attention_bwd_common.cuh, bwd_fused_launch,
//         64 d scalar atomic additions per block and query tile). The tensor
//         cores take fp32 only as TF32, which would break the fp32 kernel's
//         1e-4 agreement with its twin.

#include "attention_bwd_common.cuh"
#include "attention_tc.cuh"

extern "C" int cenet_attention_bwd_fused(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout, const float* lse,
    float* delta, float* dq, void* dk, void* dv, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  // dq an fp32 buffer zeroed by the caller; dk, dv contiguous in q's dtype
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace tc = cenet::tc;
    const tc::BwdArgs a{tc::operand(q, sqb, sqh, sqn, B, H), tc::operand(k, skb, skh, skn, B, H),
                        tc::operand(v, svb, svh, svn, B, H), tc::operand(dout, sob, soh, son, B, H), lse, delta,
                        nullptr, static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), H, N, M, D, DV, 0,
                        tc::out_vec(dk, D), tc::out_vec(dv, DV), dq};
    return tc::bwd_fused_launch(a, B, s);
  }
  const cenet::Strides sdq{(long long)H * N * D, (long long)N * D, D}, sdk{(long long)H * M * D, (long long)M * D, D};
  cenet::BwdParams p{{q, nullptr}, {k, nullptr}, v, dout, nullptr, lse, nullptr, delta, nullptr,
                     {dq, nullptr}, {dk, nullptr}, dv, B, H, N, M, D, DV,
                     {{sqb, sqh, sqn}, {}}, {{skb, skh, skn}, {}}, {svb, svh, svn}, {sob, soh, son},
                     {sdq, {}}, {sdk, {}}};
  return cenet::bwd_fused_launch<float, 1>(p, s);
}
