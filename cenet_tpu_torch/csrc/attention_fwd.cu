// Attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_pallas_attention_fwd_impl
// (body _attn_fwd_kernel), reached through pallas_attention:
//   o = softmax(q k^T) v,  q/k (B, H, N|M, d), v (B, H, M, dv), q pre-scaled,
// with the whole-row fp32 softmax and deferred normalisation of the Pallas
// kernel. Returns o in q's dtype and the fp32 row log-sum-exp.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the dec1 Nonlocal
// site of a 32-slice chunk (B=32, H=1, N=M=3136, d=dv=64) it does 8.1e10 FLOP
// -> 0.08 ms and moves about 0.05 GB -> 0.015 ms, so operations bound it.
//
// Two designs, chosen by dtype (both hand-written; neither stands in for the
// other on failure):
//   bf16  the tensor cores: mma.sync on bf16 tiles with fp32 sums
//         (attention_tc.cuh, attention_fwd_tc_kernel);
//   fp32  CUDA cores in fp32 FMA (attention_fwd_common.cuh, GROUPS = 1). The
//         tensor cores take fp32 only as TF32, whose 10-bit mantissa would
//         break the fp32 kernel's 1e-4 agreement with its twin.

// Head dims past 128 (d, dv <= 512: the Nonlocal sites of the ResNet-50/101/152
// encoders) run the wide designs of attention_wide.cuh in both dtypes.

#include "attention_fwd_common.cuh"
#include "attention_tc.cuh"
#include "attention_wide.cuh"

extern "C" int cenet_attention_fwd(
    int is_bf16, const void* q, const void* k, const void* v,
    void* o, float* lse, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace tc = cenet::tc;
    const tc::FwdArgs a{tc::operand(q, sqb, sqh, sqn, B, H), tc::operand(k, skb, skh, skn, B, H),
                        tc::operand(v, svb, svh, svn, B, H), static_cast<tc::bf16*>(o), lse, H, N, M, D, DV,
                        tc::out_vec(o, DV)};
    if (D > tc::MAX_DIM || DV > tc::MAX_DIM) return tc::fwd_wide_launch(a, B, s);
    return tc::fwd_launch(a, B, s);
  }
  cenet::Params p{{q, nullptr}, {k, nullptr}, v, nullptr, o, lse, nullptr, B, H, N, M, D, DV,
                  {{sqb, sqh, sqn}, {}}, {{skb, skh, skn}, {}}, {svb, svh, svn}};
  if (D > cenet::MAX_D || DV > cenet::MAX_DV) return cenet::wide::fwd_launch(p, s);
  return cenet::launch<1>(p, s);
}
