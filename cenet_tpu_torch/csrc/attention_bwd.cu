// Attention backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_pallas_attention_bwd_impl
// (bodies _attn_dq_kernel and _attn_dkv_kernel), the backward of pallas_attention:
//   P = exp(q k^T - lse), ds = P (dO v^T - Delta), Delta = rowsum(dO o) (given),
//   dq = round(ds) k,  dk = round(ds)^T q,  dv = round(P)^T dO,
// q pre-scaled, lse the forward's fp32 row log-sum-exp. Two kernels, dq and
// dk/dv, as the Pallas version splits them; each output element is written
// by one block, so repeat runs are bit-identical.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the dec1 Nonlocal
// site of a training batch (B=8, H=1, N=M=3136, d=dv=64) the least backward
// work is 2 N M (3d + 2dv) = 5.0e10 FLOP -> 0.05 ms, against about 0.02 GB of
// q, k, v, dO, dq, dk, dv and LSE -> 0.006 ms, so operations bound it. Both
// kernels recompute the logits (2 N M (4d + 3dv) in all).
//
// Two designs, chosen by dtype (both hand-written; neither stands in for the
// other on failure):
//   bf16  the tensor cores: mma.sync on bf16 tiles with fp32 sums
//         (attention_tc.cuh, attention_bwd_dq_tc_kernel and
//         attention_bwd_dkv_tc_kernel);
//   fp32  CUDA cores in fp32 FMA (attention_bwd_common.cuh, GROUPS = 1). The
//         tensor cores take fp32 only as TF32, which would break the fp32
//         kernel's 1e-4 agreement with its twin.

// Head dims past 128 (d, dv <= 512: the Nonlocal sites of the ResNet-50/101/152
// encoders) run the wide designs of attention_wide.cuh in both dtypes.

#include "attention_bwd_common.cuh"
#include "attention_tc.cuh"
#include "attention_wide.cuh"

extern "C" int cenet_attention_bwd(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout, const float* lse,
    float* delta, void* dq, void* dk, void* dv, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace tc = cenet::tc;
    const tc::BwdArgs a{tc::operand(q, sqb, sqh, sqn, B, H), tc::operand(k, skb, skh, skn, B, H),
                        tc::operand(v, svb, svh, svn, B, H), tc::operand(dout, sob, soh, son, B, H), lse, delta,
                        static_cast<tc::bf16*>(dq), static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv),
                        H, N, M, D, DV, tc::out_vec(dq, D), tc::out_vec(dk, D), tc::out_vec(dv, DV)};
    if (D > tc::MAX_DIM || DV > tc::MAX_DIM) return tc::bwd_wide_launch(a, B, s);
    return tc::bwd_launch(a, B, s);
  }
  // dq, dk, dv contiguous
  const cenet::Strides sdq{(long long)H * N * D, (long long)N * D, D}, sdk{(long long)H * M * D, (long long)M * D, D};
  cenet::BwdParams p{{q, nullptr}, {k, nullptr}, v, dout, nullptr, lse, nullptr, delta, nullptr,
                     {dq, nullptr}, {dk, nullptr}, dv, B, H, N, M, D, DV,
                     {{sqb, sqh, sqn}, {}}, {{skb, skh, skn}, {}}, {svb, svh, svn}, {sob, soh, son},
                     {sdq, {}}, {sdk, {}}};
  if (D > cenet::MAX_D || DV > cenet::MAX_DV) return cenet::wide::bwd_launch(p, s);
  return cenet::bwd_launch<float, 1>(p, s);
}
