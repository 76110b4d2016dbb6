// Interleaved differential-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_diff_fwd_pair_impl
// (body _diff_fwd_pair_kernel), reached through pallas_diff_attention_interleaved:
//   o = softmax(q1 k1^T) V - lam * softmax(q2 k2^T) V,
// q/k (B, 2h, N, d) with even heads group 1 and odd heads group 2, shared
// v (B, h, M, 2d), q pre-scaled, lam an fp32 device scalar. Returns o in q's
// dtype and both groups' fp32 row log-sum-exp. The design is in
// attention_fwd_common.cuh.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the DSEB1 site of a
// 32-slice chunk (B=32, h=8, N=M=3136, d=8) it does 1.61e11 FLOP -> 0.16 ms,
// and moves about 0.11 GB -> 0.03 ms, so operations bound it. Its 5.0e9 fp32
// exponentials (counted once per logit; this two-pass design computes each
// twice) are about 1.2 ms of special-function-unit time, the practical limit
// at d=8. This first version runs on CUDA cores (fp32 FMA); d=8 and d=20 are
// not multiples of the 16-wide bf16 mma k-step, so a tensor-core version
// needs zero padding and is later work.

#include "attention_fwd_common.cuh"

extern "C" int cenet_diff_attention_fwd(
    int is_bf16, const void* q, const void* k, const void* v, const float* lam,
    void* o, float* lse1, float* lse2, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, void* stream) {
  // group g of head pair p is head 2p + g: base + g head strides, head stride doubled
  cenet::Params p{{q, cenet::offset(q, sqh, is_bf16)}, {k, cenet::offset(k, skh, is_bf16)}, v, lam, o, lse1, lse2,
                  B, H, N, M, D, DV, {{sqb, 2 * sqh, sqn}, {sqb, 2 * sqh, sqn}},
                  {{skb, 2 * skh, skn}, {skb, 2 * skh, skn}}, {svb, svh, svn}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? cenet::launch<__nv_bfloat16, 2>(p, s) : cenet::launch<float, 2>(p, s);
}
