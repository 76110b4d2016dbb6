// Interleaved differential-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_diff_fwd_pair_impl
// (body _diff_fwd_pair_kernel), reached through pallas_diff_attention_interleaved:
//   o = softmax(q1 k1^T) V - lam * softmax(q2 k2^T) V,
// q/k (B, 2h, N, d) with even heads group 1 and odd heads group 2, shared
// v (B, h, M, 2d), q pre-scaled, lam an fp32 device scalar. Returns o in q's
// dtype and both groups' fp32 row log-sum-exp.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the DSEB1 site of a
// 32-slice chunk (B=32, h=8, N=M=3136, d=8) it does 1.61e11 FLOP -> 0.16 ms,
// and moves about 0.11 GB -> 0.03 ms, so operations bound it. Its 5.0e9 fp32
// exponentials (counted once per logit; the two-pass designs compute each
// twice) are about 1.2 ms of special-function-unit time at 16 per SM per
// clock, the practical limit at d = 8.
//
// Two designs, chosen by dtype (both hand-written; neither stands in for the
// other on failure):
//   bf16  the tensor cores: mma.sync on bf16 tiles with fp32 sums
//         (diff_attention_tc.cuh, diff_fwd_tc_kernel);
//   fp32  CUDA cores in fp32 FMA (attention_fwd_common.cuh, GROUPS = 2). The
//         tensor cores take fp32 only as TF32, whose 10-bit mantissa would
//         break the fp32 kernel's 1e-4 agreement with its twin.
//
// Head dims past 128 (d <= 1024, dv <= 2048: the DSEBs of a ResNet CENet, a
// PVT CENet's DSEB3 at large batches) run the wide designs of
// diff_attention_wide.cuh in both dtypes; at d, dv <= 128 the designs above.

#include "attention_fwd_common.cuh"
#include "diff_attention_tc.cuh"
#include "diff_attention_wide.cuh"

extern "C" int cenet_diff_attention_fwd(
    int is_bf16, const void* q, const void* k, const void* v, const float* lam,
    void* o, float* lse1, float* lse2, int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, void* stream) {
  // group g of head pair p is head 2p + g: base + g head strides, head stride doubled
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace tc = cenet::tc;
    auto group = [&](const void* x, int g, long long sb, long long sh, long long sn) {
      return tc::operand(cenet::offset<tc::bf16>(x, g * sh), sb, 2 * sh, sn, B, H);
    };
    const tc::DiffFwdArgs a{{group(q, 0, sqb, sqh, sqn), group(q, 1, sqb, sqh, sqn)},
                            {group(k, 0, skb, skh, skn), group(k, 1, skb, skh, skn)},
                            tc::operand(v, svb, svh, svn, B, H), lam, static_cast<tc::bf16*>(o), {lse1, lse2},
                            H, N, M, D, DV, tc::out_vec(o, DV)};
    if (D > tc::MAX_DIM || DV > tc::MAX_DIM) return cenet::dwide::fwd_tc_launch(a, B, s);
    return tc::diff_fwd_launch(a, B, s);
  }
  cenet::Params p{{q, cenet::offset<float>(q, sqh)}, {k, cenet::offset<float>(k, skh)}, v, lam, o, lse1, lse2,
                  B, H, N, M, D, DV, {{sqb, 2 * sqh, sqn}, {sqb, 2 * sqh, sqn}},
                  {{skb, 2 * skh, skn}, {skb, 2 * skh, skn}}, {svb, svh, svn}};
  if (D > cenet::MAX_D || DV > cenet::MAX_DV) return cenet::dwide::fwd_f32_launch(p, s);
  return cenet::launch<2>(p, s);
}
