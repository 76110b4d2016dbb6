// Interleaved differential-attention backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_diff_bwd_pair_impl
// (body _diff_bwd_pair_kernel), the backward of pallas_diff_attention_interleaved:
// for o = P1 V - lam P2 V on the interleaved layout (q/k (B, 2h, N, d), even
// heads group 1; shared v (B, h, M, 2d)), with G = dO V^T,
//   delta_g = rowsum(P_g G),  ds_g = P_g (G - delta_g),
//   dq_g = c_g round(ds_g) k_g,  dk_g = c_g round(ds_g)^T q_g   (c_1 = 1, c_2 = -lam),
//   dv = round(P1 - lam P2)^T dO,  dlam = -sum(delta_2) (summed by the caller).
// lam is read from device memory. The dq kernel makes a first pass over the
// keys for delta_g and writes delta_1, delta_2 out; the dk/dv kernel runs
// after it. Each output element is written by one block, so repeat runs are
// bit-identical.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the DSEB1 site of a
// training batch (B=8, h=8, N=M=3136, d=8, dv=16) the least backward work is
// 2 N M (6d + 2dv) per head pair = 1.0e11 FLOP -> 0.10 ms, against about
// 0.03 GB of inputs and gradients -> 0.009 ms, so operations bound it. Both
// designs compute the logits of both groups and G three times (delta pass,
// dq, dk/dv), so 3 exponentials per logit and group: 3.8e9 at DSEB1, about
// 0.9 ms of special-function-unit time at 16 per SM per clock.
//
// Two designs, chosen by dtype (both hand-written; neither stands in for the
// other on failure):
//   bf16  the tensor cores: mma.sync on bf16 tiles with fp32 sums
//         (diff_attention_tc.cuh, diff_bwd_dq_tc_kernel and
//         diff_bwd_dkv_tc_kernel);
//   fp32  CUDA cores in fp32 FMA (attention_bwd_common.cuh, GROUPS = 2). The
//         tensor cores take fp32 only as TF32, which would break the fp32
//         kernel's 1e-4 agreement with its twin.
//
// Head dims past 128 (d <= 1024, dv <= 2048) run the wide designs of
// diff_attention_wide.cuh in both dtypes: a delta kernel, then a dq and a
// dk/dv kernel over column slices of the gradients, still without atomics.

#include "attention_bwd_common.cuh"
#include "diff_attention_tc.cuh"
#include "diff_attention_wide.cuh"

extern "C" int cenet_diff_attention_bwd(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout, const float* lam,
    const float* lse1, const float* lse2, float* delta1, float* delta2, void* dq, void* dk, void* dv,
    int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  // group g of head pair p is head 2p + g of q, k and of the contiguous dq, dk:
  // base + g head strides, head stride doubled
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace tc = cenet::tc;
    auto group = [&](const void* x, int g, long long sb, long long sh, long long sn) {
      return tc::operand(cenet::offset<tc::bf16>(x, g * sh), sb, 2 * sh, sn, B, H);
    };
    auto out = [&](void* x, int g, int rows) {
      return tc::out_rows(const_cast<void*>(cenet::offset<tc::bf16>(x, (long long)g * rows * D)),
                          2LL * H * rows * D, 2LL * rows * D, D);
    };
    const tc::DiffBwdArgs a{{group(q, 0, sqb, sqh, sqn), group(q, 1, sqb, sqh, sqn)},
                            {group(k, 0, skb, skh, skn), group(k, 1, skb, skh, skn)},
                            tc::operand(v, svb, svh, svn, B, H), tc::operand(dout, sob, soh, son, B, H), lam,
                            {lse1, lse2}, {delta1, delta2}, {out(dq, 0, N), out(dq, 1, N)},
                            {out(dk, 0, M), out(dk, 1, M)}, static_cast<tc::bf16*>(dv), H, N, M, D, DV,
                            tc::out_vec(dv, DV)};
    if (D > tc::MAX_DIM || DV > tc::MAX_DIM) return cenet::dwide::bwd_tc_launch(a, B, s);
    return tc::diff_bwd_launch(a, B, s);
  }
  const cenet::Strides sq{sqb, 2 * sqh, sqn}, sk{skb, 2 * skh, skn};
  const cenet::Strides sdq{2LL * H * N * D, 2LL * N * D, D}, sdk{2LL * H * M * D, 2LL * M * D, D};
  cenet::BwdParams p{{q, cenet::offset<float>(q, sqh)}, {k, cenet::offset<float>(k, skh)}, v, dout, lam,
                     lse1, lse2, delta1, delta2,
                     {dq, const_cast<void*>(cenet::offset<float>(dq, (long long)N * D))},
                     {dk, const_cast<void*>(cenet::offset<float>(dk, (long long)M * D))}, dv, B, H, N, M, D, DV,
                     {sq, sq}, {sk, sk}, {svb, svh, svn}, {sob, soh, son}, {sdq, sdq}, {sdk, sdk}};
  if (D > cenet::MAX_D || DV > cenet::MAX_DV) return cenet::dwide::bwd_f32_launch(p, s);
  return cenet::bwd_launch<float, 2, false>(p, s);
}
