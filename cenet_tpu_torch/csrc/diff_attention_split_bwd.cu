// Split-group differential-attention backward in one kernel, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_diff_bwd_onekernel_impl
// (body _diff_bwd_onekernel), the backward of pallas_diff_attention that
// diff_attention_core reaches. For o = P1 V - lam P2 V on split q1/k1/q2/k2
// (B, h, N|M, d), any strides, shared v (B, h, M, dv), with G = dO V^T:
//   delta_g = rowsum(P_g G),  ds_g = P_g (G - delta_g),
//   dq_g = c_g round(ds_g) k_g,  dk_g = c_g round(ds_g)^T q_g   (c_1 = 1, c_2 = -lam),
//   dv = round(P1)^T dO - lam round(P2)^T dO  (P1 and P2 each rounded to dO's
//   dtype, the difference in fp32, as the Pallas kernel forms it),
//   dlam = -sum(delta_2) (summed by the caller).
//
// One launch. The Pallas kernel keeps dk1/dk2/dv in output blocks revisited
// across a sequential q grid; blocks on the card run in no order, so here a
// block per (batch, head, query rows) makes a delta pass over the keys, then,
// per key tile, forms its dq rows and the tile's dk1/dk2/dv over its query
// rows, and adds the latter into zeroed fp32 buffers (B, h, M, .) with atomic
// additions; the caller casts them. Repeat runs differ in the last bits of dk
// and dv (the order of the additions); dq and delta repeat exactly.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the DSEB1 site of a
// training batch (B=8, h=8, N=M=3136, d=8, dv=16) the least backward work is
// 2 N M (6d + 2dv) per head = 1.0e11 FLOP -> 0.10 ms, against about 0.03 GB
// of inputs and gradients -> 0.009 ms, so operations bound it. Two passes over
// the keys (delta, then the gradients), so 2 exponentials per logit and group,
// against 3 for K3 and K7; the reductions add BM-query partials of 16 keys x
// (2d + dv) per block and key tile.
//
// Two designs, chosen by dtype (both hand-written; neither stands in for the
// other on failure):
//   bf16  the tensor cores (diff_attention_tc.cuh, diff_bwd_one_tc_kernel): the
//         dq kernel of K3 on the split views, whose pass 2 also writes round(ds_g)
//         and round(P_g) to shared tiles, reads them back transposed with
//         ldmatrix.trans for dk_g and dv (P1^T and P2^T in two accumulators) and
//         adds them with 16-byte red.global.add.v4.f32;
//   fp32  CUDA cores in fp32 FMA (attention_bwd_common.cuh, bwd_fused_launch:
//         64 query rows a block, scalar atomicAdd). The tensor cores take fp32
//         only as TF32, which would break the fp32 kernel's 1e-4 agreement with
//         its twin.

#include "attention_bwd_common.cuh"
#include "diff_attention_tc.cuh"

extern "C" int cenet_diff_attention_split_bwd(
    int is_bf16, const void* q1, const void* k1, const void* q2, const void* k2, const void* v, const void* dout,
    const float* lam, const float* lse1, const float* lse2, float* delta1, float* delta2,
    void* dq1, float* dk1, void* dq2, float* dk2, float* dv, int B, int H, int N, int M, int D, int DV,
    long long sq1b, long long sq1h, long long sq1n, long long sk1b, long long sk1h, long long sk1n,
    long long sq2b, long long sq2h, long long sq2n, long long sk2b, long long sk2h, long long sk2n,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  // dq_g contiguous (B, h, N, d) in q's dtype; dk_g (B, h, M, d) and dv fp32 buffers, zeroed by the caller
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace tc = cenet::tc;
    auto in = [&](const void* x, long long sb, long long sh, long long sn) { return tc::operand(x, sb, sh, sn, B, H); };
    auto out = [&](void* x) { return tc::out_rows(x, (long long)H * N * D, (long long)N * D, D); };
    const tc::DiffBwdArgs a{{in(q1, sq1b, sq1h, sq1n), in(q2, sq2b, sq2h, sq2n)},
                            {in(k1, sk1b, sk1h, sk1n), in(k2, sk2b, sk2h, sk2n)},
                            in(v, svb, svh, svn), in(dout, sob, soh, son), lam,
                            {lse1, lse2}, {delta1, delta2}, {out(dq1), out(dq2)}, {}, nullptr, H, N, M, D, DV, 0,
                            {dk1, dk2}, dv};
    return tc::diff_bwd_one_launch(a, B, s);
  }
  const cenet::Strides sdq{(long long)H * N * D, (long long)N * D, D}, sdk{(long long)H * M * D, (long long)M * D, D};
  cenet::BwdParams p{{q1, q2}, {k1, k2}, v, dout, lam, lse1, lse2, delta1, delta2, {dq1, dq2}, {dk1, dk2}, dv,
                     B, H, N, M, D, DV, {{sq1b, sq1h, sq1n}, {sq2b, sq2h, sq2n}},
                     {{sk1b, sk1h, sk1n}, {sk2b, sk2h, sk2n}}, {svb, svh, svn}, {sob, soh, son},
                     {sdq, sdq}, {sdk, sdk}};
  return cenet::bwd_fused_launch<float, 2>(p, s);
}
