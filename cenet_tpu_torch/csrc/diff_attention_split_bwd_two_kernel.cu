// Split-group differential-attention backward in two kernels, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_diff_bwd_impl
// (bodies _diff_dq_kernel and _diff_dkv_kernel), which computes the same
// gradients as _diff_bwd_onekernel_impl (diff_attention_split_bwd.cu) and which
// no router of the JAX package calls. For o = P1 V - lam P2 V on split
// q1/k1/q2/k2 (B, h, N|M, d), any strides, shared v (B, h, M, dv):
//   a dq kernel: delta_1, delta_2 (written out; dlam = -sum(delta_2), summed by
//   the caller), then dq1, dq2 = -lam round(ds_2) k_2;
//   a dk/dv kernel: dk1, dk2 = -lam round(ds_2)^T q_2 and
//   dv = round(P1)^T dO - lam round(P2)^T dO (each P rounded to dO's dtype).
// It is the interleaved K3's split (attention_bwd_common.cuh, bwd_launch) on
// split pointers with the split-group dv rounding. Every output element is
// written by one block, so repeat runs are bit-identical.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the least work for the
// function, as for diff_attention_split_bwd.cu: at DSEB1 of a training batch
// 1.0e11 FLOP -> 0.10 ms, operations bound. CUDA cores; the logits and G are
// computed three times (delta pass, dq, dk/dv).

#include "attention_bwd_common.cuh"

extern "C" int cenet_diff_attention_split_bwd_two_kernel(
    int is_bf16, const void* q1, const void* k1, const void* q2, const void* k2, const void* v, const void* dout,
    const float* lam, const float* lse1, const float* lse2, float* delta1, float* delta2,
    void* dq1, void* dk1, void* dq2, void* dk2, void* dv, int B, int H, int N, int M, int D, int DV,
    long long sq1b, long long sq1h, long long sq1n, long long sk1b, long long sk1h, long long sk1n,
    long long sq2b, long long sq2h, long long sq2n, long long sk2b, long long sk2h, long long sk2n,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  // dq_g (B, h, N, d), dk_g (B, h, M, d) and dv contiguous in q's dtype
  const cenet::Strides sdq{(long long)H * N * D, (long long)N * D, D}, sdk{(long long)H * M * D, (long long)M * D, D};
  cenet::BwdParams p{{q1, q2}, {k1, k2}, v, dout, lam, lse1, lse2, delta1, delta2, {dq1, dq2}, {dk1, dk2}, dv,
                     B, H, N, M, D, DV, {{sq1b, sq1h, sq1n}, {sq2b, sq2h, sq2n}},
                     {{sk1b, sk1h, sk1n}, {sk2b, sk2h, sk2n}}, {svb, svh, svn}, {sob, soh, son},
                     {sdq, sdq}, {sdk, sdk}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? cenet::bwd_launch<__nv_bfloat16, 2, true>(p, s) : cenet::bwd_launch<float, 2, true>(p, s);
}
