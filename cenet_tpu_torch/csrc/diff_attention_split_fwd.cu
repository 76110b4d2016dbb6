// Split-group differential-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cenet_tpu/ops/pallas_attention.py::_diff_fwd_impl
// (body _diff_fwd_kernel), reached through pallas_diff_attention from
// diff_attention_core when the interleaved pair kernel is not taken:
//   o = softmax(q1 k1^T) V - lam * softmax(q2 k2^T) V,
// q1, q2 (B, h, N, d) and k1, k2 (B, h, M, d) as four separate operands, each
// with its own batch/head/row strides (the 0::2 and 1::2 head views of the
// projections are read in place, never copied), shared v (B, h, M, dv), q
// pre-scaled, lam an fp32 device scalar. Returns o in q's dtype and both
// groups' fp32 row log-sum-exp. It is K1's kernel in both dtypes, with the two
// groups' pointers and strides passed apart, so on the head views of K1's
// interleaved inputs it gives K1's bits.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the same work as K1;
// at the DSEB1 site of a 32-slice chunk (B=32, h=8, N=M=3136, d=8, dv=16)
// 1.61e11 FLOP -> 0.16 ms against about 0.11 GB -> 0.03 ms, so operations
// bound it.
//
// Two designs, chosen by dtype, as K1's (diff_attention_fwd.cu):
//   bf16  the tensor cores (diff_attention_tc.cuh, diff_fwd_tc_kernel);
//   fp32  CUDA cores in fp32 FMA (attention_fwd_common.cuh, GROUPS = 2).

#include "attention_fwd_common.cuh"
#include "diff_attention_tc.cuh"

extern "C" int cenet_diff_attention_split_fwd(
    int is_bf16, const void* q1, const void* k1, const void* q2, const void* k2, const void* v,
    const float* lam, void* o, float* lse1, float* lse2, int B, int H, int N, int M, int D, int DV,
    long long sq1b, long long sq1h, long long sq1n, long long sk1b, long long sk1h, long long sk1n,
    long long sq2b, long long sq2h, long long sq2n, long long sk2b, long long sk2h, long long sk2n,
    long long svb, long long svh, long long svn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace tc = cenet::tc;
    const tc::DiffFwdArgs a{{tc::operand(q1, sq1b, sq1h, sq1n, B, H), tc::operand(q2, sq2b, sq2h, sq2n, B, H)},
                            {tc::operand(k1, sk1b, sk1h, sk1n, B, H), tc::operand(k2, sk2b, sk2h, sk2n, B, H)},
                            tc::operand(v, svb, svh, svn, B, H), lam, static_cast<tc::bf16*>(o), {lse1, lse2},
                            H, N, M, D, DV, tc::out_vec(o, DV)};
    return tc::diff_fwd_launch(a, B, s);
  }
  cenet::Params p{{q1, q2}, {k1, k2}, v, lam, o, lse1, lse2, B, H, N, M, D, DV,
                  {{sq1b, sq1h, sq1n}, {sq2b, sq2h, sq2n}}, {{sk1b, sk1h, sk1n}, {sk2b, sk2h, sk2n}},
                  {svb, svh, svn}};
  return cenet::launch<2>(p, s);
}
