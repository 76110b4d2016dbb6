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
// after it. The design is in attention_bwd_common.cuh.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the DSEB1 site of a
// training batch (B=8, h=8, N=M=3136, d=8, dv=16) the least backward work is
// 2 N M (6d + 2dv) per head pair = 1.0e11 FLOP -> 0.10 ms, against about
// 0.03 GB of inputs and gradients -> 0.009 ms, so operations bound it. This
// first version runs on CUDA cores; it computes the logits of both groups and
// G three times (delta pass, dq, dk/dv), and d=8 and d=20 do not fill a
// 16-deep bf16 mma step, so a tensor-core version is later work.

#include "attention_bwd_common.cuh"

extern "C" int cenet_diff_attention_bwd(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout, const float* lam,
    const float* lse1, const float* lse2, float* delta1, float* delta2, void* dq, void* dk, void* dv,
    int B, int H, int N, int M, int D, int DV,
    long long sqb, long long sqh, long long sqn, long long skb, long long skh, long long skn,
    long long svb, long long svh, long long svn, long long sob, long long soh, long long son, void* stream) {
  // group g of head pair p is head 2p + g of q, k and of the contiguous dq, dk:
  // base + g head strides, head stride doubled
  const cenet::Strides sq{sqb, 2 * sqh, sqn}, sk{skb, 2 * skh, skn};
  const cenet::Strides sdq{2LL * H * N * D, 2LL * N * D, D}, sdk{2LL * H * M * D, 2LL * M * D, D};
  cenet::BwdParams p{{q, cenet::offset(q, sqh, is_bf16)}, {k, cenet::offset(k, skh, is_bf16)}, v, dout, lam,
                     lse1, lse2, delta1, delta2,
                     {dq, const_cast<void*>(cenet::offset(dq, (long long)N * D, is_bf16))},
                     {dk, const_cast<void*>(cenet::offset(dk, (long long)M * D, is_bf16))}, dv, B, H, N, M, D, DV,
                     {sq, sq}, {sk, sk}, {svb, svh, svn}, {sob, soh, son}, {sdq, sdq}, {sdk, sdk}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? cenet::bwd_launch<__nv_bfloat16, 2, false>(p, s) : cenet::bwd_launch<float, 2, false>(p, s);
}
