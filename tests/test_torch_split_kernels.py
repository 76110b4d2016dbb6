"""The split-group kernels' twins against the Pallas kernels in interpret mode.

* K5's twin (``diff_attention_fwd_plain``) against ``_diff_fwd_impl``, fed the
  ``0::2``/``1::2`` head views of interleaved projections, at the ragged shapes
  of ``tests/test_ops.py``: o and both LSEs, fp32, 2e-5.
* The K6/K7 twin (``diff_attention_bwd_plain``: K6 and K7 compute the same
  function) against both ``_diff_bwd_onekernel_impl`` (block_q = 128, so dk and
  dv sum over two query blocks where N > 128) and ``_diff_bwd_impl`` on the same
  inputs and LSEs: the six gradients, fp32, 3e-4 (``tests/test_ops.py``'s
  tolerance); and in bf16 at a tiny shape, within 2·2^-8·max|g|, so that the
  twin's rounding points (each P rounded to dO's dtype before dv, −λ applied in
  fp32 before the cast) are JAX's.
* K8's function: ``attention_bwd_plain`` against
  ``_pallas_attention_bwd_fused_impl``, fp32, 3e-4.

The CUDA kernels themselves are held against the twins in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.ops.pallas_attention import (_diff_bwd_impl, _diff_bwd_onekernel_impl, _diff_fwd_impl,
                                            _pallas_attention_bwd_fused_impl, _pallas_attention_fwd_impl)
from cenet_tpu_torch.ops import attention_kernels as K
from torch_parity import assert_all_close, head_groups, interleaved_qkv, jit_bound, rand32, to_jax, to_torch

# (b, h, n, m, d, dv): tests/test_ops.py's ragged shapes for the split kernels
FWD_SHAPES = [(2, 4, 100, 100, 4, 8), (1, 2, 196, 49, 16, 32), (1, 1, 300, 300, 8, 16)]
BWD_SHAPES = [(1, 1, 100, 49, 8, 24), (2, 2, 196, 196, 4, 8)]
ATTN_SHAPES = [(1, 1, 100, 49, 8, 24), (2, 1, 196, 196, 20, 40)]
GRADS = ["dq1", "dk1", "dq2", "dk2", "dv", "dlam"]


@pytest.mark.parametrize("b,h,n,m,d,dv", FWD_SHAPES)
def test_split_fwd_twin_matches_pallas(b, h, n, m, d, dv):
    q, k, v = interleaved_qkv(np.random.default_rng(n + d), b, h, n, m, d, dv)
    lam = torch.tensor(0.37)
    groups = head_groups(q, k)
    want = jit_bound(_diff_fwd_impl, interpret=True, with_lse=True)(*to_jax(*groups, v, lam))
    got = K.diff_attention_fwd(*groups, v, lam)
    assert_all_close(got, want, 2e-5, ["o", "lse1", "lse2"])


def _split_bwd_case(b, h, n, m, d, dv, dtype, seed):
    """Inputs in ``dtype`` (torch and JAX alike), λ, dO and the LSEs of the fp32
    forward ``_diff_fwd_impl``; returns (torch args, JAX args, o)."""
    rng = np.random.default_rng(seed)
    q, k, v = interleaved_qkv(rng, b, h, n, m, d, dv)
    do = to_torch(rand32(rng, b, h, n, dv))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    lam = torch.tensor(0.45)
    groups = head_groups(q, k)
    o, l1, l2 = jit_bound(_diff_fwd_impl, interpret=True, with_lse=True)(*to_jax(*groups, v, lam))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q1, k1, q2, k2, vj, doj = (x.astype(jdt) for x in to_jax(*groups, v, do))
    return (*groups, v, lam, to_torch(l1), to_torch(l2), do), (q1, k1, q2, k2, vj, jnp.float32(0.45), l1, l2, doj), o


@pytest.mark.parametrize("b,h,n,m,d,dv", BWD_SHAPES)
def test_split_bwd_twin_matches_both_pallas_backwards(b, h, n, m, d, dv):
    targs, jargs, o = _split_bwd_case(b, h, n, m, d, dv, torch.float32, seed=n + d + 2)
    got = K.diff_attention_bwd(*targs)
    assert_all_close(got, jit_bound(_diff_bwd_onekernel_impl, block_q=128, interpret=True)(*jargs), 3e-4, GRADS)
    q1, k1, q2, k2, v, lam, l1, l2, g = jargs
    assert_all_close(got, jit_bound(_diff_bwd_impl, interpret=True)(q1, k1, q2, k2, v, lam, o, l1, l2, g), 3e-4,
                     GRADS)
    assert_all_close(K.diff_attention_bwd_split(*targs), got, 0.0, GRADS)  # one twin for K6 and K7


def test_split_bwd_twin_rounds_as_pallas_in_bf16():
    """bf16 inputs: ds and each P are rounded to bf16 before the products, and the
    gradients on output, in the twin as in both Pallas backwards; they agree to
    two bf16 half-ulps of each gradient's largest element (dλ stays fp32)."""
    targs, jargs, o = _split_bwd_case(1, 2, 70, 50, 8, 16, torch.bfloat16, seed=5)
    got = K.diff_attention_bwd_plain(*targs)
    q1, k1, q2, k2, v, lam, l1, l2, g = jargs
    for want in (jit_bound(_diff_bwd_onekernel_impl, block_q=128, interpret=True)(*jargs),
                 jit_bound(_diff_bwd_impl, interpret=True)(q1, k1, q2, k2, v, lam, o.astype(jnp.bfloat16), l1, l2,
                                                           g)):
        for name, a, w in zip(GRADS, got, want):
            w = np.asarray(w, np.float32)
            assert a.dtype == (torch.float32 if name == "dlam" else torch.bfloat16), name
            lim = 1e-4 * max(1.0, abs(float(w))) if name == "dlam" else 2 * 2.0**-8 * np.abs(w).max()
            assert np.abs(a.float().numpy() - w).max() <= lim, name


@pytest.mark.parametrize("b,h,n,m,d,dv", ATTN_SHAPES)
def test_fused_attention_bwd_function_matches_pallas(b, h, n, m, d, dv):
    rng = np.random.default_rng(n + d + 3)
    q = to_torch(rand32(rng, b, h, n, d) * d**-0.5)
    k, v, g = to_torch(rand32(rng, b, h, m, d)), to_torch(rand32(rng, b, h, m, dv)), to_torch(rand32(rng, b, h, n, dv))
    o, lse = jit_bound(_pallas_attention_fwd_impl, interpret=True, with_lse=True)(*to_jax(q, k, v))
    want = jit_bound(_pallas_attention_bwd_fused_impl, interpret=True)(*to_jax(q, k, v), o, lse, *to_jax(g))
    got = K.attention_bwd_fused(q, k, v, to_torch(o), to_torch(lse), g)
    assert_all_close(got, want, 3e-4, ["dq", "dk", "dv"])
