"""K8's rounding contract in bf16: its twin against the Pallas kernel.

``attention_bwd_plain`` (the twin the tensor-core K8 is held to on the card)
against ``_pallas_attention_bwd_fused_impl`` in interpret mode, both on the
same bf16 inputs, o and fp32 LSE, at one small ragged shape (N and M not
multiples of the Pallas blocks, d ≠ dv): P and ds in fp32, ds rounded to bf16
before dq = ds k and dk = dsᵀ q, P before dv = Pᵀ dO, dq summed in fp32 and
cast once. They agree within two bf16 half-ulps of each gradient's largest
element (2·2^-8·max|g|, the base of the card's limits: the gradients' own
rounding, and P and ds values that round to the other side where the two sum
their fp32 logits in another order), and at least 99% of each gradient's
elements are equal to the bit. The second limit is the one that sees the
rounding points: the same twin without them (fp32 ds and P) stays inside the
first but matches only 58–60% of the elements here. K7's twin has a test of
the first kind (``tests/test_torch_split_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import torch

from cenet_tpu.ops.pallas_attention import _pallas_attention_bwd_fused_impl
from cenet_tpu_torch.ops import attention_kernels as K
from torch_parity import jit_bound, rand32, to_jax, to_torch


def test_fused_attention_bwd_twin_rounds_as_pallas_in_bf16():
    b, h, n, m, d, dv = 1, 2, 70, 50, 16, 24
    rng = np.random.default_rng(17)
    q = to_torch(rand32(rng, b, h, n, d) * d**-0.5).bfloat16()
    k, v = to_torch(rand32(rng, b, h, m, d)).bfloat16(), to_torch(rand32(rng, b, h, m, dv)).bfloat16()
    do = to_torch(rand32(rng, b, h, n, dv)).bfloat16()
    o, lse = K.attention_fwd_plain(q.float(), k.float(), v.float())
    o = o.bfloat16()
    got = K.attention_bwd_plain(q, k, v, o, lse, do)
    qj, kj, vj, oj, gj = (x.astype(jnp.bfloat16) for x in to_jax(q, k, v, o, do))
    want = jit_bound(_pallas_attention_bwd_fused_impl, interpret=True)(qj, kj, vj, oj, jnp.asarray(lse.numpy()), gj)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert a.dtype == torch.bfloat16 and str(want[0].dtype) == "bfloat16", name
        a = a.float().numpy()
        assert np.abs(a - w).max() <= 2 * 2.0**-8 * np.abs(w).max(), name
        assert (a == w).mean() >= 0.99, name
