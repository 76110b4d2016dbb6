"""The port's attention kernels: plain twins against the Pallas kernels, and routing.

On the CPU the twins are held against the Pallas kernels in interpret mode, on
``o`` and the row log-sum-exp, in fp32 at the tolerance of ``tests/test_ops.py``
(2e-5; the twins sum in another order). The CUDA kernels themselves are held
against their twins in ``tests/test_torch_cuda.py``, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.ops.pallas_attention import _diff_fwd_pair_impl, _pallas_attention_fwd_impl
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import router

# (b, h, n, m, d): ragged N/M (100, 196) and the slice's head dims
DIFF_SHAPES = [(2, 2, 100, 100, 8), (1, 2, 196, 196, 20), (1, 1, 64, 100, 16), (1, 1, 196, 49, 64)]
ATTN_SHAPES = [(2, 1, 100, 100, 64, 64), (1, 2, 196, 196, 16, 24), (1, 1, 100, 196, 8, 8), (1, 1, 64, 64, 20, 40)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("b,h,n,m,d", DIFF_SHAPES)
def test_diff_twin_matches_pallas(b, h, n, m, d):
    rng = np.random.default_rng(n * 7 + d)
    q = rng.standard_normal((b, 2 * h, n, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, 2 * h, m, d)).astype(np.float32)
    v = rng.standard_normal((b, h, m, 2 * d)).astype(np.float32)
    lam = np.float32(0.37)
    o_ref, l1, l2 = _diff_fwd_pair_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lam),
                                        interpret=True, with_lse=True)
    o, lse1, lse2 = K.diff_attention_interleaved_fwd(_t(q), _t(k), _t(v), torch.tensor(lam))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse1.numpy(), np.asarray(l1)[:, :n, 0].reshape(b, h, n), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(l2)[:, :n, 0].reshape(b, h, n), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,h,n,m,d,dv", ATTN_SHAPES)
def test_attention_twin_matches_pallas(b, h, n, m, d, dv):
    rng = np.random.default_rng(n * 5 + d)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, m, d)).astype(np.float32)
    v = rng.standard_normal((b, h, m, dv)).astype(np.float32)
    o_ref, lse_ref = _pallas_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                interpret=True, with_lse=True)
    o, lse = K.attention_fwd(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=2e-5, rtol=2e-5)


def test_router_takes_plain_math_on_cpu(monkeypatch):
    """CPU tensors take the plain path even above the size limit; the results are
    the kernels' functions and no kernel is launched."""
    monkeypatch.setattr(router, "_SMALL_LIMIT", 0)
    K.reset_launches()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 50, 8, generator=g)
    k = torch.randn(2, 4, 50, 8, generator=g)
    v = torch.randn(2, 2, 50, 16, generator=g)
    lam = torch.tensor(0.3)
    got = router.diff_attention_interleaved(q, k, v, lam)
    want = K.diff_attention_interleaved_fwd_plain(q, k, v, lam)[0]
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)
    got = router.flash_attention_core(q, k, k)
    torch.testing.assert_close(got, K.attention_fwd_plain(q, k, k)[0], atol=2e-6, rtol=2e-6)
    assert not any(K.LAUNCHES.values()), K.LAUNCHES
