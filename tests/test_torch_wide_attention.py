"""K2 and K4's twins past head dim 128 against the Pallas kernels.

The Pallas kernels pad d and dv to multiples of 128
(``cenet_tpu/ops/pallas_attention.py``); the port's K2 and K4 take d, dv up to
512 on their wide designs (``csrc/attention_wide.cuh``), the ResNet-50/101/152
Nonlocal sites (d = dv = 256 and 512). Here, on the CPU, ``attention_fwd`` and
``attention_bwd`` run their plain twins and are held against
``_pallas_attention_fwd_impl`` and ``_pallas_attention_bwd_impl`` in interpret
mode, jitted, at small shapes past 128: a whole 256-wide chunk, ragged
widths on both sides of a 128-column chunk, two heads with d = 512 beside a
narrow dv, and ragged N and M. fp32 at the tolerance of
``tests/test_torch_kernels.py`` (2e-5) in both directions: the twins sum in
another order. The CUDA kernels are held against the twins in
``tests/test_torch_cuda.py``, which needs a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.ops.pallas_attention import _pallas_attention_bwd_impl, _pallas_attention_fwd_impl
from cenet_tpu_torch.ops import attention_kernels as K

# (b, h, n, m, d, dv)
WIDE_SHAPES = [(1, 1, 64, 64, 256, 256), (1, 1, 40, 33, 200, 300), (1, 2, 17, 65, 512, 136),
               (1, 1, 70, 9, 130, 16)]

_fwd = jax.jit(functools.partial(_pallas_attention_fwd_impl, interpret=True, with_lse=True))
_bwd = jax.jit(functools.partial(_pallas_attention_bwd_impl, interpret=True))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(b, h, n, m, d, dv):
    rng = np.random.default_rng(n * 3 + d + dv)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, m, d)).astype(np.float32)
    v = rng.standard_normal((b, h, m, dv)).astype(np.float32)
    g = rng.standard_normal((b, h, n, dv)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("b,h,n,m,d,dv", WIDE_SHAPES)
def test_wide_attention_twin_matches_pallas(b, h, n, m, d, dv):
    q, k, v, _ = _inputs(b, h, n, m, d, dv)
    o_ref, lse_ref = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = K.attention_fwd(_t(q), _t(k), _t(v))
    assert o.shape == (b, h, n, dv) and lse.shape == (b, h, n)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,h,n,m,d,dv", WIDE_SHAPES)
def test_wide_attention_backward_twin_matches_pallas(b, h, n, m, d, dv):
    q, k, v, g = _inputs(b, h, n, m, d, dv)
    o, lse = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = _bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(g))
    o_t, lse_t = K.attention_fwd_plain(_t(q), _t(k), _t(v))
    got = K.attention_bwd(_t(q), _t(k), _t(v), o_t, lse_t, _t(g))
    for name, a, w, shape in zip(["dq", "dk", "dv"], got, want, [q.shape, k.shape, v.shape]):
        assert tuple(a.shape) == shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5, err_msg=name)
