"""Port parity, part 2: the attention modules against the JAX package.

The JAX side runs with its Pallas kernels forced on (interpret mode, size limit
0, as ``tests/test_tp_attention.py`` does); the port runs on the CPU, where its
router takes the kernels' plain twins. fp32, max abs error ≤ 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.nn import attention as jatt
from cenet_tpu_torch.nn import attention as tatt
from torch_parity import jax_init, load_port, nchw, nhwc, randomize_stats

ATOL = 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    from cenet_tpu.ops import flash_attention, pallas_attention

    monkeypatch.setattr(pallas_attention, "_INTERPRET", True)
    monkeypatch.setattr(flash_attention, "_SMALL_LIMIT", 0)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("impl,heads,kv_heads,n", [
    ("pallas", 4, None, 100), ("pallas", 2, None, 196), ("xla", 4, None, 100), ("xla", 4, 2, 64),
    ("chunked", 4, None, 100),
])
def test_multihead_diff_attn_matches_jax(pallas_interpret, impl, heads, kv_heads, n):
    x = _x((2, n, 64))
    jm = jatt.MultiheadDiffAttn(64, depth=2, num_heads=heads, num_kv_heads=kv_heads, attn_impl=impl)
    v = jax_init(jm, jnp.asarray(x))
    tm = load_port(tatt.MultiheadDiffAttn(64, depth=2, num_heads=heads, num_kv_heads=kv_heads, attn_impl=impl), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_nonlocal_matches_jax(pallas_interpret, impl):
    x = _x((2, 10, 12, 16))
    jm = jatt.Nonlocal(16, attn_impl=impl)
    v = randomize_stats(jax_init(jm, jnp.asarray(x)))
    v["params"]["w"] = np.float32(0.3)
    tm = load_port(tatt.Nonlocal(16, attn_impl=impl), v)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("sr_ratio,heads", [(2, 2), (1, 4)])
def test_sra_attention_matches_jax(pallas_interpret, sr_ratio, heads):
    H, W = 8, 12
    x = _x((2, H * W, 32))
    jm = jatt.SRAAttention(32, num_heads=heads, qkv_bias=True, sr_ratio=sr_ratio, attn_impl="pallas")
    v = jax_init(jm, jnp.asarray(x), H=H, W=W)
    tm = load_port(tatt.SRAAttention(32, num_heads=heads, qkv_bias=True, sr_ratio=sr_ratio, attn_impl="pallas"), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x), H, W)), atol=ATOL, rtol=ATOL)


def test_lambda_init_matches_jax():
    for depth in range(1, 6):
        assert tatt.lambda_init_fn(depth) == jatt.lambda_init_fn(depth)
