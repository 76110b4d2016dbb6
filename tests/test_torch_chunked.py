"""The ``'chunked'`` attention impl: the JAX package's query-block scan, on the CPU.

``get_attention_core('chunked')`` is ``router.chunked_attention_core`` (JAX:
``cenet_tpu/ops/flash_attention.py::chunked_attention_core``); the diff sites
under ``'chunked'`` take plain math at most ``_SMALL_LIMIT`` and two scans
above it (``flash_attention.py:190-195``); ``MultiheadDiffAttnCross`` turns
``'xla'`` into ``'chunked'``, as JAX does. Each is held against the JAX
function at N not a multiple of 512 (a padded tail), forward and gradients
within 1e-5 in fp32, with both packages' limits shrunk so that small inputs
cross them; and above the limit no full (B, H, N, M) map is formed: every
block that reaches ``plain_attention`` has at most 512 query rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.nn import attention as jatt
from cenet_tpu.ops import flash_attention as jflash
from cenet_tpu_torch.nn import attention as tatt
from cenet_tpu_torch.ops import router
from torch_parity import jax_init, load_port

TOL = 1e-5
LIMIT = 1 << 20  # 1 MiB: a (1, 2, 600, 600) fp32 map (2.9 MB) lies above it


@pytest.fixture
def small_limit(monkeypatch):
    monkeypatch.setattr(router, "_SMALL_LIMIT", LIMIT)
    monkeypatch.setattr(jflash, "_SMALL_LIMIT", LIMIT)


@pytest.fixture
def blocks(monkeypatch):
    """The query rows of every map ``plain_attention`` forms."""
    rows = []
    plain = router.plain_attention

    def counted(q, k, v):
        rows.append(q.shape[2])
        return plain(q, k, v)

    monkeypatch.setattr(router, "plain_attention", counted)
    return rows


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL, err_msg=what)


def test_chunked_core_is_the_query_block_scan(blocks):
    """'chunked' names the scan; 'chunked@model' wraps it in ``shard_heads``,
    which without a mesh runs the bare scan."""
    assert tatt.get_attention_core("chunked") is router.chunked_attention_core
    q, k, v = (_t(a) for a in _arrays(np.random.default_rng(4), *[(1, 2, 600, 8)] * 3))
    assert torch.equal(tatt.get_attention_core("chunked@model")(q, k, v), router.chunked_attention_core(q, k, v))
    assert blocks == [512, 512] * 2


def test_chunked_core_matches_jax_with_a_padded_tail(blocks):
    """1100 queries: blocks of 512, 512 and a tail padded to 512; forward and
    the gradients of q, k, v against JAX's ``get_attention_core('chunked')``."""
    rng = np.random.default_rng(0)
    q, k, v, co = _arrays(rng, (1, 2, 1100, 8), (1, 2, 300, 8), (1, 2, 300, 16), (1, 2, 1100, 16))
    q *= 8 ** -0.5
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tatt.get_attention_core("chunked")(*xs)
    assert blocks == [512, 512, 512]  # never the whole (1, 2, 1100, 300) map
    (out * _t(co)).sum().backward()
    f = jax.jit(jatt.get_attention_core("chunked"))
    _close(out.detach(), f(q, k, v), "out")
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * co), argnums=(0, 1, 2)))(q, k, v)
    for name, x, w in zip("qkv", xs, grads):
        _close(x.grad, w, f"d{name}")
    assert len(blocks) == 6  # the backward forms each block's map once more, not the whole


def test_diff_core_above_the_limit_matches_jax(small_limit, blocks):
    """``diff_attention_chunked`` against ``diff_attention_core(impl='chunked')``
    above the limit: two scans, gradients of q1, k1, q2, k2, v and λ."""
    rng = np.random.default_rng(1)
    q1, k1, q2, k2, v, co = _arrays(rng, *[(1, 2, 600, 8)] * 4, (1, 2, 600, 16), (1, 2, 600, 16))
    lam = np.float32(0.37)
    xs = [_t(a).requires_grad_() for a in (q1, k1, q2, k2, v, lam)]
    out = router.diff_attention_chunked(*xs)
    assert blocks == [512, 512, 512, 512]  # two groups, two blocks each
    (out * _t(co)).sum().backward()
    f = jax.jit(lambda *a: jflash.diff_attention_core(*a, impl="chunked"))
    _close(out.detach(), f(q1, k1, q2, k2, v, lam), "out")
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * co), argnums=tuple(range(6))))(q1, k1, q2, k2, v, lam)
    for name, x, w in zip(("q1", "k1", "q2", "k2", "v", "lam"), xs, grads):
        _close(x.grad, w, f"d{name}")


def test_diff_core_at_the_limit_is_plain_math(blocks):
    """At or below the limit JAX takes plain math, and so does the port: the
    same bits as ``diff_attention_plain``, whole maps."""
    rng = np.random.default_rng(2)
    q1, k1, q2, k2, v = (_t(a) for a in _arrays(rng, *[(2, 2, 600, 8)] * 4, (2, 2, 600, 16)))
    lam = torch.tensor(0.25)
    assert torch.equal(router.diff_attention_chunked(q1, k1, q2, k2, v, lam),
                       router.diff_attention_plain(q1, k1, q2, k2, v, lam))
    assert set(blocks) == {600}


def test_chunked_core_on_meta_is_plain_math():
    """``model_cost`` counts on ``meta`` tensors: plain math, no padded rows."""
    q, k, v = (torch.empty(1, 2, 600, 8, device="meta") for _ in range(3))
    assert router.chunked_attention_core(q, k, v).shape == (1, 2, 600, 8)


@pytest.mark.parametrize("cls", ["MultiheadDiffAttn", "MultiheadDiffAttnCross"])
def test_diff_modules_under_chunked_match_jax(small_limit, blocks, cls):
    """The modules on 600 tokens above the shrunk limit: ``MultiheadDiffAttn``
    under ``'chunked'``, ``MultiheadDiffAttnCross`` under ``'xla'`` (which it
    turns into ``'chunked'``); forward and input gradients against JAX."""
    rng = np.random.default_rng(3)
    x, q_src, co = _arrays(rng, (1, 600, 32), (1, 600, 32), (1, 600, 32))
    impl = "chunked" if cls == "MultiheadDiffAttn" else "xla"
    jm = getattr(jatt, cls)(32, depth=2, num_heads=2, attn_impl=impl)
    args = (x,) if cls == "MultiheadDiffAttn" else (x, q_src)
    variables = jax_init(jm, *map(jnp.asarray, args))
    tm = load_port(getattr(tatt, cls)(32, depth=2, num_heads=2, attn_impl=impl), variables)
    xs = [_t(a).requires_grad_() for a in args]
    out = tm(*xs)
    assert blocks and max(blocks) == 512  # 600 rows in two blocks: no whole map
    (out * _t(co)).sum().backward()

    def f(*a):
        return jm.apply(variables, *a)

    _close(out.detach(), jax.jit(f)(*args), "out")
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * co), argnums=tuple(range(len(args)))))(*args)
    for i, (xt, w) in enumerate(zip(xs, grads)):
        _close(xt.grad, w, f"d input {i}")
