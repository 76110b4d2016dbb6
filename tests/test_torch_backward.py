"""The port's backward kernels: plain twins against the Pallas backward kernels,
and the autograd Functions and routing around them.

* K3's twin (``diff_attention_interleaved_bwd_plain``) against
  ``_diff_bwd_pair_impl`` and K4's twin (``attention_bwd_plain``) against
  ``_pallas_attention_bwd_impl``, both in interpret mode, at the ragged shapes of
  ``tests/test_ops.py`` plus the slice's head dims, fp32 at that file's
  tolerances (3e-4 and 2e-4): dq, dk, dv and dλ.
* The two ``torch.autograd.Function``s on the CPU (twin forward, twin backward)
  against autograd of the plain forward, within 2e-5 (fp32, another order of
  summation).
* The router reaches the Functions when autograd records and the forward
  kernels alone under ``inference_mode``, where nothing is saved.

The CUDA kernels themselves are held against the twins in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.ops.pallas_attention import (_diff_bwd_pair_impl, _diff_fwd_pair_impl,
                                            _pallas_attention_bwd_impl, _pallas_attention_fwd_impl)
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import router

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it:
# in the parallel test run torch's default pool spins against the other workers.
torch.set_num_threads(1)

# (b, h, n, m, d, dv): tests/test_ops.py's ragged shapes and the slice's d=20, dv=40
DIFF_SHAPES = [(1, 2, 64, 64, 4, 8), (1, 1, 100, 49, 8, 16), (2, 2, 196, 196, 4, 8), (1, 1, 100, 100, 20, 40)]
ATTN_SHAPES = [(1, 2, 64, 64, 16, 16), (1, 1, 100, 49, 8, 24), (2, 2, 196, 196, 20, 40), (1, 1, 70, 70, 64, 64)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,h,n,m,d,dv", DIFF_SHAPES)
def test_diff_backward_twin_matches_pallas(b, h, n, m, d, dv):
    rng = np.random.default_rng(n + d)
    q, k = _rand(rng, b, 2 * h, n, d), _rand(rng, b, 2 * h, m, d)
    v, g = _rand(rng, b, h, m, dv), _rand(rng, b, h, n, dv)
    lam = np.float32(0.45)
    _, l1, l2 = _diff_fwd_pair_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lam),
                                    interpret=True, with_lse=True)
    want = _diff_bwd_pair_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lam), l1, l2,
                               jnp.asarray(g), interpret=True)
    _, lse1, lse2 = K.diff_attention_interleaved_fwd_plain(_t(q), _t(k), _t(v), torch.tensor(lam))
    got = K.diff_attention_interleaved_bwd(_t(q), _t(k), _t(v), torch.tensor(lam), lse1, lse2, _t(g))
    for name, a, w in zip(["dq", "dk", "dv", "dlam"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-4, rtol=3e-4, err_msg=name)


@pytest.mark.parametrize("b,h,n,m,d,dv", ATTN_SHAPES)
def test_attention_backward_twin_matches_pallas(b, h, n, m, d, dv):
    rng = np.random.default_rng(n + d + 1)
    q, k, v, g = _rand(rng, b, h, n, d), _rand(rng, b, h, m, d), _rand(rng, b, h, m, dv), _rand(rng, b, h, n, dv)
    o, lse = _pallas_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                                        with_lse=True)
    want = _pallas_attention_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(g),
                                      interpret=True)
    o_t, lse_t = K.attention_fwd_plain(_t(q), _t(k), _t(v))
    got = K.attention_bwd(_t(q), _t(k), _t(v), o_t, lse_t, _t(g))
    for name, a, w in zip(["dq", "dk", "dv"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4, err_msg=name)


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def test_diff_function_gradients_match_autograd_of_plain_forward():
    rng = np.random.default_rng(7)
    b, h, n, m, d = 2, 2, 90, 70, 8
    arrays = [_rand(rng, b, 2 * h, n, d) * d**-0.5, _rand(rng, b, 2 * h, m, d), _rand(rng, b, h, m, 2 * d),
              np.float32(0.3)]
    do = torch.from_numpy(_rand(rng, b, h, n, 2 * d))
    grads = []
    for fn in (K.DiffAttentionInterleavedFn.apply,
               lambda q, k, v, lam: router.diff_attention_core(q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2],
                                                               v, lam)):
        q, k, v, lam = _leaves(*arrays[:3], np.asarray(arrays[3]))
        grads.append(torch.autograd.grad(fn(q, k, v, lam), (q, k, v, lam), do))
    for name, a, w in zip(["dq", "dk", "dv", "dlam"], *grads):
        assert a.shape == w.shape, name
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5, msg=name)


def test_attention_function_gradients_match_autograd_of_plain_forward():
    rng = np.random.default_rng(8)
    arrays = [_rand(rng, 2, 1, 80, 16) * 0.25, _rand(rng, 2, 1, 60, 16), _rand(rng, 2, 1, 60, 24)]
    do = torch.from_numpy(_rand(rng, 2, 1, 80, 24))
    grads = []
    for fn in (K.AttentionFn.apply, router.plain_attention):
        q, k, v = _leaves(*arrays)
        grads.append(torch.autograd.grad(fn(q, k, v), (q, k, v), do))
    for name, a, w in zip(["dq", "dk", "dv"], *grads):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5, msg=name)


def test_router_takes_the_functions_only_when_autograd_records(monkeypatch):
    """With the kernel path forced on CPU tensors: inputs that need grads reach the
    autograd Functions; under ``inference_mode`` and ``no_grad`` the forward
    kernels run alone, and nothing is saved for a backward."""
    monkeypatch.setattr(router, "_use_kernel", lambda q, n: True)
    calls = []
    for cls in (K.DiffAttentionInterleavedFn, K.AttentionFn):
        monkeypatch.setattr(cls, "apply", (lambda orig, name: lambda *a: calls.append(name) or orig(*a))(
            cls.apply, cls.__name__))
    rng = np.random.default_rng(9)
    q, k = _leaves(_rand(rng, 1, 4, 30, 8), _rand(rng, 1, 4, 30, 8))
    v = torch.from_numpy(_rand(rng, 1, 2, 30, 16))
    lam = torch.tensor(0.2)

    out = router.diff_attention_interleaved(q, k, v, lam)
    out2 = router.flash_attention_core(q, k, k)
    assert calls == ["DiffAttentionInterleavedFn", "AttentionFn"]
    assert type(out.grad_fn).__name__ == "DiffAttentionInterleavedFnBackward"
    assert type(out2.grad_fn).__name__ == "AttentionFnBackward"

    calls.clear()
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            a = router.diff_attention_interleaved(q, k, v, lam)
            b = router.flash_attention_core(q, k, k)
        assert calls == [] and a.grad_fn is None and b.grad_fn is None
        torch.testing.assert_close(a, out.detach())
        torch.testing.assert_close(b, out2.detach())
